"""A run with the timed path broken underneath comes out not correct: the
harness without its look for a card, once for each fault that the cell
can have (a step that returns its state unchanged; half of a batch left
out; an answer altered where it is produced). One chip, so no exchange
between chips can be left out. The same run unbroken is correct, so each
fault is what fails it.

Half a batch and an altered answer are caught on a small scene on the
CPU. A bundle adjustment that returns its state unchanged is caught at
the cell's own size, on the card: on scenes a CPU test can hold the
cameras drift too little without it (the 90th percentile of the
reprojection error reads 1.33-1.39 px at `_tiny.SIZES`, under the cell's
limit of 2.0; 2.73-3.16 px at the cell's size, PERF.md)."""

import pytest
import torch

from benchmark import controls
from benchmark.tests._tiny import run_tiny

# The benchmark's cells by job. The dense cells are out of BENCHMARK.json:
# PatchMatch fails their check against the true depth at every size tried
# (PERF.md), so an unbroken dense run is not correct either.
CELLS = {"sfm": "dtu49.sfm"}
AT_CELL_SIZE = {("sfm", "state_unchanged")}


@pytest.mark.parametrize("job", sorted(CELLS))
def test_unbroken_run_is_correct(job):
    res = run_tiny(CELLS[job])
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("job,fault", [(j, f) for j in sorted(CELLS) for f in controls.FAULTS[j]
                                       if (j, f) not in AT_CELL_SIZE])
def test_fault_is_not_correct(job, fault):
    with controls.FAULTS[job][fault]():
        res = run_tiny(CELLS[job])
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("job,fault", sorted(AT_CELL_SIZE))
def test_fault_is_not_correct_at_the_cell_size(job, fault):
    if not torch.cuda.is_available():
        pytest.skip("the cell's own size needs the card: a CPU run of it takes many minutes")
    import time

    from benchmark import run

    with controls.FAULTS[job][fault]():
        res = run.run_cell(CELLS[job], 2**31 + 21, 0.1, False, "cuda",
                           t_start=time.perf_counter())
    assert res["correct"] is False, res["checks"]
