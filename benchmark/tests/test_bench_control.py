"""The control comes out not correct where the program is correct: the
reference's own answer computed in bfloat16 (each job's `control`: for the
dense cells the true depth maps, the confidence at them and the fusion,
for SfM the true cameras, surface points and their projections) put in the
program's place and judged by the cell's limits (the dense cells are out
of BENCHMARK.json, test_bench_faults.py). On the card where there
is one, else on the CPU, at the sizes of `_tiny.SIZES`; the readings at
the cells' own sizes are made with benchmark/readings.py (PERF.md)."""

import pytest
import torch

from benchmark import readings
from benchmark.tests import _tiny

SEEDS = (2**31 + 1, 2**31 + 2)


def _fails(limit: dict, value: float) -> bool:
    return value > limit["max"] if "max" in limit else value < limit["min"]


@pytest.mark.parametrize("workload", ["dtu49.sfm"])
def test_bf16_control_is_not_correct(workload):
    device = "cuda" if torch.cuda.is_available() else "cpu"
    torch.set_num_threads(2)
    files = _tiny.files(workload)
    limits = files["cell"]["limits"]["numbers"]
    recs = {(r["seed"], r["variant"]): r
            for r in readings.readings(workload, SEEDS, ["clean", "bf16"], device, files)}
    for seed in SEEDS:
        clean, ctrl = recs[seed, "clean"], recs[seed, "bf16"]
        assert not any(_fails(lim, clean["numbers"][k]) for k, lim in limits.items()), clean
        assert any(_fails(lim, ctrl["numbers"][k]) for k, lim in limits.items()), ctrl
