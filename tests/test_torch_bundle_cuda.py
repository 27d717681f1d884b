"""Bundle adjustment's LM step on the card: the kernels of csrc/bundle.cu
against the plain version (sfm/bundle.py::_lm_step_plain) on the same
table on the card, at DTU's size.

The problem (tests/torch_bundle_check.py) has 49 cameras on an arc,
10,000 points seen by 5 cameras each (50,000 observations, some of them
outliers for the Huber weights), in a log padded to the capacity the
pipeline gives DTU (262,144 rows). The two paths sum the same products in
other orders. The plain version takes a point's sums as differences of
float32 prefix sums over all 50,000 rows, which at this size moves its
point step 4.2e-2 (relative norm) from the same step in float64, where
the kernels' lies ~3e-5 from it. So the step is held to the plain version
run in float64 on the card, at the bounds of
tests/test_torch_bundle.py::test_lm_step_matches_jax, and the costs to the
float32 plain version as well. The kernels use no atomics: two runs, and
two capacities around the same live rows, give the same bits.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_bundle_cuda.py
"""

import sys
import types
from pathlib import Path

import pytest
import torch

# An installed package named `tests` would win over this directory, which
# holds no __init__.py: bind the name to it first.
_HERE = str(Path(__file__).resolve().parent)
if _HERE not in [str(Path(p).resolve()) for p in getattr(sys.modules.get("tests"), "__path__", [])]:
    sys.modules["tests"] = types.ModuleType("tests")
    sys.modules["tests"].__path__ = [_HERE]

from recon3d_tpu_torch.kernels import bundle as bundle_kernels  # noqa: E402
from recon3d_tpu_torch.runtime.profiling import span  # noqa: E402
from recon3d_tpu_torch.sfm import bundle  # noqa: E402
from tests.torch_bundle_check import (  # noqa: E402
    CG_ITERS, DAMPING, DELTA, dtu_table, float64, rel)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bundle kernels are CUDA kernels with no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle_kernels._library()            # the build, outside any timing or sync check
    return torch.device("cuda")


@pytest.fixture(scope="module")
def table(cuda_device):
    return dtu_table(cuda_device)


def _damping(device):
    return torch.full((), DAMPING, dtype=torch.float32, device=device)


@pytest.mark.parametrize("motion_only", [False, True])
def test_lm_step_matches_the_plain_version(table, motion_only):
    """One LM step on the kernels against the plain version: cost0 to 1e-5
    relative and cost1 to 1e-3 of cost0 (float32 and float64), the step to
    2e-3 of its size (float64) and no farther from it than the float32
    plain version's, the gauge camera's step exactly zero, the points
    frozen under motion_only; and a step that lowers the cost."""
    dev = table.X0.device
    ref, c0_ref, c1_ref = bundle._lm_step_plain(table, _damping(dev), DELTA, CG_ITERS, motion_only)
    exact, c0_64, c1_64 = bundle._lm_step_plain(float64(table), _damping(dev).double(), DELTA,
                                                CG_ITERS, motion_only)
    got, c0, c1 = bundle._lm_step(table, _damping(dev), DELTA, CG_ITERS, motion_only)
    c0, c1 = float(c0), float(c1)
    for want0, want1 in ((float(c0_ref), float(c1_ref)), (float(c0_64), float(c1_64))):
        assert abs(c0 - want0) <= 1e-5 * want0
        assert abs(c1 - want1) <= 1e-3 * want0
    assert c1 < c0
    for g, plain, want in ((got.xi, ref.xi, exact.xi), (got.dX, ref.dX, exact.dX)):
        if float(want.abs().max()) > 0:
            assert rel(g, want) <= 2e-3
            assert rel(g, want) <= max(rel(plain, want), 1e-4)
    assert torch.equal(got.xi[0].cpu(), torch.zeros(6))
    if motion_only:
        assert float(got.dX.abs().max()) == 0.0


def test_kernel_step_is_bit_identical_across_runs_and_capacities(table):
    """Two runs of the kernels' step give the same bits, and a table of the
    same live rows padded to 65,536 rows gives the same bits as 262,144:
    the padding is never read."""
    dev = table.X0.device
    a = bundle._lm_step(table, _damping(dev), DELTA, CG_ITERS)
    b = bundle._lm_step(table, _damping(dev), DELTA, CG_ITERS)
    small = bundle._lm_step(dtu_table(dev, cap=65_536), _damping(dev), DELTA, CG_ITERS)
    for other in (b, small):
        assert torch.equal(a[0].xi, other[0].xi) and torch.equal(a[0].dX, other[0].dX)
        assert torch.equal(a[1], other[1]) and torch.equal(a[2], other[2])


def test_kernel_step_counts_and_launches(table):
    """A step on the card launches the kernels (80 at 24 CG iterations)
    and counts `ba.kernel_steps` once."""
    dev = table.X0.device
    bundle_kernels.counts.reset()
    with span("test.ba") as sp:
        bundle._lm_step(table, _damping(dev), DELTA, CG_ITERS)
    torch.cuda.synchronize()
    assert bundle_kernels.counts.kernel == 3 * CG_ITERS + 8
    assert sp.trace.counters.get("ba.kernel_steps") == 1


def test_lm_steps_read_the_card_once(table, monkeypatch):
    """Under torch.cuda.set_sync_debug_mode("error") an LM step raises
    nothing: the kernels' step reads nothing back, and the LM loop's only
    read is its one `pull` a step (let through here)."""
    dev = table.X0.device
    real_pull = bundle.pull
    reads = []

    def pull(t):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(1)
            return real_pull(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(bundle, "pull", pull)
    damping = _damping(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bundle._lm_step(table, damping, DELTA, CG_ITERS)
        with span("test.ba") as sp:
            *_, iters = bundle._lm_loop(table, 1e-3, DELTA, max_iters=3, cg_iters=CG_ITERS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = sp.trace.counters["ba.lm_steps"]
    assert len(reads) == steps and sp.trace.counters["ba.kernel_steps"] == steps
    assert iters >= 1
