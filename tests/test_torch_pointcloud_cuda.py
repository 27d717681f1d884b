"""K2 and K3 on the card against their plain PyTorch versions.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips without a GPU. The file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_pointcloud_cuda.py

Both kernels round every operation as the plain versions do, so they are
held bit for bit (K2) and index for index (K3), K2 also on the clouds made
to break its skip (tests/torch_clouds.py) and K3 on queries sorted,
shuffled, tied, beyond the grid and in a neighbourhood too large to stage.
"""

import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

# An installed package named `tests` would win over this directory, which
# holds no __init__.py: bind the name to it first.
_HERE = str(Path(__file__).resolve().parent)
if _HERE not in [str(Path(p).resolve()) for p in getattr(sys.modules.get("tests"), "__path__", [])]:
    sys.modules["tests"] = types.ModuleType("tests")
    sys.modules["tests"].__path__ = [_HERE]

from recon3d_tpu_torch.dense import filters  # noqa: E402
from recon3d_tpu_torch.kernels import pointcloud  # noqa: E402
from tests.torch_clouds import adversarial_clouds, clustered_cloud  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K2 and K3 are CUDA kernels with no CPU mode)")
    return torch.device("cuda")


def _clouds():
    rng = np.random.default_rng(3)
    lone = np.concatenate([rng.uniform(0, 10, (3000, 3)),
                           [[40.0, 40.0, 40.0], [39.5, 40.0, 40.0], [40.0, 39.0, 40.0]]])
    base = clustered_cloud(6, 600)
    return {
        "clustered": clustered_cloud(0, 20_000),
        "no_ring_reaches_k": lone.astype(np.float32),
        "one_cell": np.concatenate([rng.normal(100, 1e-3, (700, 3)),
                                    [[-1e3] * 3, [1e3] * 3]]).astype(np.float32),
        "duplicates": np.concatenate([base, base[:200], base[:50]]),
        "identical": np.full((300, 3), 0.25, np.float32),
    }


@pytest.mark.parametrize("case", sorted(_clouds()))
@pytest.mark.parametrize("k", [8, 20, 31, 40])
def test_knn_mean_dist_kernel_equals_plain(cuda_device, case, k):
    pts = torch.from_numpy(_clouds()[case]).to(cuda_device)
    before = pointcloud.snapshot()
    got = pointcloud.knn_mean_dist(pts, k)
    torch.cuda.synchronize()
    assert pointcloud.since(before)["knn_mean_dist"] == {"kernel": 1, "plain": 0}
    want = pointcloud.knn_mean_dist_reference(pts, k)
    assert torch.equal(got, want), (got - want).abs().max()


ADVERSARIAL = adversarial_clouds(scale=4)


@pytest.mark.parametrize("case", sorted(ADVERSARIAL) + ["one_cell"])
@pytest.mark.parametrize("k", [8, 20, 31, 40])
def test_knn_skip_is_exact(cuda_device, case, k):
    """The skip on clouds made to break it (tests/torch_clouds.py), and one
    dense cell whose points share one sub-cell, so that every chunk's box
    is the cell's and nothing can be skipped: bit for bit the plain
    version; the pairs the kernel evaluated at most the ring rule's, all of
    them in the dense cell, fewer on the surface."""
    cloud = ADVERSARIAL[case] if case in ADVERSARIAL else _clouds()[case]
    pts = torch.from_numpy(cloud).to(cuda_device)
    prep = pointcloud.knn_prepare(pts, k)
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = pointcloud.knn_launch(prep, pairs)
    want = pointcloud.knn_mean_dist_reference(pts, k)
    assert torch.equal(got, want), (got - want).abs().max()
    ring = prep.grid.candidate_pairs()
    assert 0 < int(pairs) <= ring
    if case == "one_cell":
        assert int(pairs) == ring
    if case == "surface":
        assert int(pairs) * 2 < ring, (int(pairs), ring)


def test_knn_mean_dist_small_and_wide(cuda_device):
    """n <= k launches nothing; k + 1 beyond the register list (32) takes
    the scratch list and still equals the plain version."""
    pts = torch.from_numpy(clustered_cloud(1, 600)).to(cuda_device)
    before = pointcloud.snapshot()
    assert torch.equal(pointcloud.knn_mean_dist(pts[:20], 20),
                       torch.zeros(20, device=cuda_device))
    assert pointcloud.since(before)["knn_mean_dist"] == {"kernel": 0, "plain": 0}
    assert torch.equal(pointcloud.knn_mean_dist(pts[:21], 20),
                       pointcloud.knn_mean_dist_reference(pts[:21], 20))
    for k in (32, 64, 100):
        assert torch.equal(pointcloud.knn_mean_dist(pts, k),
                           pointcloud.knn_mean_dist_reference(pts, k))


def _nearest_cases():
    """(ref, query) pairs: normal clouds with duplicated points (exact ties)
    and queries far outside the grid, one beyond its NN_FAR cells; a lattice
    whose queries sit at equal distance from 8 points; a flat cloud; an
    outlier that stretches the grid; identical points."""
    cases = {}
    for n, m in [(1, 5), (200, 1000), (4097, 3001), (20_000, 7000)]:
        rng = np.random.default_rng(n)
        ref = rng.normal(size=(n, 3)).astype(np.float32)
        ref[n // 2:n // 2 + min(20, n // 2)] = ref[:min(20, n // 2)]
        query = np.concatenate([rng.normal(size=(m, 3)) * 1.5, ref[:10],
                                [[1e6, 0, 0], [-3e30, 1, 1], [0, 50, -50]]])
        cases[f"normal_{n}"] = (ref, query.astype(np.float32))
    rng = np.random.default_rng(5)
    axis = np.arange(16, dtype=np.float32) * 0.25
    lattice = np.stack(np.meshgrid(axis, axis, axis), -1).reshape(-1, 3)
    cases["lattice"] = (lattice, lattice[:2000] + np.float32(0.125))
    flat = rng.normal(size=(5000, 3)).astype(np.float32)
    flat[:, 2] = 0
    cases["flat"] = (flat, rng.normal(size=(3000, 3)).astype(np.float32))
    spread = np.concatenate([rng.normal(size=(5000, 3)), [[1e4, 1e4, 1e4]]])
    cases["outlier"] = (spread.astype(np.float32), rng.normal(size=(3000, 3)).astype(np.float32))
    cases["identical"] = (np.full((300, 3), 0.5, np.float32),
                          rng.normal(size=(50, 3)).astype(np.float32))
    # the same queries given in the order K3's glue sorts them, and shuffled
    ref = np.concatenate([ADVERSARIAL["surface"], rng.normal(size=(200, 3))]).astype(np.float32)
    query = (ADVERSARIAL["surface"][::3] + rng.normal(0, 0.01, (len(ADVERSARIAL["surface"][::3]), 3))
             ).astype(np.float32)
    prep = pointcloud.nearest_prepare(torch.from_numpy(ref), torch.from_numpy(query))
    cases["surface_sorted"] = (ref, query[prep.query_id.numpy()])
    cases["surface_shuffled"] = (ref, query[rng.permutation(len(query))])
    # thousands of reference points in a few cells: a block's neighbourhood
    # overflows its stage and it walks from shell 0
    dense = np.concatenate([rng.normal(0, 1e-3, (20_000, 3)), rng.uniform(-1, 1, (500, 3))])
    cases["stage_overflow"] = (dense.astype(np.float32),
                               rng.normal(0, 2e-3, (3000, 3)).astype(np.float32))
    return cases


# csrc: NN_STAGE, the reference points a block stages
NN_STAGE = 2048


@pytest.mark.parametrize("case", sorted(_nearest_cases()))
def test_nearest_index_kernel_equals_plain(cuda_device, case):
    ref, query = _nearest_cases()[case]
    r, q = (torch.from_numpy(a).to(cuda_device) for a in (ref, query))
    before = pointcloud.snapshot()
    got = pointcloud.nearest_index(r, q)
    torch.cuda.synchronize()
    assert pointcloud.since(before)["nearest_index"] == {"kernel": 1, "plain": 0}
    assert torch.equal(got, pointcloud.nearest_index_reference(r, q))
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    prep = pointcloud.nearest_prepare(r, q)
    assert torch.equal(pointcloud.nearest_launch(prep, pairs), got)
    assert int(pairs) >= len(query)   # no query stops before it sees a point
    if case == "stage_overflow":   # one cell holds more than a stage
        assert int(prep.cell_first.diff().max()) > NN_STAGE


def test_nearest_index_far_beyond_the_grid(cuda_device):
    """Queries 10^5 cells and more outside a grid whose neighbourhood no
    stage holds (their one block spans the grid, 200,000 uniform points):
    every one walks from its gap, shell by shell, each shell clipped to
    the grid. Index for index the plain version's, in far less
    than the time an unclipped shell (its r^2 columns) would take."""
    rng = np.random.default_rng(11)
    ref = rng.uniform(0, 1, (200_000, 3)).astype(np.float32)
    inside = rng.uniform(0, 1, (40, 2))
    query = np.concatenate([
        np.column_stack([np.full(40, 3000.0), inside]),                 # beyond +x
        np.column_stack([np.full(40, -2500.0), np.full(40, -2500.0),    # beyond a corner
                         inside[:, 0] + 2500.0]),
        np.column_stack([inside[:, 0], np.full(40, 1e4), inside[:, 1]]),   # beyond +y
    ]).astype(np.float32)
    r, q = (torch.from_numpy(a).to(cuda_device) for a in (ref, query))
    pointcloud.nearest_index(r[:100], q[:3])   # the build and first use, not timed
    prep = pointcloud.nearest_prepare(r, q)
    cells = np.floor(np.abs(query).max(1) * float(prep.inv))
    assert cells.min() > 1e5 and cells.max() < 2.0 ** 28   # the walk, not the full scan
    # one block, whose cells (clamped to one beyond the grid) reach from
    # corner to corner: its neighbourhood is every point, no stage holds it
    assert len(query) <= pointcloud.NN_THREADS and len(ref) > NN_STAGE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pointcloud.nearest_index(r, q)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert torch.equal(got, pointcloud.nearest_index_reference(r, q))
    assert seconds < 1.0, seconds


def test_filters_on_the_card_keep_the_cpu_points(cuda_device):
    pts = clustered_cloud(2, 8000)
    cols = np.random.default_rng(2).integers(0, 256, (len(pts), 3)).astype(np.uint8)
    for k, f in ((20, 2.5), (8, 1.0)):
        kc, cc = filters.knn_statistical_filter(pts, cols, k=k, std_factor=f, device="cpu")
        kg, cg = filters.knn_statistical_filter(pts, cols, k=k, std_factor=f, device="cuda")
        np.testing.assert_array_equal(kg, kc)
        np.testing.assert_array_equal(cg, cc)
    t = torch.from_numpy(pts).to(cuda_device)
    vt, wt = filters.bbox_voxel_downsample(t, cols)
    vc, wc = filters.bbox_voxel_downsample(pts, cols, device="cpu")
    assert vt.is_cuda
    np.testing.assert_array_equal(vt.cpu().numpy(), vc)
    np.testing.assert_array_equal(wt, wc)
