"""K2 and K3 on the card against their plain PyTorch versions.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips without a GPU. The file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_pointcloud_cuda.py

Both kernels round every operation as the plain versions do, so they are
held bit for bit (K2) and index for index (K3).
"""

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.dense import filters
from recon3d_tpu_torch.kernels import pointcloud

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K2 and K3 are CUDA kernels with no CPU mode)")
    return torch.device("cuda")


def clustered_cloud(seed: int, n: int) -> np.ndarray:
    """Six normal clusters of growing spread and 1% uniform outliers."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1, (6, 3))
    parts = [centres[i] + rng.normal(0, 0.05 + 0.05 * i, (n // 6, 3)) for i in range(6)]
    parts.append(rng.uniform(-5, 5, (n // 100, 3)))
    return np.concatenate(parts).astype(np.float32)


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
    return cases


@pytest.mark.parametrize("case", sorted(_nearest_cases()))
def test_nearest_index_kernel_equals_plain(cuda_device, case):
    ref, query = _nearest_cases()[case]
    r, q = (torch.from_numpy(a).to(cuda_device) for a in (ref, query))
    before = pointcloud.snapshot()
    got = pointcloud.nearest_index(r, q)
    torch.cuda.synchronize()
    assert pointcloud.since(before)["nearest_index"] == {"kernel": 1, "plain": 0}
    assert torch.equal(got, pointcloud.nearest_index_reference(r, q))


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
