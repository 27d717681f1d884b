"""Dense SIFT in the port against the JAX package (tests/test_dense_sift.py):
the pair policy, the k-NN and bbox-voxel filters, the per-pair
triangulation, the triangulate-and-filter step fed the JAX package's own
matches, the whole reconstruct on the rendered scene at the JAX test's
gates, and create_combined_dense_cloud."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import recon3d_tpu.features.frontend as jax_frontend
import recon3d_tpu.runtime.native as jax_native
from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import DenseSiftConfig as JaxDenseSiftConfig
from recon3d_tpu.dense import filters as jax_filters
from recon3d_tpu.dense import sift_dense as jax_sd
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import DenseSiftConfig, PlaneSweepConfig
from recon3d_tpu_torch.dense import filters, sift_dense
from recon3d_tpu_torch.dense.plane_sweep import (
    PlaneSweepReconstructor,
    create_combined_dense_cloud,
)
from tests.render import render_views
from tests.torch_scene import surface_gate

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_dense_sift.py::test_dense_sift_reconstruction."""
    scene = render_views(n_views=4, image_size=(128, 160), arc_step=0.15)
    scene["poses"] = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(4)}
    return scene


def test_dense_pairs_match_jax():
    for n, w in ((10, 2), (50, 8), (4, 8), (16, 8), (2, 1), (1, 3)):
        assert sift_dense.dense_pairs(n, w) == jax_sd.dense_pairs(n, w)
    assert len(sift_dense.dense_pairs(50, 8)) == 400
    assert len(sift_dense.dense_pairs(16, 8)) == 120


def _cloud(seed: int = 11):
    """A float32 cloud on two planes with scattered outliers."""
    rng = np.random.default_rng(seed)
    a = np.c_[rng.uniform(-1, 1, (3000, 2)), rng.normal(0, 0.005, 3000)]
    b = np.c_[rng.uniform(-1, 1, 2000), rng.normal(0.5, 0.005, 2000), rng.uniform(0, 1, 2000)]
    out = rng.uniform(-3, 3, (150, 3))
    pts = np.concatenate([a, b, out]).astype(np.float32)
    return pts, rng.integers(0, 256, (len(pts), 3)).astype(np.uint8)


# The JAX filter's scipy path takes the exact k-NN (cKDTree), which the
# port does not: a point can change sides only where the ring rule's mean
# distance and the exact one straddle their thresholds. On this cloud none
# does (0 of 5,150 points differ, for both (k, factor) pairs); the bound
# below, 0.1% of the cloud, is what the test allows. Its voxel dedup hashes
# the cells and keeps one point a hash, so colliding cells merge: it keeps
# a subset of the port's points (15 fewer of 5,077 at 1,200 divisions, 16
# of 229 at 30).
SCIPY_PATH_DIFFER = 0.001


def _rows(points, colors):
    return {tuple(r) for r in np.c_[points, colors]}


@pytest.mark.parametrize("path", ["native", "native_second_cloud", "scipy"])
def test_filters_keep_the_jax_points(path, monkeypatch):
    """The same float32 cloud gives the same kept points and colours, in
    order, through the port's filters (K2's plain version and the voxel
    dedup on the CPU) and the JAX filters' native path, on two seeded
    clouds; against the JAX scipy path (cKDTree and the hashed voxel
    dedup) the points kept differ by at most SCIPY_PATH_DIFFER."""
    if path == "scipy":
        monkeypatch.setattr(jax_native, "native_knn_mean_dist", lambda *a: None)
        monkeypatch.setattr(jax_native, "native_voxel_downsample", lambda *a: None)
    pts, cols = _cloud(12 if path == "native_second_cloud" else 11)
    for k, f in ((20, 2.5), (8, 1.0)):
        kj, cj = jax_filters.knn_statistical_filter(pts, cols, k=k, std_factor=f)
        kt, ct = filters.knn_statistical_filter(pts, cols, k=k, std_factor=f, device="cpu")
        assert 0 < len(kt) < len(pts)
        if path == "scipy":
            assert len(_rows(kt, ct) ^ _rows(kj, cj)) <= SCIPY_PATH_DIFFER * len(pts)
            continue
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(ct, cj)
    for div in (1200, 30):
        vj, wj = jax_filters.bbox_voxel_downsample(pts, cols, divisions=div)
        vt, wt = filters.bbox_voxel_downsample(pts, cols, divisions=div, device="cpu")
        if path == "scipy":
            assert _rows(vj, wj) < _rows(vt, wt)
            continue
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(wt, wj)
    assert len(filters.bbox_voxel_downsample(pts, cols, divisions=30, device="cpu")[0]) < len(pts)
    small = pts[:10]
    assert filters.knn_statistical_filter(small, None, k=20)[0] is small
    # a tensor stays on its device and keeps its kind
    kt, ct = filters.knn_statistical_filter(torch.from_numpy(pts), cols)
    np.testing.assert_array_equal(kt.numpy(), filters.knn_statistical_filter(
        pts, cols, device="cpu")[0])


def test_triangulate_pair_matches_jax(scene):
    """_triangulate_pair_xy of the port and the JAX one on the same noisy
    true correspondences of two views: the same gate, points to 1e-4
    relative, the same colours."""
    rng = np.random.default_rng(5)
    K = np.asarray(scene["K"], np.float32)
    R1, t1, R2, t2 = (np.asarray(a, np.float32) for a in
                      (scene["Rs"][0], scene["ts"][0], scene["Rs"][2], scene["ts"][2]))
    H, W = scene["depth"][0].shape
    v, u = rng.integers(0, H, 512), rng.integers(0, W, 512)
    d = scene["depth"][0][v, u]
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones(512)], -1)
    X = (rays * d[:, None] - t1) @ R1
    x2h = (X @ R2.T + t2) @ K.T
    x1 = np.float32(np.stack([u, v], -1) + rng.normal(0, 0.5, (512, 2)))
    x2 = np.float32(x2h[:, :2] / x2h[:, 2:3] + rng.normal(0, 0.5, (512, 2)))
    x2[:40] += np.float32(rng.uniform(-40, 40, (40, 2)))   # outliers to gate
    mask = np.ones(512, bool)
    mask[-30:] = False
    img = np.float32(scene["images"][0])
    Xj, cj = jax_sd._triangulate_pair_xy(
        *(jnp.asarray(a) for a in (K, R1, t1, R2, t2, x1, x2, mask, img)),
        max_reproj_px=6.0, min_parallax_deg=0.3)
    Xj, cj = np.asarray(Xj), np.asarray(cj)
    Xt = sift_dense._triangulate_pair_xy(
        *(torch.from_numpy(a) for a in (K, R1, t1, R2, t2, x1, x2, mask)),
        max_reproj_px=6.0, min_parallax_deg=0.3).numpy()
    okj, okt = np.isfinite(Xj[:, 0]), np.isfinite(Xt[:, 0])
    np.testing.assert_array_equal(okt, okj)
    assert 300 < okt.sum() < 482
    # 1e-4 of each point's distance from the origin (the scene's centre):
    # float32 DLT null vectors differ by solver, so a coordinate near 0 has
    # no relative accuracy of its own
    err = np.linalg.norm(Xt[okt] - Xj[okj], axis=1) / np.linalg.norm(Xj[okj], axis=1)
    assert err.max() < 1e-4, err.max()
    np.testing.assert_array_equal(sift_dense._keypoint_colors(img, x1), cj)


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX DenseSiftReconstructor on the scene, with its keypoints and
    its match_pairs_batched results recorded."""
    rec = jax_sd.DenseSiftReconstructor(JaxCamera.from_matrix(scene["K"]),
                                        JaxDenseSiftConfig(max_features=2048))
    seen = {}
    extract, match = rec._extractor.extract_batch, jax_frontend.match_pairs_batched

    def extract_spy(*a, **k):
        seen["feats"] = extract(*a, **k)
        return seen["feats"]

    def match_spy(*a, **k):
        seen["results"] = match(*a, **k)
        return seen["results"]

    rec._extractor.extract_batch = extract_spy
    jax_frontend.match_pairs_batched = match_spy
    try:
        points, colors = rec.reconstruct(scene["images"], scene["poses"])
    finally:
        jax_frontend.match_pairs_batched = match
    return points, colors, np.asarray(seen["feats"].xy), seen["results"]


def test_jax_matches_through_the_port_give_the_jax_cloud(scene, jax_run):
    points_j, colors_j, xy_all, results = jax_run
    rec = sift_dense.DenseSiftReconstructor(Camera.from_matrix(scene["K"]),
                                            DenseSiftConfig(max_features=2048), device="cpu")
    points, colors = rec.triangulate_and_filter(
        results, sorted(scene["poses"]), xy_all, scene["images"], scene["poses"])
    assert len(points_j) > 200
    assert abs(len(points) - len(points_j)) <= 0.005 * len(points_j), (len(points), len(points_j))
    diag = np.linalg.norm(points_j.max(0) - points_j.min(0))
    nn = cKDTree(points_j).query(points)[0]
    assert np.median(nn) < 1e-4 * diag, (np.median(nn), diag)
    assert points.dtype == np.float32 and colors.dtype == np.uint8
    assert colors.shape == points.shape
    assert rec.stats["triangulated_pairs"] == sum(r[5] >= 8 for r in results)


def test_reconstruct_passes_the_jax_gates(scene):
    """tests/test_dense_sift.py::test_dense_sift_reconstruction on the port:
    more than 200 points, median distance to the true surfaces under 0.05."""
    rec = sift_dense.DenseSiftReconstructor(
        Camera.from_matrix(scene["K"]),
        DenseSiftConfig(max_features=2048, min_parallax_deg=0.3), device="cpu")
    points, colors = rec.reconstruct(scene["images"], scene["poses"])
    assert len(points) > 200, f"too few dense points: {len(points)}"
    assert colors.shape == points.shape and colors.dtype == np.uint8
    med, _ = surface_gate(points)
    assert med < 0.05, f"median surf dist {med:.3f}"
    st = rec.stats
    assert st["pairs"] == 6 and st["capacity"] == 256 and st["pair_chunk"] == 64
    assert st["knn_path"] == "plain" and st["knn_launches"] == 0
    assert st["triangulated_points"] >= len(points)
    for k in ("extract_s", "match_s", "triangulate_s", "filter_s", "total_s"):
        assert st[k] >= 0.0
    assert rec.reconstruct(scene["images"], {0: scene["poses"][0]})[0].shape == (0, 3)


def test_reconstructor_refuses_cuda_without_a_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        sift_dense.DenseSiftReconstructor(Camera.from_matrix(scene["K"]))


def test_pair_chunk_is_the_jax_chunk_on_the_cpu():
    assert sift_dense.pair_chunk(65536, 1024, "cpu") == 64


def test_create_combined_dense_cloud_is_the_sweep(scene):
    cam = Camera.from_matrix(scene["K"])
    cfg = PlaneSweepConfig()
    p_sweep, c_sweep = PlaneSweepReconstructor(cam, cfg, device="cpu").reconstruct(
        scene["images"], scene["poses"])
    p, c = create_combined_dense_cloud(cam, scene["images"], scene["poses"], device="cpu")
    assert len(p) > 100
    np.testing.assert_array_equal(p, p_sweep)
    np.testing.assert_array_equal(c, c_sweep)
    p0, c0 = create_combined_dense_cloud(cam, scene["images"], scene["poses"],
                                         use_stereo=False, device="cpu")
    assert p0.shape == (0, 3) and c0.shape == (0, 3) and c0.dtype == np.uint8
