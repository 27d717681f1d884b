"""The port's point-cloud runtime against the JAX package's native one
(recon3d_tpu/runtime/native.py over the committed native/librecon3d_native.so,
run as tests/test_tsdf_mesh.py and tests/test_ply.py run it): K2's and K3's
plain versions (kernels/pointcloud.py), the voxel dedup on the device, and
the port's own host PLY library (runtime/native.py)."""

import filecmp

import numpy as np
import pytest
import torch

import recon3d_tpu.runtime.native as jax_native
from recon3d_tpu_torch.kernels import pointcloud
from recon3d_tpu_torch.kernels.build import BUILD_DIR
from recon3d_tpu_torch.runtime import native

torch.set_num_threads(2)

# K2 against the JAX native: its build contracts the squared distances'
# products and sums into FMAs (7 vfmadd in its knn_mean_dist), where the
# port rounds each operation; 2.6e-7 relative measured on such clouds.
K2_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The reference: the committed library must load."""
    assert jax_native.native_available(), "native/librecon3d_native.so does not load"


def clustered_cloud(seed: int, n: int = 2500) -> np.ndarray:
    """Six normal clusters of growing spread and 1% uniform outliers."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1, (6, 3))
    parts = [centres[i] + rng.normal(0, 0.05 + 0.05 * i, (n // 6, 3)) for i in range(6)]
    parts.append(rng.uniform(-5, 5, (n // 100, 3)))
    return np.concatenate(parts).astype(np.float32)


def assert_k2_matches(pts: np.ndarray, k: int) -> np.ndarray:
    ref = jax_native.native_knn_mean_dist(pts, k)
    got = native.native_knn_mean_dist(pts, k, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=K2_RTOL, atol=0)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [8, 20])
def test_knn_mean_dist_matches_jax_native(seed, k):
    pts = clustered_cloud(seed)
    got = assert_k2_matches(pts, k)
    assert (got > 0).all()
    grid = pointcloud.cell_grid(torch.from_numpy(pts), k)
    assert int(grid.ring.min()) >= 2 and int(grid.ring.max()) > 2   # outliers walk rings


def _no_ring_reaches_k():
    """A uniform block and three lone points far off: the lone points share
    a cell whose cube holds fewer than k others at every ring, so R is 9
    and kk is 2."""
    rng = np.random.default_rng(3)
    block = rng.uniform(0, 10, (3000, 3))
    lone = np.array([[40.0, 40.0, 40.0], [39.5, 40.0, 40.0], [40.0, 39.0, 40.0]])
    return np.concatenate([block, lone]).astype(np.float32)


@pytest.mark.parametrize("case", ["n_le_k", "no_ring_reaches_k", "one_cell", "duplicates"])
def test_knn_mean_dist_edge_cases(case):
    k = 20
    if case == "n_le_k":
        for n in (1, k - 1, k):
            pts = clustered_cloud(4)[:n]
            np.testing.assert_array_equal(native.native_knn_mean_dist(pts, k, device="cpu"),
                                          np.zeros(n, np.float32))
            np.testing.assert_array_equal(jax_native.native_knn_mean_dist(pts, k),
                                          np.zeros(n, np.float32))
        return
    if case == "no_ring_reaches_k":
        pts = _no_ring_reaches_k()
        grid = pointcloud.cell_grid(torch.from_numpy(pts), k)
        lonely = (grid.ring == pointcloud.RING_MAX) & (grid.cube - 1 < k)
        assert int(lonely.sum()) >= 1
    elif case == "one_cell":
        # a tight ball and two far points: the bounding box makes the cell
        # so large that the ball shares one cell
        rng = np.random.default_rng(5)
        pts = np.concatenate([rng.normal(100, 1e-3, (300, 3)),
                              [[-1000.0, -1000.0, -1000.0], [1000.0, 1000.0, 1000.0]]])
        pts = pts.astype(np.float32)
        grid = pointcloud.cell_grid(torch.from_numpy(pts), k)
        assert int(grid.count.max()) == 300
    else:
        base = clustered_cloud(6, 600)
        pts = np.concatenate([base, base[:200], base[:50]]).astype(np.float32)
    assert_k2_matches(pts, k)


def test_knn_mean_dist_large_k_matches_jax_native():
    """k beyond K2's register list (on the card a row of scratch a point):
    the plain version takes any k, as the JAX native does."""
    k = pointcloud.KNN_REGISTER_K + 9
    got = assert_k2_matches(clustered_cloud(12, 1800), k)
    assert (got > 0).all()


def test_knn_mean_dist_identical_points():
    """Every point the same: all in one cell, every distance 0."""
    pts = np.full((64, 3), 0.25, np.float32)
    got = assert_k2_matches(pts, 8)
    np.testing.assert_array_equal(got, np.zeros(64, np.float32))


def test_knn_rows_and_outliers_far_away():
    """The plain version on a subset of rows equals its whole result there,
    and outliers 1e7 away give keys far from overflow (the 1e-6 diagonal
    floor bounds the cells an axis)."""
    pts = clustered_cloud(7)
    pts[:3] = [[1e7, -1e7, 3e6], [-2e7, 5e6, 1e7], [4e6, 2e7, -1e7]]
    whole = pointcloud.knn_mean_dist_reference(torch.from_numpy(pts), 20)
    rows = torch.tensor([0, 5, 2400, 17, 1], dtype=torch.int64)
    np.testing.assert_array_equal(
        pointcloud.knn_mean_dist_reference(torch.from_numpy(pts), 20, rows=rows).numpy(),
        whole[rows].numpy())
    np.testing.assert_allclose(whole.numpy(), jax_native.native_knn_mean_dist(pts, 20),
                               rtol=K2_RTOL, atol=0)


def _d2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances with each operation rounded in float32."""
    d = (a - b).astype(np.float32)
    return ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]).astype(np.float32)


@pytest.mark.parametrize("branch,n_ref", [("brute", 200), ("grid", 3000)])
def test_nearest_index_matches_jax_native(branch, n_ref):
    """The JAX function's brute-force branch (n <= 256) and its grid branch:
    the port's choice lies exactly as near as the JAX one, and is the same
    index except at exact ties (duplicated reference points make some)."""
    rng = np.random.default_rng(7)
    ref = rng.normal(size=(n_ref, 3)).astype(np.float32)
    ref[n_ref // 2:n_ref // 2 + 20] = ref[:20]
    q = np.concatenate([rng.normal(size=(500, 3)) * 1.5, ref[:20] + 1e-3]).astype(np.float32)
    got = native.native_nearest_index(q, ref, device="cpu")
    want = jax_native.native_nearest_index(q, ref)
    assert got.dtype == np.int64 and got.shape == want.shape
    d_got, d_want = _d2(q, ref[got]), _d2(q, ref[want])
    np.testing.assert_array_equal(d_got, d_want)
    brute = np.stack([_d2(np.repeat(q[i:i + 1], n_ref, 0), ref) for i in range(len(q))])
    np.testing.assert_array_equal(got, brute.argmin(1))   # the lowest index of the minimum
    differ = got != want
    tied = np.array([(brute[i] == d_got[i]).sum() > 1 for i in range(len(q))])
    assert not (differ & ~tied).any()
    assert tied.sum() >= 20


def test_nearest_grid_table():
    """K3's glue on the CPU: the native search's cell size (at least diag /
    256, so at most 258 cells an axis), every reference point in the run of
    its cell floor(p * inv) - origin, the original indices a permutation,
    and the queries with the order the kernel takes them in."""
    rng = np.random.default_rng(13)
    ref = np.concatenate([rng.normal(size=(3000, 3)), [[40.0, -40.0, 9.0]]]).astype(np.float32)
    prep = pointcloud.nearest_prepare(torch.from_numpy(ref), torch.from_numpy(ref[:5]))
    sx, sy, sz = prep.span
    assert max(prep.span) <= 258 and len(prep.cell_first) == sx * sy * sz + 1
    ids = prep.ref_id.long()
    assert torch.equal(torch.sort(ids).values, torch.arange(len(ref)))
    np.testing.assert_array_equal(prep.ref4[:, :3].numpy(), ref[ids.numpy()])
    cells = np.floor(ref[ids.numpy()].astype(np.float64) * float(prep.inv)) - prep.origin
    lin = (cells[:, 0] * sy + cells[:, 1]) * sz + cells[:, 2]
    first = prep.cell_first.numpy()
    pos = np.arange(len(ref))
    assert ((first[lin.astype(np.int64)] <= pos) & (pos < first[lin.astype(np.int64) + 1])).all()
    assert (np.diff(first) >= 0).all() and first[-1] == len(ref)
    # the queries in the callers' order, query_id the order the kernel
    # takes them in; the reference points' original indices also in their
    # w bits
    np.testing.assert_array_equal(prep.query.numpy(), ref[:5])
    assert sorted(prep.query_id.tolist()) == list(range(5))
    np.testing.assert_array_equal(prep.ref4[:, 3].view(torch.int32).numpy(), ids.numpy())


def test_mesh_vertex_colors_through_k3():
    from recon3d_tpu_torch.dense.mesh import mesh_vertex_colors

    rng = np.random.default_rng(8)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (700, 3)).astype(np.uint8)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    before = pointcloud.snapshot()
    out = mesh_vertex_colors(verts, pts, cols, device="cpu")
    np.testing.assert_array_equal(out, cols[jax_native.native_nearest_index(verts, pts)])
    assert pointcloud.since(before)["nearest_index"] == {"kernel": 0, "plain": 1}
    assert mesh_vertex_colors(verts, pts[:0], cols[:0], device="cpu").shape == (300, 3)


@pytest.mark.parametrize("voxel", [0.02, 0.1537, 1.0])
def test_voxel_first_indices_match_jax_native(voxel):
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(0, 0.5, (4000, 3)), rng.uniform(-3, 3, (100, 3))])
    pts = pts.astype(np.float32)
    got = native.native_voxel_downsample(pts, voxel, device="cpu")
    np.testing.assert_array_equal(got, jax_native.native_voxel_downsample(pts, voxel))
    assert 0 < len(got) < len(pts)


def test_ply_rows_match_jax_native(tmp_path):
    """The port's host library writes the JAX library's bytes and parses
    the same numbers, nan and inf tokens included."""
    rng = np.random.default_rng(10)
    pts = (rng.normal(size=(1000, 3)) * 50).astype(np.float32)
    pts[3] = [np.nan, np.inf, -np.inf]
    cols = rng.integers(0, 256, (1000, 3)).astype(np.uint8)
    paths = {name: str(tmp_path / f"{name}.txt") for name in ("port", "jax")}
    for path in paths.values():
        open(path, "w").close()
    assert native.native_ply_write_ascii(paths["port"], pts, cols)
    assert jax_native.native_ply_write_ascii(paths["jax"], pts, cols)
    assert filecmp.cmp(paths["port"], paths["jax"], shallow=False)
    got = native.native_ply_parse_ascii(paths["port"], 0, 1000, 6)
    want = jax_native.native_ply_parse_ascii(paths["jax"], 0, 1000, 6)
    np.testing.assert_array_equal(got, want)
    assert native.native_ply_parse_ascii(paths["port"], 0, 1001, 6) is None


def test_host_library_is_built_into_the_port(tmp_path):
    """native_available reports the port's own build, which lives in
    recon3d_tpu_torch/_build and is named by its source's hash."""
    assert native.native_available()
    path, _, _ = native.build()
    assert path.parent == BUILD_DIR and path.name.startswith("libpointcloud_host_")
    with pytest.raises(OSError):
        native.native_ply_write_ascii(str(tmp_path / "no" / "such.ply"),
                                      np.zeros((1, 3), np.float32), np.zeros((1, 3), np.uint8))


def test_wrappers_check_inputs_and_count():
    pts = torch.from_numpy(clustered_cloud(11, 300))
    before = pointcloud.snapshot()
    pointcloud.knn_mean_dist(pts, 8)
    pointcloud.nearest_index(pts, pts[:10])
    assert pointcloud.since(before) == {"knn_mean_dist": {"kernel": 0, "plain": 1},
                                        "nearest_index": {"kernel": 0, "plain": 1}}
    before = pointcloud.snapshot()   # n <= k: zeros, and neither route runs
    assert torch.equal(pointcloud.knn_mean_dist(pts[:8], 8), torch.zeros(8))
    assert pointcloud.since(before)["knn_mean_dist"] == {"kernel": 0, "plain": 0}
    with pytest.raises(ValueError, match="k must be"):
        pointcloud.knn_mean_dist(pts, 0)
    with pytest.raises(ValueError, match="float32"):
        pointcloud.knn_mean_dist(pts.double(), 8)
    with pytest.raises(ValueError, match="finite"):
        pointcloud.knn_mean_dist(torch.full((30, 3), float("nan")), 8)
    with pytest.raises(ValueError, match="no reference"):
        pointcloud.nearest_index(pts[:0], pts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            native.native_knn_mean_dist(pts.numpy(), 8)
