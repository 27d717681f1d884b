"""TSDF fusion and marching-tetrahedra meshes of the port
(recon3d_tpu_torch/dense/{tsdf,mesh}.py, io/ply.py's mesh functions) against
the JAX package's on the CPU, on the ground-truth geometry of
tests/test_tsdf_mesh.py: ray-traced sphere depth maps and the box-corner
renderer's exact depth maps.

On the CPU the port's per-view lookup runs K1's plain version at snapped
coordinates, the nearest-pixel read the JAX CPU path makes too."""

import numpy as np
import pytest
import torch

from recon3d_tpu.dense import mesh as jmesh
from recon3d_tpu.dense import tsdf as jtsdf
from recon3d_tpu.io import ply as jply
from recon3d_tpu_torch.dense import mesh as tmesh
from recon3d_tpu_torch.dense import tsdf as ttsdf
from recon3d_tpu_torch.io import ply as tply
from recon3d_tpu_torch.kernels import warp
from tests.render import render_views
from tests.test_tsdf_mesh import _sphere_depth_maps, _sphere_volume

torch.set_num_threads(2)


def _fuse_both(depths, confs, K, Rs, ts, **kw):
    vj = jtsdf.fuse_tsdf(depths, confs, K, Rs, ts, **kw)
    warp.counts.reset()
    vt = ttsdf.fuse_tsdf(depths, confs, K, Rs, ts, device="cpu", **kw)
    assert warp.counts.plain == len(depths) and warp.counts.kernel == 0  # one call a view
    return vj, vt


def _assert_volumes_agree(vj, vt):
    """tsdf and weight equal to 1e-5 on >= 99.9% of the voxels. The voxel
    centres are projected with float32 products summed in another order
    than XLA's, so a pixel coordinate that lands on a rounding tie (x.5)
    may snap to the neighbouring pixel: the count of such voxels is
    reported, and bounded by the 0.1%."""
    np.testing.assert_array_equal(vt.origin, vj.origin)
    assert vt.voxel == vj.voxel and vt.trunc == vj.trunc
    assert vt.tsdf.shape == vj.tsdf.shape and vt.tsdf.dtype == np.float32
    bad = (np.abs(vt.tsdf - vj.tsdf) > 1e-5) | (np.abs(vt.weight - vj.weight) > 1e-5)
    print(f"voxels that differ: {int(bad.sum())} of {bad.size}")
    assert bad.mean() <= 1e-3, int(bad.sum())


def test_fuse_tsdf_sphere_matches_jax():
    depths, K, Rs, ts = _sphere_depth_maps()
    vj, vt = _fuse_both(depths, None, K, Rs, ts,
                        bounds=(np.float32([-1.1] * 3), np.float32([1.1] * 3)),
                        resolution=64, trunc_voxels=3.0)
    _assert_volumes_agree(vj, vt)
    assert vt.weight.max() >= 2  # overlapping views accumulate


def test_fuse_tsdf_rendered_scene_confidences_matches_jax(rng):
    """The box-corner renderer's depths with MVS-like integer confidences
    (0-4) under min_conf 2, and bounds from a sparse cloud: the inputs the
    CLI's --mesh stage gives it."""
    scene = render_views(n_views=6, image_size=(96, 128), arc_step=0.16)
    depths = scene["depth"].astype(np.float32)
    confs = rng.integers(0, 5, depths.shape).astype(np.float32)
    H, W = depths.shape[1:]
    K, Rs, ts = scene["K"], np.stack(scene["Rs"]), np.stack(scene["ts"])
    ii, jj = rng.integers(0, H, 200), rng.integers(0, W, 200)
    d = depths[0][ii, jj]
    ok = d > 0
    rays = np.stack([(jj[ok] - K[0, 2]) / K[0, 0], (ii[ok] - K[1, 2]) / K[1, 1],
                     np.ones(ok.sum())], -1)
    sparse = ((rays * d[ok][:, None] - ts[0]) @ Rs[0]).astype(np.float32)
    vj, vt = _fuse_both(depths, confs, K, Rs, ts, resolution=64, trunc_voxels=2.5,
                        min_conf=2.0, sparse_points=sparse)
    _assert_volumes_agree(vj, vt)
    assert (vt.weight > 0).mean() > 0.05


def test_fuse_tsdf_takes_device_tensors_and_auto_bounds():
    """Depth and confidence maps handed over as tensors (PatchMatch's
    return_maps keeps them on the device) give the numpy result; without a
    sparse cloud the bounds come from the back-projected depth maps."""
    depths, K, Rs, ts = _sphere_depth_maps(n_views=6)
    confs = (depths > 0).astype(np.float32) * 3
    vj = jtsdf.fuse_tsdf(depths, confs, K, Rs, ts, resolution=48)
    vt = ttsdf.fuse_tsdf(torch.from_numpy(depths), torch.from_numpy(confs).to(torch.int64),
                         K, Rs, ts, resolution=48, device="cpu")
    _assert_volumes_agree(vj, vt)
    with pytest.raises(ValueError, match="no valid depth pixels"):
        ttsdf.fuse_tsdf(np.zeros_like(depths), None, K, Rs, ts, resolution=16, device="cpu")


def test_extract_mesh_matches_jax_exactly():
    """The port's marching tetrahedra on the JAX volume: JAX's vertices and
    faces, bit for bit (the same numpy code), and its vertex colours."""
    depths, K, Rs, ts = _sphere_depth_maps(n_views=6)
    vj = jtsdf.fuse_tsdf(depths, None, K, Rs, ts, resolution=48)
    vol = ttsdf.TSDFVolume(*vj)
    for min_weight in (1.0, 2.0):
        v_j, f_j = jmesh.extract_mesh(vj, min_weight=min_weight)
        v_t, f_t = tmesh.extract_mesh(vol, min_weight=min_weight)
        assert len(f_t) > 100
        np.testing.assert_array_equal(v_t, v_j)
        np.testing.assert_array_equal(f_t, f_j)
    pts = np.random.default_rng(3).normal(size=(500, 3)).astype(np.float32)
    cols = np.random.default_rng(4).integers(0, 256, (500, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tmesh.mesh_vertex_colors(v_t, pts, cols, device="cpu"),
                                  jmesh.mesh_vertex_colors(v_j, pts, cols))


def test_marching_tets_sphere_geometry():
    """tests/test_tsdf_mesh.py's analytic sphere on the port: vertices on
    the sphere, its area, watertight, outward normals."""
    r = 0.8
    vol = ttsdf.TSDFVolume(*_sphere_volume(n=48, r=r))
    verts, faces = tmesh.extract_mesh(vol, min_weight=0.5)
    assert len(verts) > 500 and len(faces) > 1000
    assert np.abs(np.linalg.norm(verts, axis=1) - r).max() < 0.75 * vol.voxel
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    assert abs(area - 4 * np.pi * r * r) / (4 * np.pi * r * r) < 0.03
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    assert (np.unique(edges, axis=0, return_counts=True)[1] == 2).all()
    cent = (verts[faces[:, 0]] + verts[faces[:, 1]] + verts[faces[:, 2]]) / 3
    assert (np.einsum("ij,ij->i", np.cross(e1, e2), cent) > 0).mean() > 0.999


def test_fused_rendered_scene_mesh_on_the_true_surface():
    """tests/test_tsdf_mesh.py::test_tsdf_from_rendered_scene on the port:
    exact depth maps -> a mesh whose visible vertices lie within a couple
    of voxels of the true depth of view 0."""
    scene = render_views(n_views=6, image_size=(96, 128), arc_step=0.16)
    depths = scene["depth"].astype(np.float32)
    vol = ttsdf.fuse_tsdf(depths, None, scene["K"], np.stack(scene["Rs"]),
                          np.stack(scene["ts"]), resolution=96, trunc_voxels=2.5, device="cpu")
    verts, faces = tmesh.extract_mesh(vol, min_weight=1.0)
    assert len(verts) > 1000 and len(faces) > 2000
    K, R, t = scene["K"], scene["Rs"][0], scene["ts"][0]
    Xc = verts @ R.T + t
    z = Xc[:, 2]
    u = np.round(K[0, 0] * Xc[:, 0] / z + K[0, 2]).astype(int)
    v = np.round(K[1, 1] * Xc[:, 1] / z + K[1, 2]).astype(int)
    H, W = depths.shape[1:]
    m = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    d = depths[0][v[m], u[m]]
    vis = d > 0
    assert (np.abs(z[m][vis] - d[vis]) < 2.5 * vol.voxel).mean() > 0.55


@pytest.mark.parametrize("binary", [True, False])
def test_mesh_ply_round_trips_against_jax(tmp_path, binary):
    """A mesh written by either package's save_mesh_ply reads back the same
    through the other's load_mesh_ply, and both files are the same bytes."""
    verts, faces = tmesh.extract_mesh(ttsdf.TSDFVolume(*_sphere_volume(n=24)))
    cols = np.full((len(verts), 3), [10, 200, 30], np.uint8)
    pt, pj = tmp_path / "t.ply", tmp_path / "j.ply"
    tply.save_mesh_ply(str(pt), verts, faces, cols, binary=binary)
    jply.save_mesh_ply(str(pj), verts, faces, cols, binary=binary)
    assert pt.read_bytes() == pj.read_bytes()
    for load, path in ((jply.load_mesh_ply, pt), (tply.load_mesh_ply, pj)):
        v2, f2, c2 = load(str(path))
        np.testing.assert_allclose(v2, verts, atol=1e-4)
        assert (f2 == faces).all() and (c2 == cols).all()
    tply.save_mesh_ply(str(tmp_path / "nc.ply"), verts, faces, None, binary=binary)
    assert tply.load_mesh_ply(str(tmp_path / "nc.ply"))[2] is None
    assert tply.compute_scene_bounds(verts)[3] == pytest.approx(
        jply.compute_scene_bounds(verts)[3])
