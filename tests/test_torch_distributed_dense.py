"""The port's multi-device dense stages on the CPU, four gloo ranks spawned
by parallel.make_mesh, against the port on one device and against the JAX
package's mesh functions on the 8 virtual devices of tests/conftest.py
(mirrors tests/test_distributed_dense.py and the mesh test of
tests/test_tsdf_mesh.py): distributed_patchmatch (5 views over 4 ranks),
distributed_plane_sweep, the view-sharded TSDF fusion, and the `mesh=`
branches of PatchMatchMVS (with and without checkpoints) and
PlaneSweepReconstructor."""

import numpy as np
import pytest
import torch

import jax

from recon3d_tpu.config import MeshConfig as JaxMeshConfig
from recon3d_tpu.dense import distributed as jdist
from recon3d_tpu.dense import tsdf as jtsdf
from recon3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import PatchMatchConfig, PlaneSweepConfig
from recon3d_tpu_torch.dense import distributed as tdist
from recon3d_tpu_torch.dense import patchmatch as tpm
from recon3d_tpu_torch.dense import plane_sweep as tps
from recon3d_tpu_torch.dense import tsdf as ttsdf
from recon3d_tpu_torch.parallel import make_mesh
from recon3d_tpu_torch.runtime.checkpoint import StageCheckpointer
from tests.render import render_views
from tests.test_distributed_dense import _batch
from tests.test_torch_patchmatch import jax_coarse_fields
from tests.test_tsdf_mesh import _sphere_depth_maps

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return render_views(n_views=6, image_size=(64, 96), arc_step=0.12)


@pytest.fixture(scope="module")
def mesh():
    with make_mesh(devices=4, device="cpu", timeout_s=300) as m:
        yield m


def _pm_agreement(depth, ref):
    """Share of pixels within 2e-3 relative depth of `ref`
    (tests/test_distributed_dense.py:78-80)."""
    return float((np.abs(depth - ref) / np.maximum(np.abs(ref), 1e-6) < 2e-3).mean())


def _gt_median_ok(scene, refs, depth, conf):
    """Confident pixels within a median 5% of the ground truth, per view
    (tests/test_distributed_dense.py:83-92)."""
    for k, r in enumerate(refs):
        gt = scene["depth"][r]
        sel = (conf[k] >= 3) & (gt > 0)
        if sel.sum() >= 100:
            assert np.median(np.abs(depth[k][sel] - gt[sel]) / gt[sel]) < 0.05, r


def test_distributed_patchmatch_matches_single_device_and_jax(scene, mesh):
    """5 views over 4 ranks (padded to 8 rows, 2 a rank, the padding never
    computed), given the JAX draws: the port's shards against the port on
    one device and against the JAX mesh function, each held to the JAX
    test's bound (more than 90% of pixels within 2e-3 relative depth) and
    to its ground-truth gate. (PatchMatch is chaotic at 1e-3, ROADMAP.md
    section 3: here the port agrees with the JAX run on 92.9% of the
    pixels, the JAX run with itself on images scaled by 1 + 2^-22 on
    91.2%.)"""
    refs = [1, 2, 3, 4, 5]
    b = _batch(scene, refs)
    kw = dict(num_iterations=2, patch=7)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)[:5]
    H, W = b["ref_grays"].shape[1:]
    per_view = [jax_coarse_fields(k, H, W, num_iterations=2) for k in keys]
    fields = [np.stack([f[i].numpy() for f in per_view]) for i in range(len(per_view[0]))]
    args = [b[k] for k in ("ref_grays", "src_grays", "K", "R_refs", "t_refs", "R_srcss",
                           "t_srcss", "depth_ranges")]

    out = tdist.distributed_patchmatch(*args, mesh=mesh, coarse_fields=fields, **kw)
    assert out.depth.shape == (5, 64, 96) and out.confidence.shape == (5, 64, 96)
    single = tpm.patchmatch_depth_batch(
        *[torch.from_numpy(np.asarray(a, np.float32)) for a in args],
        coarse_fields=[torch.from_numpy(f) for f in fields], **kw)
    assert _pm_agreement(out.depth, single.depth.numpy()) > 0.9

    j = jdist.distributed_patchmatch(*args, seed=0, mesh=jax_make_mesh(),
                                     keys=np.asarray(keys), **kw)
    assert _pm_agreement(out.depth, j.depth) > 0.9
    for depth, conf in ((out.depth, out.confidence), (j.depth, j.confidence)):
        _gt_median_ok(scene, refs, depth, conf)


def test_patchmatch_without_draws_uses_the_views_generators(scene, mesh):
    """Without pre-drawn fields view b draws from view_generator(seed,
    positions[b]), wherever it lands: the shards reproduce one device."""
    refs = [1, 2, 3]
    b = _batch(scene, refs)
    args = [b[k] for k in ("ref_grays", "src_grays", "K", "R_refs", "t_refs", "R_srcss",
                           "t_srcss", "depth_ranges")]
    pos = [4, 0, 7]
    out = tdist.distributed_patchmatch(*args, seed=3, mesh=mesh, positions=pos,
                                       num_iterations=1, patch=7)
    single = tpm.patchmatch_depth_batch(
        *[torch.from_numpy(np.asarray(a, np.float32)) for a in args],
        generators=[tpm.view_generator(3, p, "cpu") for p in pos], num_iterations=1, patch=7)
    assert _pm_agreement(out.depth, single.depth.numpy()) > 0.9
    by_stage = {}
    with mesh.record_launches(by_stage, "pm"):
        tdist.distributed_patchmatch(*args, seed=3, mesh=mesh, positions=pos,
                                     num_iterations=1, patch=7)
    rec = by_stage["pm"]
    # K1 runs on the ranks that hold views (rows 0, 1, 2 of 4 ranks: 1 each)
    assert rec["kernel"] == 0 and [r["plain"] > 0 for r in rec["by_rank"]] == [1, 1, 1, 0]
    assert rec["plain"] == sum(r["plain"] for r in rec["by_rank"])


def test_distributed_plane_sweep_matches_single_device_and_jax(scene, mesh):
    """Two reference views over 4 ranks: the port's shards give the port's
    one-device sweep; both it and the JAX mesh function pass the JAX
    test's accuracy gate (tests/test_distributed_dense.py:96-118), and the
    port agrees with the JAX run at least as well as that run agrees with
    itself on images scaled by 1 + 2^-22, less 1% (the sweep is chaotic:
    tests/test_torch_plane_sweep.py)."""
    refs = [2, 3]
    b = _batch(scene, refs)
    gt = scene["depth"]
    dmin = min(gt[r][gt[r] > 0].min() for r in refs) * 0.7
    dmax = max(gt[r][gt[r] > 0].max() for r in refs) * 1.4
    dr = np.asarray([dmin, dmax], np.float32)
    args = [b[k] for k in ("ref_grays", "src_grays", "K", "R_refs", "t_refs", "R_srcss",
                           "t_srcss")]
    kw = dict(num_depths=64, patch=5, ncc_threshold=0.7)
    depth, cnt, ncc = tdist.distributed_plane_sweep(*args, dr, mesh=mesh, **kw)
    assert depth.shape == (2, 64, 96)
    s_d, s_c, s_n = tps.sweep_depth_maps(
        *[torch.from_numpy(np.asarray(a, np.float32)) for a in args], torch.from_numpy(dr), **kw)
    np.testing.assert_allclose(depth, s_d.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(cnt, s_c.numpy())
    jm = jax_make_mesh()
    jd, jc, _ = jdist.distributed_plane_sweep(*args, dr, mesh=jm, **kw)
    scaled = list(args)
    scaled[0] = args[0] * np.float32(1 + 2 ** -22)
    scaled[1] = args[1] * np.float32(1 + 2 ** -22)
    jd2, jc2, _ = jdist.distributed_plane_sweep(*scaled, dr, mesh=jm, **kw)
    for bi, r in enumerate(refs):
        for d_, c_ in ((depth, cnt), (np.asarray(jd), np.asarray(jc))):
            conf = (c_[bi] >= 3) & (gt[r] > 0)
            assert conf.mean() > 0.2
            assert np.median(np.abs(d_[bi][conf] - gt[r][conf]) / gt[r][conf]) < 0.06
    both = (cnt >= 3) & (np.asarray(jc) >= 3)
    both2 = (np.asarray(jc2) >= 3) & (np.asarray(jc) >= 3)
    for t in (1e-3, 2e-2):
        port = (np.abs(depth - jd) / jd < t)[both].mean()
        self_ = (np.abs(np.asarray(jd2) - jd) / jd < t)[both2].mean()
        assert port >= self_ - 0.01, (t, port, self_)


def test_tsdf_sharded_matches_single_device_and_jax(mesh):
    """fuse_tsdf over 4 ranks (6 views: 2, 2, 2, 0) against one device and
    the JAX mesh fusion on 8 devices, within 1e-5
    (tests/test_tsdf_mesh.py:182-183)."""
    depths, K, Rs, ts = _sphere_depth_maps(n_views=6, H=48, W=64)
    bounds = (np.float32([-1.1] * 3), np.float32([1.1] * 3))
    single = ttsdf.fuse_tsdf(depths, None, K, Rs, ts, bounds=bounds, resolution=40,
                             device="cpu")
    shard = ttsdf.fuse_tsdf(depths, None, K, Rs, ts, bounds=bounds, resolution=40,
                            device="cpu", mesh=mesh)
    np.testing.assert_allclose(shard.weight, single.weight, atol=1e-5)
    np.testing.assert_allclose(shard.tsdf, single.tsdf, atol=1e-5)
    jm = jax_make_mesh(JaxMeshConfig(model_parallel=1), devices=jax.devices()[:8])
    j = jtsdf.fuse_tsdf(depths, None, K, Rs, ts, bounds=bounds, resolution=40, mesh=jm)
    np.testing.assert_allclose(shard.weight, j.weight, atol=1e-5)
    np.testing.assert_allclose(shard.tsdf, j.tsdf, atol=1e-5)
    assert shard.voxel == j.voxel and np.array_equal(shard.origin, j.origin)


def _mvs_inputs(scene):
    cam = Camera(K=torch.from_numpy(np.asarray(scene["K"], np.float32)), dist=torch.zeros(5))
    poses = {i: (scene["Rs"][i].astype(np.float32), scene["ts"][i].astype(np.float32))
             for i in range(len(scene["images"]))}
    return cam, poses, scene["images"].astype(np.float32)


def test_patchmatch_mvs_mesh_branch_and_its_checkpoints(scene, mesh, tmp_path):
    """PatchMatchMVS.reconstruct(mesh=): every view in one sharded call,
    the maps and the cloud those of one device; with a checkpointer the
    maps are saved by rank 0 after the gather, and a run that finds all of
    them loads them and computes nothing."""
    cam, poses, images = _mvs_inputs(scene)
    cfg = PatchMatchConfig(scale=1.0, num_iterations=1, num_source_views=3)
    rec = tpm.PatchMatchMVS(cam, cfg, device="cpu")
    p1, c1, m1 = rec.reconstruct(images, poses, return_maps=True)
    p2, c2, m2 = rec.reconstruct(images, poses, return_maps=True, mesh=mesh)
    assert (m2["depth"].numpy() == m1["depth"].numpy()).mean() > 0.9
    assert abs(len(p2) - len(p1)) <= 0.02 * len(p1) and len(p1) > 100
    ck = StageCheckpointer(str(tmp_path / "ck"))
    p3, _ = rec.reconstruct(images, poses, mesh=mesh, checkpointer=ck)
    assert all(ck.load_depth(i) is not None for i in poses)
    np.testing.assert_array_equal(p3, p2)
    by_stage = {}
    with mesh.record_launches(by_stage, "resume"):
        p4, _ = rec.reconstruct(images, poses, mesh=mesh, checkpointer=ck)
    np.testing.assert_array_equal(p4, p2)
    assert by_stage["resume"]["plain"] == 0


def test_plane_sweep_reconstructor_mesh_branch(scene, mesh):
    """PlaneSweepReconstructor.reconstruct(mesh=): the reference views shard
    over the ranks and rank 0 fuses the cloud one device fuses."""
    cam, poses, images = _mvs_inputs(scene)
    cfg = PlaneSweepConfig(scale=1.0, num_depths=32)
    rec = tps.PlaneSweepReconstructor(cam, cfg, device="cpu")
    p1, c1, m1 = rec.reconstruct(images, poses, return_maps=True)
    p2, c2, m2 = rec.reconstruct(images, poses, return_maps=True, mesh=mesh)
    np.testing.assert_allclose(m2["depth"].numpy(), m1["depth"].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_array_equal(c2, c1)
    assert m2["ids"] == m1["ids"]
