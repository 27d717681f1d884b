"""Stage checkpoints in the port (tests/test_checkpoint_dense.py): the
depth-map round trip, a killed PatchMatch run that resumes from its
finished views and reproduces the fresh run, a fully checkpointed rerun,
and checkpoints written by either package restored by the other."""

import os
import types

import numpy as np
import pytest
import torch

from recon3d_tpu.runtime.checkpoint import StageCheckpointer as JaxCheckpointer
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import PatchMatchConfig
from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS
from recon3d_tpu_torch.runtime.checkpoint import DEPTH_DIR, SPARSE_NAME, StageCheckpointer
from tests.render import render_views

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return render_views(n_views=5, image_size=(96, 128), arc_step=0.12)


def _mvs(scene):
    cam = Camera.from_matrix(scene["K"])
    cfg = PatchMatchConfig(scale=1.0, num_iterations=2, patch_size=7, min_views=3,
                           voxel_size=0.01)
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(5)}
    return PatchMatchMVS(cam, cfg, device="cpu"), poses


@pytest.fixture(scope="module")
def fresh(scene):
    """A run without checkpoints (the maps stay on the device)."""
    rec, poses = _mvs(scene)
    return rec.reconstruct(scene["images"], poses)


def test_depth_checkpoint_roundtrip(tmp_path):
    ck = StageCheckpointer(str(tmp_path))
    assert ck.load_depth(3) is None and not ck.has_sparse()
    d = np.random.default_rng(0).random((16, 24)).astype(np.float32)
    c = (d > 0.5).astype(np.float32) * 4
    ck.save_depth(3, d, c)
    d2, c2 = ck.load_depth(3)
    np.testing.assert_array_equal(d, d2)
    np.testing.assert_array_equal(c, c2)
    assert ck.depth_path(3) == str(tmp_path / DEPTH_DIR / "depth_0003.npz")
    assert sorted(os.listdir(tmp_path / DEPTH_DIR)) == ["depth_0003.npz"]  # no temp left


def test_mvs_kill_and_resume_reproduces_fresh_run(scene, fresh, tmp_path):
    rec, poses = _mvs(scene)
    p_fresh, c_fresh = fresh
    assert len(p_fresh) > 500

    # with checkpointing: the same output, and all 5 views persisted
    ck = StageCheckpointer(str(tmp_path / "ck"))
    p_ck, c_ck = rec.reconstruct(scene["images"], poses, checkpointer=ck)
    np.testing.assert_allclose(p_ck, p_fresh, atol=1e-5)
    np.testing.assert_array_equal(c_ck, c_fresh)
    for i in range(5):
        assert os.path.exists(ck.depth_path(i))

    # a crash that lost the last two views: the resume recomputes them and
    # reproduces the fresh run
    os.unlink(ck.depth_path(3))
    os.unlink(ck.depth_path(4))
    p_res, c_res = rec.reconstruct(scene["images"], poses, checkpointer=ck)
    np.testing.assert_allclose(p_res, p_fresh, atol=1e-5)
    np.testing.assert_array_equal(c_res, c_fresh)
    assert os.path.exists(ck.depth_path(3)) and os.path.exists(ck.depth_path(4))


def test_fully_checkpointed_rerun_computes_nothing(scene, fresh, tmp_path):
    rec, poses = _mvs(scene)
    ck = StageCheckpointer(str(tmp_path))
    rec.reconstruct(scene["images"], poses, checkpointer=ck)
    stamps = [os.stat(ck.depth_path(i)).st_mtime_ns for i in range(5)]
    batches = []
    inner = rec._depth_batches
    rec._depth_batches = lambda positions, *a: batches.append(positions) or inner(positions, *a)
    p_all, c_all = rec.reconstruct(scene["images"], poses, checkpointer=ck)
    assert batches == [[]]
    np.testing.assert_allclose(p_all, fresh[0], atol=1e-5)
    np.testing.assert_array_equal(c_all, fresh[1])
    assert [os.stat(ck.depth_path(i)).st_mtime_ns for i in range(5)] == stamps


def _pipeline(rng, n_views=4, n_points=50):
    """The state a StageCheckpointer saves and restores."""
    p = types.SimpleNamespace()
    p.poses = {i: (rng.normal(size=(3, 3)).astype(np.float32),
                   rng.normal(size=3).astype(np.float32)) for i in (0, 2, 3, 5)[:n_views]}
    p.points3d = rng.normal(size=(n_points, 3)).astype(np.float32)
    p.point_colors = rng.integers(0, 256, (n_points, 3)).astype(np.uint8)
    p.failed = {1, 4}
    p.registered = set(p.poses)
    return p


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(writer, tmp_path):
    """A sparse state and depth maps saved by one package restore in the
    other, to the bit; the files carry the same names and arrays."""
    rng = np.random.default_rng(1)
    src = _pipeline(rng)
    save, load = ((JaxCheckpointer, StageCheckpointer) if writer == "jax"
                  else (StageCheckpointer, JaxCheckpointer))
    w, r = save(str(tmp_path)), load(str(tmp_path))
    w.save_sparse(src)
    d = rng.random((12, 16)).astype(np.float32)
    c = rng.integers(0, 5, (12, 16)).astype(np.float32)
    w.save_depth(7, d, c)
    assert (tmp_path / SPARSE_NAME).exists() and r.has_sparse()

    dst = types.SimpleNamespace()
    assert r.restore_sparse(dst)
    assert sorted(dst.poses) == sorted(src.poses) and dst.registered == set(src.poses)
    for i in src.poses:
        np.testing.assert_array_equal(dst.poses[i][0], src.poses[i][0])
        np.testing.assert_array_equal(dst.poses[i][1], src.poses[i][1])
    np.testing.assert_array_equal(dst.points3d, src.points3d)
    np.testing.assert_array_equal(dst.point_colors, src.point_colors)
    assert dst.failed == src.failed
    d2, c2 = r.load_depth(7)
    np.testing.assert_array_equal(d2, d)
    np.testing.assert_array_equal(c2, c)
    with np.load(tmp_path / SPARSE_NAME) as z:
        assert sorted(z.files) == ["Rs", "colors", "failed", "points", "pose_ids", "ts"]
        assert z["pose_ids"].dtype == np.int64 and z["Rs"].dtype == np.float32


def test_port_resumes_from_depth_maps_written_by_jax(scene, fresh, tmp_path):
    """Depth maps saved through the JAX checkpointer (the port's own maps)
    resume the port's PatchMatch run to the fresh cloud."""
    rec, poses = _mvs(scene)
    mine = StageCheckpointer(str(tmp_path / "port"))
    rec.reconstruct(scene["images"], poses, checkpointer=mine)
    jck = JaxCheckpointer(str(tmp_path / "jax"))
    for i in range(3):
        jck.save_depth(i, *mine.load_depth(i))
    p, c = rec.reconstruct(scene["images"], poses,
                           checkpointer=StageCheckpointer(str(tmp_path / "jax")))
    np.testing.assert_allclose(p, fresh[0], atol=1e-5)
    np.testing.assert_array_equal(c, fresh[1])
