"""Global SfM of the port (recon3d_tpu_torch/sfm/global_sfm.py) against the
JAX package's (recon3d_tpu/sfm/global_sfm.py) on the CPU.

Per function the same numpy inputs go through both. Rotation averaging
sums its segments in another order (index_add_ against segment_sum) and
projects through another SVD, so it is held to 2e-5 per matrix entry;
translation averaging and the track union-find are the same numpy code and
are held to equality. End to end the two pipelines are held to outcomes on
the 6-view scene of tests/test_global_sfm.py, as that test holds the JAX
one: every camera, under 1.5 px, adjacent rotations within 1 deg of the
truth.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import ReconstructionConfig as JaxConfig
from recon3d_tpu.io.dataset import image_set_from_arrays as jax_image_set
from recon3d_tpu.sfm import global_sfm as jglobal
from recon3d_tpu.sfm.pipeline import SfMPipeline as JaxPipeline
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.ops.triangulate import triangulate_nview
from recon3d_tpu_torch.sfm import global_sfm as tglobal
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.render import render_views

torch.set_num_threads(2)

# Rotation averaging: per-entry agreement of the averaged rotations.
ROT_ATOL = 2e-5


def _rot_err_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def _ring_poses(V, spread=0.5):
    Rs, Cs = [], []
    for i in range(V):
        th = spread * i / V
        Rs.append(np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32))
        Cs.append(np.float32([2 * np.sin(th), 0.1 * i, -2 * np.cos(th)]))
    return np.stack(Rs), np.stack(Cs)


def _rotation_graph(V, span, rng=None):
    """Edges (i, j) for j < i + span; relative rotations exact, or with
    ~1.1 deg of noise each when rng is given (tests/test_global_sfm.py)."""
    Rs, _ = _ring_poses(V)
    ei, ej, R_rel = [], [], []
    for i in range(V):
        for j in range(i + 1, min(i + span, V)):
            N = np.eye(3)
            if rng is not None:
                ax = rng.normal(size=3) * 0.02
                th = np.linalg.norm(ax)
                k = ax / max(th, 1e-12)
                Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
                N = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
            ei.append(i)
            ej.append(j)
            R_rel.append(N @ Rs[j] @ Rs[i].T)
    return (Rs, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(R_rel).astype(np.float32), np.ones(len(ei), np.float32))


@pytest.mark.parametrize("noisy", [False, True], ids=["exact", "noisy"])
def test_rotation_averaging_matches_jax(noisy):
    rng = np.random.default_rng(42) if noisy else None
    V = 10 if noisy else 12
    Rs, ei, ej, R_rel, w = _rotation_graph(V, 5 if noisy else 4, rng)
    R_ref, seen_ref = jglobal.rotation_averaging(ei, ej, R_rel, w, V)
    R, seen = tglobal.rotation_averaging(ei, ej, R_rel, w, V, device="cpu")
    np.testing.assert_array_equal(seen, seen_ref)
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=ROT_ATOL)
    errs = [_rot_err_deg(R[i], Rs[i] @ Rs[0].T) for i in range(V)]
    if noisy:
        assert np.mean(errs) < 1.0
    else:
        assert seen.all() and max(errs) < 0.05


def test_rotation_averaging_median_is_jax_median():
    """jnp.median of an even-length vector averages its two middle values."""
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tglobal._median(x)) == float(jnp.median(jnp.asarray(x.numpy()))) == 2.5
    assert float(tglobal._median(x[:3])) == 3.0


def test_rotation_averaging_runs_on_the_card_unless_asked():
    _, ei, ej, R_rel, w = _rotation_graph(4, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tglobal.rotation_averaging(ei, ej, R_rel, w, 4)
    R, _ = tglobal.rotation_averaging(ei, ej, R_rel, w, 4, iters=3, device="cpu")
    assert R.dtype == np.float32 and np.allclose(R[0], np.eye(3), atol=1e-6)


def _translation_graph(V, span, curve):
    Rs, Cs = [], []
    for i in range(V):
        th = curve(i)
        Rs.append(np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32))
        Cs.append(np.float32([2 * np.sin(th), 0.3 * np.sin(3 * th) if V > 50 else 0.1 * i,
                              -2 * np.cos(th)]))
    Rs, Cs = np.stack(Rs), np.stack(Cs)
    ei, ej, t_rel = [], [], []
    for i in range(V):
        for j in range(i + 1, min(i + span, V)):
            t = -Rs[j] @ (Cs[j] - Cs[i])
            ei.append(i)
            ej.append(j)
            t_rel.append(t / np.linalg.norm(t))
    return (Rs, Cs, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(t_rel).astype(np.float32))


@pytest.mark.parametrize("V", [10, 150])
def test_translation_averaging_matches_jax(V):
    """The same host float64 solve: equal centres, and the truth up to scale
    (2% of the extent at 10 cameras, 3% at 150: tests/test_global_sfm.py)."""
    curve = (lambda i: 0.5 * i / V) if V == 10 else (lambda i: 2 * np.pi * i / V * 0.8)
    Rs, Cs, ei, ej, t_rel = _translation_graph(V, 4 if V == 10 else 6, curve)
    w = np.ones(len(ei), np.float32)
    C = tglobal.translation_averaging(ei, ej, t_rel, Rs, w, V)
    np.testing.assert_array_equal(C, jglobal.translation_averaging(ei, ej, t_rel, Rs, w, V))
    gt = Cs - Cs[0]
    s = np.sum(C * gt) / max(np.sum(C * C), 1e-12)
    err = np.linalg.norm(s * C - gt, axis=1)
    assert err.max() < (0.02 if V == 10 else 0.03) * np.linalg.norm(gt, axis=1).max()


def _config(cls):
    """The configuration of tests/test_global_sfm.py."""
    cfg = cls()
    return cfg.replace(
        sift=dataclasses.replace(cfg.sift, max_features=1024, contrast_threshold=0.012),
        match=dataclasses.replace(cfg.match, min_matches=15, ransac_hypotheses=512),
    )


def _run_both(n_views, arc_step):
    scene = render_views(n_views=n_views, image_size=(160, 192), arc_step=arc_step)
    jpipe = JaxPipeline(config=_config(JaxConfig))
    jout = jpipe.reconstruct_global(
        image_set=jax_image_set(scene["images"], JaxCamera.from_matrix(scene["K"])))
    tpipe = SfMPipeline(config=_config(ReconstructionConfig), device="cpu")
    tout = tpipe.reconstruct_global(
        image_set=image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"])))
    return scene, (jpipe, jout), (tpipe, tout)


@pytest.fixture(scope="module")
def six_views():
    return _run_both(6, 0.14)


def _adjacent_rot_errs(poses, scene):
    ids = sorted(poses)
    errs = []
    for a, b in zip(ids[:-1], ids[1:]):
        Ra, Rb = np.asarray(poses[a].R), np.asarray(poses[b].R)
        errs.append(_rot_err_deg(Rb @ Ra.T, scene["Rs"][b] @ scene["Rs"][a].T))
    return np.asarray(errs)


def test_global_sfm_end_to_end_matches_jax(six_views):
    scene, (jpipe, (jpts, _, jposes)), (tpipe, (pts, cols, poses)) = six_views
    for pipe, p, ps in ((jpipe, jpts, jposes), (tpipe, pts, poses)):
        assert len(ps) == 6 and len(p) > 100
        assert pipe.stats["mean_reproj_px"] < 1.5
        assert _adjacent_rot_errs(ps, scene).max() < 1.0
    assert pts.dtype == np.float32 and cols.dtype == np.uint8 and cols.shape == pts.shape
    assert np.isfinite(pts).all() and tpipe.stats["global_solve_time"] > 0
    assert set(tpipe.stats) >= {"load_time", "extract_time", "match_time", "total_time",
                                "num_points", "num_cameras", "mean_reproj_px"}
    # the point count within a quarter of the reference's
    assert 0.75 < len(pts) / len(jpts) < 1.33


def _as_port_pipeline(jpipe):
    """A stand-in that carries the JAX pipeline's match graph and keypoints
    into the port's functions."""
    pipe = SfMPipeline(device="cpu")
    pipe.camera = Camera.from_matrix(np.array(jpipe.camera.K))
    pipe.kp_xy = [np.asarray(k) for k in jpipe.kp_xy]
    pipe.matches = {k: dict(v) for k, v in jpipe.matches.items()}
    return pipe


def test_relative_poses_match_jax(six_views):
    """The batched relative poses of every verified pair: the same pairs
    kept, the same cheirality counts within 1, rotations and unit
    translations within 1e-4."""
    _, (jpipe, _), _ = six_views
    ref = jglobal.relative_poses(jpipe)
    got = tglobal.relative_poses(_as_port_pipeline(jpipe))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
    np.testing.assert_allclose(got[3], ref[3], atol=1e-4)
    assert np.abs(got[4] - ref[4]).max() <= 1
    pipe = _as_port_pipeline(jpipe)
    for m in pipe.matches.values():
        m["idx1"], m["idx2"] = m["idx1"][:3], m["idx2"][:3]
    with pytest.raises(RuntimeError, match="no reliable pairs"):
        tglobal.relative_poses(pipe)


def test_build_tracks_identical(six_views):
    _, (jpipe, _), _ = six_views
    pipe = _as_port_pipeline(jpipe)
    ref = jglobal.build_tracks(jpipe, max_tracks=100_000)
    assert tglobal.build_tracks(pipe, max_tracks=100_000) == ref
    assert tglobal.build_tracks(pipe, max_tracks=7) == ref[:7]
    # aux (pose-graph-only) matches never enter a track
    aux = types.SimpleNamespace(kp_xy=pipe.kp_xy, matches={
        k: dict(v, aux=True) for k, v in pipe.matches.items()})
    assert tglobal.build_tracks(aux, max_tracks=10) == []


def test_triangulation_gate_matches_jax(six_views):
    """All tracks through both batched DLTs with the JAX run's final poses:
    points within 5e-3 of their norm and at a median of 1e-4 (a two-view
    track of low parallax is an ill-conditioned 4x4 normal matrix, whose
    float32 null vector turns with the eigensolver: 2.5e-3 at most here),
    the same gate decisions on 99% of the observations."""
    _, (jpipe, _), _ = six_views
    tracks = jglobal.build_tracks(jpipe, max_tracks=100_000)
    table = tglobal.track_table(_as_port_pipeline(jpipe), tracks)
    _, cam_idx, xs, msk = table
    K = np.asarray(jpipe.camera.K, np.float32)
    V = len(jpipe.kp_xy)
    Rs = np.stack([np.asarray(jpipe.poses[i][0], np.float32) for i in range(V)])
    ts = np.stack([np.asarray(jpipe.poses[i][1], np.float32).reshape(3) for i in range(V)])
    P_all = (K[None] @ np.concatenate([Rs, ts[:, :, None]], axis=2)).astype(np.float32)
    X_ref, ok_ref = jglobal._triangulate_gate(
        *(jnp.asarray(a) for a in (K, P_all, Rs, ts, cam_idx, xs, msk)), jnp.float32(2.0))
    X_ref, ok_ref = np.asarray(X_ref), np.asarray(ok_ref)
    X, ok = tglobal.triangulate_gate(
        *(torch.from_numpy(a) for a in (K, P_all, Rs, ts, cam_idx.astype(np.int64), xs, msk)),
        2.0)
    X, ok = X.numpy(), ok.numpy()
    rel = np.linalg.norm(X - X_ref, axis=1) / np.linalg.norm(X_ref, axis=1)
    assert rel.max() < 5e-3 and np.median(rel) < 1e-4
    assert (ok == ok_ref).mean() > 0.99
    assert ok_ref.sum() > 0.5 * msk.sum()


def test_triangulate_nview_takes_per_track_cameras():
    """Ps (T, V, 3, 4), one set of cameras per track, gives what the
    shared-camera form gives track by track."""
    rng = np.random.default_rng(0)
    K = np.array([[200.0, 0, 96], [0, 200.0, 80], [0, 0, 1]])
    Ps = []
    for v in range(5):
        th = 0.1 * v
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        Ps.append(K @ np.concatenate([R, np.array([[0.3 * v], [0.0], [4.0]])], 1))
    Ps = np.stack(Ps).astype(np.float32)
    X = rng.normal(size=(7, 3)).astype(np.float32)
    cams = np.stack([rng.permutation(5)[:4] for _ in range(7)])
    xh = np.einsum("tvij,tj->tvi", Ps[cams], np.concatenate([X, np.ones((7, 1))], 1))
    xs = (xh[..., :2] / xh[..., 2:]).astype(np.float32)
    msk = np.ones((7, 4), np.float32)
    msk[3, 2:] = 0
    got = triangulate_nview(torch.from_numpy(Ps[cams]), torch.from_numpy(xs),
                            torch.from_numpy(msk)).numpy()
    for t in range(7):
        one = triangulate_nview(torch.from_numpy(Ps[cams[t]]), torch.from_numpy(xs[t]),
                                torch.from_numpy(msk[t])).numpy()
        np.testing.assert_allclose(got[t], one, atol=1e-6)
    np.testing.assert_allclose(got, X, atol=1e-2)


@pytest.mark.slow
def test_global_sfm_wider_scene_matches_jax():
    """The 20-view arc of tests/test_global_sfm.py::test_global_sfm_wider_scene,
    both pipelines at that test's bounds."""
    scene, (jpipe, (jpts, _, jposes)), (tpipe, (pts, _, poses)) = _run_both(20, 0.05)
    for pipe, p, ps in ((jpipe, jpts, jposes), (tpipe, pts, poses)):
        assert len(ps) == 20 and len(p) > 200
        assert pipe.stats["mean_reproj_px"] < 1.5
        errs = _adjacent_rot_errs(ps, scene)
        assert np.median(errs) < 0.8 and errs.max() < 2.0
