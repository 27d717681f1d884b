"""The SfM back end of the port's SfMPipeline (initial pair, registration
waves, triangulation, motion refinement, bundle adjustment, the final
sweep) against the JAX pipeline on the CPU.

Per function the same numpy inputs go through both, with the JAX draws
handed to the port. The whole path is chaotic in its random draws
(registration order, wave sizes and BA feed one another), so end to end
the two pipelines are held to outcomes on the 5 rendered views of
tests/test_sfm_pipeline.py: cameras registered, reprojection error, poses
against the scene's true ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.camera import Camera as JaxCamera
from recon3d_tpu.config import ReconstructionConfig as JaxConfig
from recon3d_tpu.io.dataset import image_set_from_arrays as jax_image_set
from recon3d_tpu.ops.ransac import sample_indices as jax_sample_indices
from recon3d_tpu.sfm import pipeline as jpipe
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.io.ply import load_ply
from recon3d_tpu_torch.ops.pnp import pnp_hypothesis_counts
from recon3d_tpu_torch.sfm import pipeline as tpipe
from tests.render import render_views
from tests.synthetic import make_scene, rotation_angle_deg
from tests.torch_scene import pose_errors, true_fundamental

torch.set_num_threads(2)


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _config(cls):
    """The configuration of tests/test_sfm_pipeline.py."""
    cfg = cls()
    return cfg.replace(
        sift=dataclasses.replace(cfg.sift, max_features=1024, contrast_threshold=0.012),
        match=dataclasses.replace(cfg.match, min_matches=15, ransac_hypotheses=512),
        sfm=dataclasses.replace(cfg.sfm, pnp_hypotheses=512),
    )


@pytest.fixture(scope="module")
def scene():
    return render_views(n_views=5, image_size=(160, 192), arc_step=0.14)


def _jax_pipeline(scene):
    pipe = jpipe.SfMPipeline(config=_config(JaxConfig))
    pipe.set_image_set(jax_image_set(scene["images"], JaxCamera.from_matrix(scene["K"])))
    return pipe


def _port_image_set(scene):
    return image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"]))


def _port_pipeline(scene):
    pipe = tpipe.SfMPipeline(config=_config(ReconstructionConfig), device="cpu")
    pipe.set_image_set(_port_image_set(scene))
    return pipe


@pytest.fixture(scope="module")
def both_results(scene):
    ref = _jax_pipeline(scene)
    ref.reconstruct()
    port = tpipe.SfMPipeline(config=_config(ReconstructionConfig), device="cpu")
    points, colors, poses = port.reconstruct(image_set=_port_image_set(scene))
    return ref, port, points, colors, poses


# ---------------------------------------------------------------------------
# the batched helpers against the JAX ones


def _pairs(seeds, n_points=96, pad_to=128):
    """Two-view problems padded to one capacity, plus one padded pair
    (identity F, zero mask) as find_best_initial_pair pads its batch."""
    K = None
    rows = []
    for seed in seeds:
        sc = make_scene(np.random.default_rng(seed), n_points=n_points, n_cams=2, noise_px=0.4,
                        outlier_frac=0.1)
        K = sc["K"].astype(np.float32)
        x1 = np.zeros((pad_to, 2), np.float32)
        x2 = np.zeros((pad_to, 2), np.float32)
        mask = np.zeros(pad_to, np.float32)
        x1[:n_points], x2[:n_points], mask[:n_points] = sc["obs"][0], sc["obs"][1], 1.0
        F = true_fundamental(K, sc["Rs"][0], sc["ts"][0], sc["Rs"][1], sc["ts"][1])
        rows.append((sc, (F / np.linalg.norm(F)).astype(np.float32), x1, x2, mask))
    zero = np.zeros((pad_to, 2), np.float32)
    rows.append((None, np.eye(3, dtype=np.float32), zero, zero, np.zeros(pad_to, np.float32)))
    return K, rows


def test_triangulate_validated_batch_matches_jax():
    K, rows = _pairs((1, 2, 3))
    R1s = np.stack([r[0]["Rs"][0] for r in rows[:3]] + [np.eye(3)]).astype(np.float32)
    t1s = np.stack([r[0]["ts"][0] for r in rows[:3]] + [np.zeros(3)]).astype(np.float32)
    R2s = np.stack([r[0]["Rs"][1] for r in rows[:3]] + [np.eye(3)]).astype(np.float32)
    t2s = np.stack([r[0]["ts"][1] for r in rows[:3]] + [np.zeros(3)]).astype(np.float32)
    x1s, x2s, masks = (np.stack([r[k] for r in rows]) for k in (2, 3, 4))
    X_ref, ok_ref, par_ref = jpipe._triangulate_validated_batch(
        J(K), J(R1s), J(t1s), J(R2s), J(t2s), J(x1s), J(x2s), J(masks), 4.0, 1.0, 200.0)
    X, ok, par = tpipe._triangulate_validated_batch(
        T(K), T(R1s), T(t1s), T(R2s), T(t2s), T(x1s), T(x2s), T(masks), 4.0, 1.0, 200.0)
    ok_ref = np.asarray(ok_ref)
    assert ok.shape == (4, 128) and ok_ref[:3].sum() > 200 and not ok[3].any()
    # a point at the edge of a gate may fall on either side of it
    assert (ok.numpy() == ok_ref).mean() >= 0.995
    both = ok.numpy() & ok_ref
    np.testing.assert_allclose(X.numpy()[both], np.asarray(X_ref)[both], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(par.numpy()[both], np.asarray(par_ref)[both], rtol=1e-3, atol=1e-3)
    # one pair without the leading axis: the same function
    X0, ok0, _ = tpipe._triangulate_validated(
        T(K), T(R1s[0]), T(t1s[0]), T(R2s[0]), T(t2s[0]), T(x1s[0]), T(x2s[0]), T(masks[0]),
        4.0, 1.0, 200.0)
    np.testing.assert_array_equal(ok0.numpy(), ok[0].numpy())


def test_reproj_errors_gather_matches_jax(rng):
    sc = make_scene(rng, n_points=200, n_cams=4, noise_px=0.5)
    cam = rng.integers(0, 4, 200)
    x = np.stack([sc["obs"][c][p] for p, c in enumerate(cam)]).astype(np.float32)
    X = sc["X"].astype(np.float32).copy()
    X[:3] = -sc["Rs"][cam[0]].T @ sc["ts"][cam[0]] - sc["Rs"][cam[0]].T @ np.array([0, 0, 1.0])
    cam[:3] = cam[0]                                    # three points behind their camera
    ref = jpipe._reproj_errors_gather(J(sc["K"]), J(sc["Rs"]), J(sc["ts"]), jnp.asarray(cam),
                                      J(X), J(x))
    got = tpipe._reproj_errors_gather(T(sc["K"]), T(sc["Rs"]), T(sc["ts"]),
                                      torch.from_numpy(cam), T(X), T(x))
    assert (got[:3] == 1e9).all() and float(got[3:].max()) < 5.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("use_essential", [True, False])
def test_init_candidates_batch_matches_jax(use_essential):
    """The batch of initial-pair candidates, with the JAX draws handed in:
    the same poses to 2e-3, the same validity for 99% of the points and
    the same parallax where both are valid; the padded pair has no valid
    point and no NaN."""
    K, rows = _pairs((5, 6, 7))
    Fs, x1s, x2s, masks = (np.stack([r[k] for r in rows]) for k in (1, 2, 3, 4))
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    R_ref, t_ref, ok_ref, par_ref = jpipe._init_candidates_batch(
        J(K), J(Fs), J(x1s), J(x2s), J(masks), 4.0, 200.0, keys=keys,
        use_essential=use_essential, essential_threshold_px=2.0, essential_hypotheses=128)
    draws = torch.stack([
        torch.from_numpy(np.array(jax_sample_indices(k, J(m), 128, 5))).long()
        for k, m in zip(keys, masks)])
    R, t, ok, par = tpipe._init_candidates_batch(
        T(K), T(Fs), T(x1s), T(x2s), T(masks), 4.0, 200.0, use_essential=use_essential,
        essential_threshold_px=2.0, essential_hypotheses=128, sample_indices=draws)
    assert R.shape == (4, 3, 3) and ok.shape == (4, 128)
    assert all(bool(torch.isfinite(v).all()) for v in (R, t, par)) and not ok[3].any()
    np.testing.assert_allclose(R[:3].numpy(), np.asarray(R_ref)[:3], atol=2e-3)
    np.testing.assert_allclose(t[:3].numpy(), np.asarray(t_ref)[:3], atol=2e-3)
    ok_ref = np.asarray(ok_ref)
    assert ok_ref[:3].sum() > 150 and (ok.numpy() == ok_ref).mean() >= 0.99
    both = ok.numpy() & ok_ref
    np.testing.assert_allclose(par.numpy()[both], np.asarray(par_ref)[both], rtol=2e-2, atol=2e-2)
    for b in range(3):
        sc = rows[b][0]
        assert rotation_angle_deg(R[b].numpy(), sc["Rs"][1] @ sc["Rs"][0].T) < 0.5


def test_point_store_grows_and_replaces():
    store = tpipe._PointStore(3, np.float32)
    for k in range(600):
        assert store.append((k, 0, 1)) == k
    assert len(store) == 600 and store.view().shape == (600, 3) and store.view()[599, 0] == 599
    store.replace(np.zeros((4, 3)))
    assert len(store) == 4 and store.append((1, 2, 3)) == 4
    store.replace(None)
    assert len(store) == 0 and tpipe._PointStore(3, np.uint8, data=[(1, 2, 3)]).view().dtype == np.uint8


# ---------------------------------------------------------------------------
# one registration wave and one triangulation from the reference's state


def _wave_draws(key, cands, num_hypotheses):
    """The samples the JAX _register_wave draws for a wave from the key
    that its _next_key() hands out: one key per padded image, split in
    three for the 6-, 3- and 8-point sets."""
    B = jpipe._pad_pow2(len(cands), lo=1, hi=1024)
    cap = jpipe._pad_pow2(max(len(k) for _, k, _ in cands))
    keys = jax.random.split(key, B)
    counts = pnp_hypothesis_counts(num_hypotheses)
    sets = [[], [], []]
    for b in range(B):
        valid = np.zeros(cap, np.float32)
        if b < len(cands):
            valid[: len(cands[b][1])] = 1.0
        for s, (k, n, size) in enumerate(zip(jax.random.split(keys[b], 3), counts, (6, 3, 8))):
            sets[s].append(np.array(jax_sample_indices(k, J(valid), n, size)))
    return [torch.from_numpy(np.stack(s)).long() for s in sets]


def test_wave_and_triangulation_from_the_reference_state(scene):
    """The reference runs through `initialize`; its state is carried into
    the port's pipeline (convert.sfm_state_from_numpy). Then both register
    one wave, the port with the JAX draws, and triangulate it: the same
    candidates, the same accepted image, poses within 1e-3, the same new
    links and the same number of new points (+-2 at the edge of a gate),
    at the same places."""
    ref = _jax_pipeline(scene)
    ref.extract_features()
    ref.match_image_pairs()
    pair = ref.find_best_initial_pair()
    assert pair is not None
    ref.initialize(pair)
    state = convert.sfm_state_to_numpy(ref)
    port = _port_pipeline(scene)
    convert.sfm_state_from_numpy(port, state)
    assert port.registered == set(pair) and len(port.points3d) == len(ref.points3d) > 30
    assert len(port._obs_log) == 2 * len(port.points3d) and len(port.features) == 5
    back = convert.sfm_state_to_numpy(port)
    assert back["corr"] == state["corr"] and back["observations"] == state["observations"]
    np.testing.assert_array_equal(back["obs_log"], state["obs_log"])
    # without the carried index, replaying the log rebuilds it
    replay = _port_pipeline(scene)
    convert.sfm_state_from_numpy(replay, {k: v for k, v in state.items()
                                          if k not in ("corr", "obs_log")})
    assert {i: dict(c) for i, c in replay.corr.items()} == state["corr"]

    cands_ref, cands = ref._wave_candidates()[:1], port._wave_candidates()[:1]
    assert cands[0][0] == cands_ref[0][0]
    np.testing.assert_array_equal(cands[0][1], cands_ref[0][1])
    np.testing.assert_array_equal(cands[0][2], cands_ref[0][2])
    _, wave_key = jax.random.split(ref._key)          # what ref._next_key() will return
    draws = _wave_draws(wave_key, cands_ref, ref.config.sfm.pnp_hypotheses)
    accepted_ref = ref._register_wave(cands_ref)
    accepted = port._register_wave(cands, sample_indices=draws)
    assert accepted == accepted_ref == [cands[0][0]]
    i = accepted[0]
    np.testing.assert_allclose(port.poses[i][0], ref.poses[i][0], atol=1e-3)
    np.testing.assert_allclose(port.poses[i][1], ref.poses[i][1], atol=1e-3)
    np.testing.assert_array_equal(port.kp_to_point[i], ref.kp_to_point[i])
    assert port.stats["register_detail_s"]["wave_shapes"] == \
        ref.stats["register_detail_s"]["wave_shapes"]

    port.poses[i] = ref.poses[i]                       # triangulate from one pose
    n_before = len(ref.points3d)
    new_ref = ref._triangulate_images(accepted_ref)
    new = port._triangulate_images(accepted)
    assert new_ref > 5 and abs(new - new_ref) <= 2
    if new == new_ref:
        np.testing.assert_allclose(port.points3d[n_before:], ref.points3d[n_before:],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(port.point_colors, ref.point_colors)
    assert abs(len(port._obs_log) - len(ref._obs_log)) <= 4
    assert abs(port._mean_reproj_error() - ref._mean_reproj_error()) < 0.05


# ---------------------------------------------------------------------------
# end to end, beside the JAX pipeline (tests/test_sfm_pipeline.py)


def test_both_register_all_cameras(both_results):
    ref, port, points, colors, poses = both_results
    assert len(ref.registered) == 5 and sorted(poses) == [0, 1, 2, 3, 4]
    assert len(points) > 100 and colors.shape == points.shape
    assert points.dtype == np.float32 and colors.dtype == np.uint8 and np.isfinite(points).all()
    assert port.stats["num_cameras"] == 5 and port.stats["num_points"] == len(points)
    # within a quarter of the reference's point count
    assert abs(len(points) - len(ref.points3d)) <= 0.25 * len(ref.points3d)
    for key in ("load_time", "extract_time", "match_time", "init_time", "incremental_time",
                "final_ba_time", "total_time", "incremental_breakdown_s", "register_detail_s",
                "ba_full_detail_s", "mean_reproj_px"):
        assert key in port.stats and key in ref.stats
    assert set(port.stats["incremental_breakdown_s"]) == set(ref.stats["incremental_breakdown_s"])


def test_reprojection_error_small_and_near_the_reference(both_results):
    """Below the 1.5 px of tests/test_sfm_pipeline.py in both, and the
    port's within a factor 1.5 of the reference's (other random draws, so
    other tracks)."""
    ref, port, *_ = both_results
    assert ref.stats["mean_reproj_px"] < 1.5 and port.stats["mean_reproj_px"] < 1.5
    assert port.stats["mean_reproj_px"] < 1.5 * ref.stats["mean_reproj_px"] + 0.05


def test_relative_rotations_match_ground_truth(scene, both_results):
    ref, port, points, colors, poses = both_results
    errs = []
    for a in range(5):
        for b in range(a + 1, 5):
            R_est = poses[b].R.numpy() @ poses[a].R.numpy().T
            errs.append(rotation_angle_deg(R_est, scene["Rs"][b] @ scene["Rs"][a].T))
    assert np.median(errs) < 1.0, f"median relative rotation error {np.median(errs):.2f} deg"


def test_camera_centers_similarity_aligned(scene, both_results):
    """Camera centres against the true ones up to a similarity: relative
    RMS below the 0.05 of tests/test_sfm_pipeline.py, and the aligned pose
    errors of the port within twice the reference's (plus 0.1 deg, 0.005)."""
    ref, port, points, colors, poses = both_results
    C_est = np.stack([poses[i].center.numpy() for i in range(5)])
    C_gt = np.stack([-scene["Rs"][i].T @ scene["ts"][i] for i in range(5)])
    mu_e, mu_g = C_est.mean(0), C_gt.mean(0)
    E, G = C_est - mu_e, C_gt - mu_g
    U, S, Vt = np.linalg.svd(E.T @ G)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    s = (S * np.diag(D)).sum() / (E ** 2).sum()
    aligned = s * E @ (U @ D @ Vt) + mu_g
    rms = np.sqrt(((aligned - C_gt) ** 2).sum(1).mean())
    assert rms / np.linalg.norm(G, axis=1).mean() < 0.05
    e_port, e_ref = pose_errors(port.poses, scene), pose_errors(ref.poses, scene)
    assert e_port["mean_rot_err_deg"] < 2 * e_ref["mean_rot_err_deg"] + 0.1
    assert e_port["mean_center_err"] < 2 * e_ref["mean_center_err"] + 0.005


def test_tracks_are_consistent_after_the_final_sweep(both_results):
    _, port, points, *_ = both_results
    assert len(port.observations) == len(points) and all(len(o) >= 2 for o in port.observations)
    for pid, obs in enumerate(port.observations):
        for cam, kp in obs:
            assert port.kp_to_point[cam][kp] == pid
    assert port._obs_generation == 1 and port.failed == set() and port.corr == {}
    # the log is rebuilt from the rewritten observations at the next BA
    port.bundle_adjustment_full(final=True)
    assert len(port._obs_log) == sum(len(o) for o in port.observations)
    assert port._obs_log_generation == port._obs_generation


def test_ply_output(both_results, tmp_path):
    _, port, points, colors, poses = both_results
    port.save_ply(str(tmp_path / "sparse.ply"))
    pts, cols = load_ply(str(tmp_path / "sparse.ply"))
    assert pts.shape[0] == len(points) and cols.shape == colors.shape
    port.save_cameras_ply(str(tmp_path / "cams.ply"))
    cpts, _ = load_ply(str(tmp_path / "cams.ply"))
    assert cpts.shape[0] == 2 * len(poses)


def _state_without(pipe, views, failed=()):
    """The reconstruction state of `pipe` with `views` unregistered again:
    their poses, observations and keypoint links taken out; the 2D-3D
    correspondence index and the observation log are rebuilt on load."""
    state = convert.sfm_state_to_numpy(pipe)
    state["registered"] = [i for i in state["registered"] if i not in views]
    state["poses"] = {i: p for i, p in state["poses"].items() if i not in views}
    state["observations"] = [[(c, k) for c, k in obs if c not in views]
                             for obs in state["observations"]]
    for v in views:
        state["kp_to_point"][v] = np.full_like(state["kp_to_point"][v], -1)
    del state["corr"], state["obs_log"]
    state["failed"] = list(failed)
    return state


def test_rescue_pass_matches_jax(scene, both_results):
    """_rescue_unregistered on the JAX and the port pipeline, each loaded
    with the JAX reconstruction less view 4: both rescue view 4 through the
    finer-scale re-match (2x upsampled extraction of the views in its
    window), with the rescued pose within 0.5 deg of the JAX one, and the
    re-match appends the new keypoints to the view tables in both."""
    ref, *_ = both_results
    state = _state_without(ref, {4})
    jp, tp = _jax_pipeline(scene), _port_pipeline(scene)
    for pipe in (jp, tp):
        convert.sfm_state_from_numpy(pipe, state)
    n_kp = [len(k) for k in tp.kp_xy]
    assert jp._rescue_unregistered() == 1 and jp.registered == {0, 1, 2, 3, 4}
    assert tp._rescue_unregistered() == 1 and tp.registered == {0, 1, 2, 3, 4}
    assert rotation_angle_deg(tp.poses[4][0], jp.poses[4][0]) < 0.5
    assert np.linalg.norm(tp.poses[4][1] - jp.poses[4][1]) < 0.05
    assert all(len(k) > n for k, n in zip(tp.kp_xy, n_kp))
    assert all(len(a) == len(b) for a, b in zip(tp.kp_to_point, tp.kp_xy))
    assert rotation_angle_deg(tp.poses[4][0], ref.poses[4][0]) < 0.5


def test_rescue_pass_returns_zero_where_it_does_not_run(scene, both_results):
    """Nothing to rescue, the flag off, or more views missing than
    rescue_max_images: both packages return 0 and leave the state alone."""
    ref, port, *_ = both_results
    assert port._rescue_unregistered() == 0 and ref._rescue_unregistered() == 0
    state = _state_without(ref, {3, 4})
    for make, cfg_cls in ((_jax_pipeline, JaxConfig), (_port_pipeline, ReconstructionConfig)):
        cfg = _config(cfg_cls)
        for sfm in (dataclasses.replace(cfg.sfm, rescue_unregistered=False),
                    dataclasses.replace(cfg.sfm, rescue_max_images=1)):
            pipe = make(scene)
            pipe.config = cfg.replace(sfm=sfm)
            convert.sfm_state_from_numpy(pipe, state)
            n_kp = [len(k) for k in pipe.kp_xy]
            assert pipe._rescue_unregistered() == 0
            assert pipe.registered == {0, 1, 2} and [len(k) for k in pipe.kp_xy] == n_kp


def test_failed_views_are_retried(scene, both_results):
    """try_recover_images on a state with a registered view taken out again:
    the view comes back through a wave of its own."""
    _, port, *_ = both_results
    state = convert.sfm_state_to_numpy(port)
    again = _port_pipeline(scene)
    state["registered"] = [i for i in state["registered"] if i != 2]
    state["poses"] = {i: p for i, p in state["poses"].items() if i != 2}
    state["observations"] = [[(c, k) for c, k in obs if c != 2] for obs in state["observations"]]
    state["kp_to_point"][2] = np.full_like(state["kp_to_point"][2], -1)
    del state["corr"], state["obs_log"]
    state["failed"] = [2]
    convert.sfm_state_from_numpy(again, state)
    assert len(again.corr[2]) >= 12 and again.find_next_image() is None   # failed views wait
    again.try_recover_images()
    assert again.registered == {0, 1, 2, 3, 4} and again.failed == set()
    assert rotation_angle_deg(again.poses[2][0], port.poses[2][0]) < 0.5
