"""Bundle adjustment of the PyTorch port (sfm/bundle.py) against the JAX
package's on the CPU, and the outcome tests of tests/test_bundle.py run on
the port.

The same numpy problem goes through both. Both sum the per-observation
blocks by a float32 cumsum and differences of it, and both run 24-200
steps of CG on them, so single steps agree to about 1e-4 of their size and
whole solves to the tolerances stated in each test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.config import BundleConfig as JBundleConfig
from recon3d_tpu.sfm import bundle as jba
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.config import BundleConfig
from recon3d_tpu_torch.sfm import bundle as tba
from tests.synthetic import make_scene, random_rotation, rotation_angle_deg

torch.set_num_threads(2)


def _perturbed_problem(rng, n_cams=4, n_points=120, noise_px=0.3,
                       pose_noise=0.01, point_noise=0.02):
    """The problem of tests/test_bundle.py, with the observation log and
    the keypoint table that bundle_adjust_log takes."""
    scene = make_scene(rng, n_points=n_points, n_cams=n_cams, noise_px=noise_px)
    poses = {}
    for i in range(n_cams):
        dR = random_rotation(rng, pose_noise) if i > 0 else np.eye(3)
        dt = rng.normal(scale=pose_noise, size=3) if i > 0 else np.zeros(3)
        poses[i] = ((dR @ scene["Rs"][i]).astype(np.float32),
                    (scene["ts"][i] + dt).astype(np.float32))
    points = (scene["X"] + rng.normal(scale=point_noise, size=scene["X"].shape)).astype(np.float32)
    kp_xy = [scene["obs"][c].astype(np.float32) for c in range(n_cams)]
    log = np.asarray([(p, c, p) for p in range(n_points) for c in range(n_cams)], np.int32)
    return scene, poses, points, log, kp_xy


def _kp_table(kp_xy):
    kp_off = np.zeros(len(kp_xy) + 1, np.int64)
    np.cumsum([len(k) for k in kp_xy], out=kp_off[1:])
    return np.concatenate([np.asarray(k, np.float32) for k in kp_xy]), kp_off


def _port(scene, poses, points, log, kp_xy, cfg, **kw):
    return tba.bundle_adjust_log(scene["K"], poses, points, log, _kp_table(kp_xy), cfg,
                                 device="cpu", **kw)


def _ba_data(scene, poses, points, log, kp_xy):
    """Point-major BAData of the problem as numpy arrays (the log above is
    point-major already), as tests/test_bundle.py builds it."""
    cam_ids = sorted(poses)
    C, P = len(cam_ids), len(points)
    oc, op = log[:, 1].astype(np.int64), log[:, 0].astype(np.int64)
    oxy = np.stack([kp_xy[c][k] for _, c, k in log]).astype(np.float32)
    cam_perm = np.argsort(oc, kind="stable")
    oc_sorted = oc[cam_perm]
    return dict(
        K=np.asarray(scene["K"], np.float32),
        R0=np.stack([poses[c][0] for c in cam_ids]),
        t0=np.stack([poses[c][1] for c in cam_ids]).astype(np.float32),
        X0=points, obs_cam=oc, obs_pt=op, obs_xy=oxy,
        obs_w=np.ones(len(oc), np.float32),
        pt_start=np.searchsorted(op, np.arange(P), side="left"),
        pt_end=np.searchsorted(op, np.arange(P), side="right"),
        cam_perm=cam_perm,
        cam_start=np.searchsorted(oc_sorted, np.arange(C), side="left"),
        cam_end=np.searchsorted(oc_sorted, np.arange(C), side="right"),
    )


def _jax_data(d):
    ints = ("obs_cam", "obs_pt", "pt_start", "pt_end", "cam_perm", "cam_start", "cam_end")
    return jba.BAData(**{k: jnp.asarray(v, jnp.int32 if k in ints else jnp.float32)
                         for k, v in d.items()})


def _torch_data(d):
    return tba.BAData(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()})


# ---------------------------------------------------------------------------
# parity with the JAX functions


def test_residuals_and_jacobian_blocks_match_jax(rng):
    """_residuals at a non-zero increment, and the written-out blocks of
    _per_obs_jacobians against the JAX autodiff ones, each observation to
    1e-4 of its own largest entry. One point sits at depth 5e-7 of camera 0
    (moved to the origin, so that float32 resolves that depth): the clamped
    side of the depth, where the derivative along z is zero."""
    d = _ba_data(*_perturbed_problem(rng, n_cams=3, n_points=40))
    d["obs_w"][5] = 0.0
    d["R0"][0], d["t0"][0] = np.eye(3, dtype=np.float32), 0.0
    d["X0"][7] = (1e-7, -2e-7, 5e-7)
    C, P = 3, 40
    xi = rng.normal(scale=0.01, size=(C, 6)).astype(np.float32)
    dX = rng.normal(scale=0.01, size=(P, 3)).astype(np.float32)
    rw = rng.uniform(0.5, 1.0, len(d["obs_w"])).astype(np.float32)
    jd, td = _jax_data(d), _torch_data(d)
    ref = jba._residuals(jba.BAParams(jnp.asarray(xi), jnp.asarray(dX)), jd, jnp.asarray(rw))
    got = tba._residuals(tba.BAParams(torch.from_numpy(xi), torch.from_numpy(dX)), td,
                         torch.from_numpy(rw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-2)

    zero = jba.BAParams(jnp.zeros((C, 6)), jnp.zeros((P, 3)))
    r_ref, Jc_ref, Jp_ref = jba._per_obs_jacobians(zero, jd, jnp.asarray(rw))
    r, Jc, Jp = tba._per_obs_jacobians(td, torch.from_numpy(rw))
    for got, ref in ((r, r_ref), (Jc, Jc_ref), (Jp, Jp_ref)):
        ref = np.asarray(ref).reshape(len(rw), -1)
        got = got.numpy().reshape(ref.shape)
        assert np.isfinite(got).all()
        assert (np.abs(got - ref).max(1) <= 1e-4 * np.abs(ref).max(1) + 1e-6).all()
    clamped = np.flatnonzero((d["obs_pt"] == 7) & (d["obs_cam"] == 0))[0]
    assert float(Jp[clamped, :, 2].abs().max()) == 0.0 and float(Jp[clamped, 0, 0]) > 1e8


def test_lm_step_matches_jax(rng):
    """One LM step on a small problem: the same costs to 1e-5 relative and
    the same candidate to 2e-3 of its size (200 CG steps in float32)."""
    d = _ba_data(*_perturbed_problem(rng, n_cams=3, n_points=24))
    C, P = 3, 24
    zero = jba.BAParams(jnp.zeros((C, 6)), jnp.zeros((P, 3)))
    ref, c0_ref, c1_ref = jba._lm_step(zero, _jax_data(d), jnp.float32(1e-3), jnp.float32(3.0),
                                       cg_iters=200)
    cand, c0, c1 = tba._lm_step(_torch_data(d), 1e-3, 3.0, cg_iters=200)
    assert abs(float(c0) - float(c0_ref)) <= 1e-5 * float(c0_ref)
    assert abs(float(c1) - float(c1_ref)) <= 1e-3 * float(c0_ref)
    assert float(c1) < float(c0)
    for got, want in ((cand.xi, ref.xi), (cand.dX, ref.dX)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 2e-3 * np.linalg.norm(want)
    np.testing.assert_array_equal(cand.xi[0].numpy(), np.zeros(6, np.float32))


def test_schur_step_matches_dense_solve(rng):
    """The port's Schur-reduced CG step equals the dense damped normal
    equations' solution (gauge rows deleted), with the dense Jacobian taken
    by JAX autodiff of the reference's residuals."""
    d = _ba_data(*_perturbed_problem(rng, n_cams=3, n_points=24))
    C, P, O = 3, 24, len(d["obs_w"])
    jd = _jax_data(d)
    cand, cost0, cost1 = tba._lm_step(_torch_data(d), 1e-3, 1e9, cg_iters=200)
    dx_schur = np.concatenate([cand.xi.numpy().reshape(-1), cand.dX.numpy().reshape(-1)])

    def res_flat(v):
        p = jba.BAParams(xi=v[: C * 6].reshape(C, 6), dX=v[C * 6:].reshape(P, 3))
        return jba._residuals(p, jd, jnp.ones(O))

    x0 = jnp.zeros(C * 6 + P * 3)
    J = np.asarray(jax.jacfwd(res_flat)(x0))
    r = np.asarray(res_flat(x0))
    H = J.T @ J
    g = J.T @ r
    A = H + np.diag(1e-3 * np.diag(H) + 1e-8)
    free = np.ones(C * 6 + P * 3, bool)
    free[:6] = False  # gauge: camera 0 fixed
    dx = np.zeros(C * 6 + P * 3)
    dx[free] = np.linalg.solve(A[np.ix_(free, free)], -g[free])
    assert np.linalg.norm(dx_schur - dx) / max(np.linalg.norm(dx), 1e-9) < 1e-3
    assert float(cost1) < float(cost0)


@pytest.mark.parametrize("motion_only", [False, True])
def test_bundle_adjust_log_matches_jax(rng, motion_only):
    """The whole solve: the same number of accepted iterations, poses to
    2e-4 (rotation entries) and 2e-3 (translations), points to 5e-3, rms
    to 1e-3 px. Scene size ~5 units; the solves take ~10 LM steps."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=5, n_points=150)
    kw = dict(max_iterations=10, motion_only=motion_only)
    ref_poses, ref_points, ref = jba.bundle_adjust_log(
        scene["K"], poses, points, log, _kp_table(kp_xy), JBundleConfig(**kw))
    new_poses, new_points, stats = _port(scene, poses, points, log, kp_xy, BundleConfig(**kw))
    assert stats["iterations"] == ref["iterations"] and stats["num_obs"] == ref["num_obs"]
    assert abs(stats["rms_before"] - ref["rms_before"]) < 1e-3
    assert abs(stats["rms_after"] - ref["rms_after"]) < 1e-3
    np.testing.assert_allclose(new_points, ref_points, atol=5e-3)
    for c in ref_poses:
        np.testing.assert_allclose(new_poses[c][0], ref_poses[c][0], atol=2e-4)
        np.testing.assert_allclose(new_poses[c][1], ref_poses[c][1], atol=2e-3)


def test_bundle_adjust_log_cached_tail_matches_jax(rng):
    """Two calls over a growing log with the device cache, as the pipeline
    makes them: the second call uploads only the tail in both packages and
    gives the same solve (tolerances of the test above)."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=5, n_points=150)
    kw = dict(max_iterations=10)
    n1 = len(log) - 120
    ref_cache, cache = {}, {}
    jba.bundle_adjust_log(scene["K"], poses, points, log[:n1], _kp_table(kp_xy),
                          JBundleConfig(**kw), device_cache=ref_cache)
    _port(scene, poses, points, log[:n1], kp_xy, BundleConfig(**kw), device_cache=cache)
    ref_poses, ref_points, ref = jba.bundle_adjust_log(
        scene["K"], poses, points, log, _kp_table(kp_xy), JBundleConfig(**kw),
        device_cache=ref_cache)
    new_poses, new_points, stats = _port(scene, poses, points, log, kp_xy, BundleConfig(**kw),
                                         device_cache=cache)
    assert cache["log"]["count"] == ref_cache["log"]["count"] == len(log)
    assert cache["log"]["cap"] == ref_cache["log"]["cap"]
    assert stats["iterations"] == ref["iterations"] and stats["num_obs"] == ref["num_obs"]
    assert abs(stats["rms_after"] - ref["rms_after"]) < 1e-3
    np.testing.assert_allclose(new_points, ref_points, atol=5e-3)
    for c in ref_poses:
        np.testing.assert_allclose(new_poses[c][0], ref_poses[c][0], atol=2e-4)
        np.testing.assert_allclose(new_poses[c][1], ref_poses[c][1], atol=2e-3)


def test_ba_problem_from_numpy_builds_the_log_problem(rng):
    """convert.ba_problem_from_numpy carries a problem stated in numpy (as
    np.asarray of the JAX pipeline's state) into bundle_adjust_log's
    arguments."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=4, n_points=60)
    args = convert.ba_problem_from_numpy(
        scene["K"], np.stack([poses[c][0] for c in poses]),
        np.stack([poses[c][1] for c in poses]), points.astype(np.float64), log.astype(np.int64),
        _kp_table(kp_xy), cam_ids=list(poses))
    new_poses, new_points, stats = tba.bundle_adjust_log(
        *args, BundleConfig(max_iterations=8), device="cpu")
    ref_poses, ref_points, ref = _port(scene, poses, points, log, kp_xy,
                                       BundleConfig(max_iterations=8))
    assert stats["iterations"] == ref["iterations"]
    np.testing.assert_array_equal(new_points, ref_points)
    with pytest.raises(ValueError):
        convert.ba_problem_from_numpy(scene["K"], np.zeros((2, 3, 3)), np.zeros((3, 3)),
                                      points, log, _kp_table(kp_xy))


# ---------------------------------------------------------------------------
# the outcome tests of tests/test_bundle.py, on the port


def test_ba_reduces_error(rng):
    scene, poses, points, log, kp_xy = _perturbed_problem(rng)
    new_poses, new_points, stats = _port(scene, poses, points, log, kp_xy,
                                         BundleConfig(max_iterations=15))
    assert stats["rms_after"] < 0.5, stats
    assert stats["rms_after"] < stats["rms_before"] * 0.2
    # camera 0 is the gauge anchor: unchanged
    np.testing.assert_allclose(new_poses[0][0], poses[0][0], atol=1e-6)
    for i in range(1, 4):
        assert rotation_angle_deg(new_poses[i][0], scene["Rs"][i]) < 0.3


def test_ba_motion_only_keeps_points(rng):
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, point_noise=0.0)
    new_poses, new_points, stats = _port(
        scene, poses, points, log, kp_xy, BundleConfig(max_iterations=8, motion_only=True))
    np.testing.assert_allclose(new_points, points, atol=1e-6)
    assert stats["rms_after"] < stats["rms_before"]


def test_ba_robust_to_outliers(rng):
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, noise_px=0.2)
    bad = rng.choice(len(points), size=len(points) // 10, replace=False)
    kp_xy[2] = kp_xy[2].copy()
    kp_xy[2][bad] += rng.uniform(30, 80, size=(len(bad), 2)).astype(np.float32)
    new_poses, new_points, stats = _port(
        scene, poses, points, log, kp_xy, BundleConfig(max_iterations=15, robust_delta_px=2.0))
    for i in range(1, 4):
        assert rotation_angle_deg(new_poses[i][0], scene["Rs"][i]) < 0.5


def test_cpu_table_takes_the_plain_version_and_builds_no_kernel(rng, monkeypatch):
    """A bundle adjustment on the CPU runs every LM step on the plain
    version: csrc/bundle.cu is neither built nor loaded, no kernel is
    launched and no `ba.kernel_steps` is counted."""
    from recon3d_tpu_torch.kernels import bundle as bundle_kernels
    from recon3d_tpu_torch.runtime.profiling import span

    def refuse(*args, **kwargs):
        raise AssertionError("csrc/bundle.cu built for a CPU table")

    monkeypatch.setattr(bundle_kernels, "build", refuse)
    built = sorted(bundle_kernels.SOURCE.parents[1].joinpath("_build").glob("libbundle_*"))
    k0 = bundle_kernels.counts.kernel
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=3, n_points=40)
    with span("test.ba") as sp:
        _, _, stats = _port(scene, poses, points, log, kp_xy, BundleConfig(max_iterations=3))
    steps = sp.trace.counters["ba.lm_steps"]
    assert stats["iterations"] >= 1 and steps >= 1 and bundle_kernels.counts.kernel == k0
    assert "ba.kernel_steps" not in sp.trace.counters and bundle_kernels._lib is None
    assert sorted(bundle_kernels.SOURCE.parents[1].joinpath("_build").glob("libbundle_*")) == built


def test_ba_small_problems_return_unchanged(rng):
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=2, n_points=6)
    new_poses, new_points, stats = _port(scene, poses, points, log, kp_xy, BundleConfig())
    assert stats == {"iterations": 0} and new_points is points and new_poses is poses


def test_ba_log_arrival_order_and_foreign_rows(rng):
    """The log in arrival order (shuffled), with rows of an unposed camera,
    of a point beyond the padded table (256 rows) and of a negative point
    id: the device-side reorder gives the
    point-major solve's result (same sums in the same order up to the
    order of a point's rows), and the foreign rows are not used."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=5, n_points=150)
    cfg = BundleConfig(max_iterations=10)
    ref_poses, ref_points, ref = _port(scene, poses, points, log, kp_xy, cfg)
    shuffled = log[rng.permutation(len(log))]
    foreign = np.asarray([(3, 7, 0), (300, 1, 2), (-1, 1, 0)], np.int32)
    kp_xy = kp_xy + [kp_xy[0]] * 3    # cameras 5-7 have keypoints but no pose
    got_poses, got_points, got = _port(scene, poses, points,
                                       np.concatenate([shuffled[:200], foreign, shuffled[200:]]),
                                       kp_xy, cfg)
    assert got["num_obs"] == ref["num_obs"] == len(log)
    assert abs(got["rms_after"] - ref["rms_after"]) < 1e-3
    np.testing.assert_allclose(got_points, ref_points, atol=2e-3)
    for c in ref_poses:
        np.testing.assert_allclose(got_poses[c][0], ref_poses[c][0], atol=1e-4)


def test_ba_log_incremental_cache(rng):
    """The tail-only upload (cache hit, appended rows) and the fall-through
    of a log that shrank below the cached count both give the result of a
    cold full upload."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=5, n_points=150)
    cfg = BundleConfig(max_iterations=10)
    cache = {}
    n1 = len(log) - 120
    _port(scene, poses, points, log[:n1], kp_xy, cfg, device_cache=cache)
    assert cache["log"]["count"] == n1
    first = cache["log"]["cam"]
    p2, x2, s2 = _port(scene, poses, points, log, kp_xy, cfg, device_cache=cache)
    assert cache["log"]["count"] == len(log) and cache["log"]["cam"] is first
    p_ref, x_ref, s_ref = _port(scene, poses, points, log, kp_xy, cfg)
    np.testing.assert_allclose(x2, x_ref, atol=1e-6)
    for c in p_ref:
        np.testing.assert_allclose(p2[c][0], p_ref[c][0], atol=1e-7)
        np.testing.assert_allclose(p2[c][1], p_ref[c][1], atol=1e-7)
    short = log[: n1 - 60]
    p3, x3, s3 = _port(scene, poses, points, short, kp_xy, cfg, device_cache=cache)
    assert cache["log"]["count"] == len(short) and cache["log"]["cam"] is not first
    p3r, x3r, s3r = _port(scene, poses, points, short, kp_xy, cfg)
    np.testing.assert_allclose(x3, x3r, atol=1e-6)


def test_lm_loop_counts_accepted_steps_and_ends_on_rejections(rng):
    """`it` counts accepted steps only; from the optimum every step is
    rejected, the damping grows fourfold a step and the loop ends through
    the damping bound, not through max_iters."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=3, n_points=30)
    new_poses, new_points, stats = _port(scene, poses, points, log, kp_xy,
                                         BundleConfig(max_iterations=20))
    assert 1 <= stats["iterations"] <= 20
    again_poses, again_points, again = _port(scene, new_poses, new_points, log, kp_xy,
                                             BundleConfig(max_iterations=20))
    assert again["iterations"] <= 3
    assert again["rms_after"] <= stats["rms_after"] + 1e-4
    capped = _port(scene, poses, points, log, kp_xy, BundleConfig(max_iterations=20),
                   max_iterations=2)[2]
    assert capped["iterations"] == 2


# ---------------------------------------------------------------------------
# the list-based entry, bundle_adjust


def _obs_lists(log, n_points):
    """Per-point observation lists [(cam, kp), ...] of a point-major log."""
    obs = [[] for _ in range(n_points)]
    for p, c, k in log.tolist():
        obs[p].append((c, k))
    return obs


@pytest.mark.parametrize("motion_only", [False, True])
def test_bundle_adjust_matches_jax_and_the_log_entry(rng, motion_only):
    """The port's bundle_adjust against the JAX bundle_adjust on the same
    lists: the same accepted iterations, rms before and after to 1e-4 px,
    poses to 1e-4, points to 1e-3; and against the port's own
    bundle_adjust_log on the same problem, which builds the same table on
    the device: equal to 1e-6."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng, n_cams=5, n_points=150)
    obs = _obs_lists(log, len(points))
    kw = dict(max_iterations=10, motion_only=motion_only)
    ref_poses, ref_points, ref = jba.bundle_adjust(scene["K"], poses, points, obs, kp_xy,
                                                   JBundleConfig(**kw))
    new_poses, new_points, stats = tba.bundle_adjust(scene["K"], poses, points, obs, kp_xy,
                                                     BundleConfig(**kw), device="cpu")
    assert stats["iterations"] == ref["iterations"] and stats["num_obs"] == ref["num_obs"]
    assert abs(stats["rms_before"] - ref["rms_before"]) < 1e-4
    assert abs(stats["rms_after"] - ref["rms_after"]) < 1e-4
    np.testing.assert_allclose(new_points, ref_points, atol=1e-3)
    for c in ref_poses:
        np.testing.assert_allclose(new_poses[c][0], ref_poses[c][0], atol=1e-4)
        np.testing.assert_allclose(new_poses[c][1], ref_poses[c][1], atol=1e-4)
    log_poses, log_points, s_log = _port(scene, poses, points, log, kp_xy, BundleConfig(**kw))
    assert s_log["iterations"] == stats["iterations"]
    for k in ("rms_before", "rms_after"):
        assert abs(s_log[k] - stats[k]) < 1e-6
    np.testing.assert_allclose(log_points, new_points, atol=1e-6)
    for c in log_poses:
        np.testing.assert_allclose(log_poses[c][0], new_poses[c][0], atol=1e-6)
        np.testing.assert_allclose(log_poses[c][1], new_poses[c][1], atol=1e-6)


def test_bundle_adjust_outcomes(rng):
    """tests/test_bundle.py's outcome tests on the list entry: error
    reduced below 0.5 px, camera 0 fixed, rotations to 0.3 deg; with 10% of
    one camera's observations corrupted and Huber at 2 px, rotations to
    0.5 deg; observations of a camera absent from `poses` are dropped, a
    keypoint id out of range raises, and too small a problem returns as it
    came."""
    scene, poses, points, log, kp_xy = _perturbed_problem(rng)
    obs = _obs_lists(log, len(points))
    new_poses, _, stats = tba.bundle_adjust(scene["K"], poses, points, obs, kp_xy,
                                            BundleConfig(max_iterations=15), device="cpu")
    assert stats["rms_after"] < 0.5 and stats["rms_after"] < stats["rms_before"] * 0.2
    np.testing.assert_allclose(new_poses[0][0], poses[0][0], atol=1e-6)
    for i in range(1, 4):
        assert rotation_angle_deg(new_poses[i][0], scene["Rs"][i]) < 0.3

    bad = rng.choice(len(points), size=len(points) // 10, replace=False)
    noisy = [k.copy() for k in kp_xy]
    noisy[2][bad] += rng.uniform(30, 80, size=(len(bad), 2))
    new_poses, _, _ = tba.bundle_adjust(scene["K"], poses, points, obs, noisy,
                                        BundleConfig(max_iterations=15, robust_delta_px=2.0),
                                        device="cpu")
    for i in range(1, 4):
        assert rotation_angle_deg(new_poses[i][0], scene["Rs"][i]) < 0.5

    three = {c: poses[c] for c in (0, 1, 2)}
    _, _, s3 = tba.bundle_adjust(scene["K"], three, points, obs, kp_xy,
                                 BundleConfig(max_iterations=3), device="cpu")
    assert s3["num_obs"] == 3 * len(points)
    with pytest.raises(ValueError, match="out of range"):
        tba.bundle_adjust(scene["K"], poses, points, [[(0, 10_000)]] + obs[1:], kp_xy,
                          device="cpu")
    same_poses, same_points, s0 = tba.bundle_adjust(scene["K"], {0: poses[0]}, points, obs,
                                                    kp_xy, device="cpu")
    assert s0 == {"iterations": 0} and same_points is points
