"""PnP of the PyTorch port (ops/pnp.py and the PnP estimators of
ops/estimation.py) against the JAX package's on the CPU, and the outcome
tests of tests/test_ransac.py (PnP part) and tests/test_pnp_p3p.py run on
the port.

The same numpy inputs go through both; the RANSAC tests hand the port the
samples that the JAX function draws from its key (one 6-point, one 3-point
and one 8-point set). Poses from minimal samples go through eigh and svd,
whose last bits differ between the backends: they are held to 2e-3 (of
entries of size 1-10) unless a test states another tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.ops import estimation as jest
from recon3d_tpu.ops import pnp as jpnp
from recon3d_tpu.ops.ransac import sample_indices as jax_sample_indices
from recon3d_tpu_torch.ops import estimation as test_
from recon3d_tpu_torch.ops import pnp as tpnp
from tests.synthetic import make_scene, rotation_angle_deg

torch.set_num_threads(2)


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _rot(rng, scale=0.5):
    """Random rotation via axis-angle (Rodrigues)."""
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _samples(rng, n, count=1):
    """`count` noise-free samples of n points in front of a random camera:
    (X (count, n, 3), x_norm (count, n, 2), R (count, 3, 3), t (count, 3))."""
    Xs, xs, Rs, ts = [], [], [], []
    while len(Xs) < count:
        R = _rot(rng)
        t = rng.normal(size=3)
        t[2] = abs(t[2]) + 4.0
        X = rng.normal(size=(n, 3)) * 1.5
        Xc = X @ R.T + t
        if (Xc[:, 2] < 0.5).any():
            continue
        Xs.append(X), xs.append(Xc[:, :2] / Xc[:, 2:3]), Rs.append(R), ts.append(t)
    return (np.stack(Xs).astype(np.float32), np.stack(xs).astype(np.float32),
            np.stack(Rs), np.stack(ts))


def _pose_err(models, valid, R, t):
    """Least |R - R_true| + |t - t_true| over the valid models."""
    errs = [np.linalg.norm(m[:9].reshape(3, 3) - R) + np.linalg.norm(m[9:] - t)
            for m, v in zip(models, valid) if v]
    return min(errs) if errs else np.inf


def _jax_draws(key, valid, num_hypotheses, use_p3p=True):
    """The three sample sets that jpnp.pnp_ransac_multi draws from `key`."""
    counts = tpnp.pnp_hypothesis_counts(num_hypotheses, use_p3p)
    keys = jax.random.split(key, 3)
    return [None if n == 0 else
            torch.from_numpy(np.array(jax_sample_indices(k, J(valid), n, size))).long()
            for k, n, size in zip(keys, counts, (6, 3, 8))]


def _low_inlier_problem(rng, n=240, inlier_ratio=0.25):
    K = np.array([[400.0, 0, 160], [0, 400, 120], [0, 0, 1]], np.float32)
    R = _rot(rng, 0.4)
    t = rng.normal(size=3)
    t[2] = abs(t[2]) + 5.0
    n_in = int(n * inlier_ratio)
    X = np.zeros((n, 3), np.float32)
    x = np.zeros((n, 2), np.float32)
    count = 0
    while count < n_in:
        Xi = rng.normal(size=3) * 2.0
        Xc = R @ Xi + t
        if Xc[2] < 1.0:
            continue
        uv = K @ (Xc / Xc[2])
        if not (0 <= uv[0] < 320 and 0 <= uv[1] < 240):
            continue
        X[count] = Xi
        x[count] = uv[:2] + rng.normal(size=2) * 0.3
        count += 1
    for i in range(n_in, n):
        Xi = rng.normal(size=3) * 2.0
        Xi[2] = abs(Xi[2])
        X[i] = Xi
        x[i] = [rng.uniform(0, 320), rng.uniform(0, 240)]
    perm = rng.permutation(n)
    return K, R, t, X[perm], x[perm], n_in


# ---------------------------------------------------------------------------
# parity with the JAX functions


def test_unrolled_cholesky_solve_matches_jax(rng):
    from recon3d_tpu.ops import linalg as jlin
    from recon3d_tpu_torch.ops import linalg as tlin

    A = rng.standard_normal((32, 9, 6)).astype(np.float32)
    A = np.einsum("bki,bkj->bij", A, A) + 1e-3 * np.eye(6, dtype=np.float32)
    b = rng.standard_normal((32, 6)).astype(np.float32)
    ref = jlin._chol_solve_unrolled(jlin._cholesky_unrolled(J(A)), J(b))
    got = tlin._chol_solve_unrolled(tlin._cholesky_unrolled(T(A)), T(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, got.numpy()), b, atol=2e-3)
    # a pivot that is not positive is clamped: no NaN leaves the factor
    bad = A.copy()
    bad[0] = -np.eye(6)
    out = tlin._chol_solve_unrolled(tlin._cholesky_unrolled(T(bad)), T(b))
    assert torch.isfinite(out[1:]).all()


def test_quartic_roots_match_jax_and_numpy(rng):
    c = rng.normal(size=(5, 200)).astype(np.float32)
    c[0] = np.sign(c[0]) * (np.abs(c[0]) + 0.3)
    c[:, 0] = (0.0, 1.0, -2.0, 0.5, 0.1)          # a vanishing leading coefficient
    ref_r, ref_ok = jax.jit(jax.vmap(jpnp._quartic_roots))(*[J(ci) for ci in c])
    got_r, got_ok = tpnp._quartic_roots(*[T(ci) for ci in c])
    ref_ok = np.asarray(ref_ok)
    # a discriminant within rounding of zero may fall on either side
    assert (got_ok.numpy() == ref_ok).mean() >= 0.99
    both = ref_ok & got_ok.numpy()
    # near a double root the roots move with the last bits of the
    # discriminant: 99% within 2e-3, all within 5e-2
    err = np.abs(got_r.numpy() - np.asarray(ref_r))[both]
    assert (err < 2e-3).mean() >= 0.99 and err.max() < 5e-2
    assert not got_ok[0].any()
    for k in range(1, 21):
        got = np.sort(got_r[k].numpy()[got_ok[k].numpy()])
        true = np.roots(c[:, k].astype(np.float64))
        true = np.sort(true[np.abs(true.imag) < 1e-6].real)
        assert len(got) == len(true)
        if len(true):
            np.testing.assert_allclose(got, true, rtol=2e-3, atol=2e-3)


def test_p3p_matches_jax_and_recovers_pose(rng):
    X, xn, Rs, ts = _samples(rng, 3, count=30)
    ref_m, ref_ok = jax.jit(jax.vmap(jpnp.p3p_grunert))(J(X), J(xn))
    got_m, got_ok = tpnp.p3p_grunert(T(X), T(xn))                 # one batched call
    ref_m, ref_ok = np.asarray(ref_m), np.asarray(ref_ok)
    assert got_m.shape == (30, 4, 12) and got_ok.shape == (30, 4)
    assert (got_ok.numpy() == ref_ok).mean() >= 0.97
    both = ref_ok & got_ok.numpy()
    # 3-point poses amplify the last bits of the quartic's roots, and a
    # pose from a nearly double root is not determined at all: half of the
    # models within 1e-4, 90% within 5e-3
    err = np.abs(got_m.numpy() - ref_m).max(-1)[both]
    assert np.median(err) < 1e-4 and (err < 5e-3).mean() >= 0.9
    recovered = sum(_pose_err(got_m[k].numpy(), got_ok[k].numpy(), Rs[k], ts[k]) < 1e-2
                    for k in range(30))
    assert recovered >= 0.9 * 30 * 0.8
    # a degenerate triple (two equal points) has no valid model
    X[0, 1] = X[0, 0]
    assert not tpnp.p3p_grunert(T(X[0]), T(xn[0]))[1].any()


def test_epnp_matches_jax_and_recovers_pose(rng):
    X, xn, Rs, ts = _samples(rng, 8, count=20)
    ref_m, ref_ok = jax.jit(jax.vmap(jpnp.epnp))(J(X), J(xn))
    got_m, got_ok = tpnp.epnp(T(X), T(xn))
    assert got_m.shape == (20, 2, 12)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    # both candidates, through two eigh and a Procrustes svd each: 5e-3
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=5e-3)
    hits = 0
    for k in range(20):
        best = min(
            (rotation_angle_deg(m[:9].reshape(3, 3), Rs[k]) + np.linalg.norm(m[9:] - ts[k])
             for m, ok in zip(got_m[k].numpy(), got_ok[k].numpy()) if ok), default=1e9)
        hits += best < 0.5
    assert hits >= 15, hits
    # all points equal: not a sample
    same = np.repeat(X[0, :1], 8, axis=0)
    assert not tpnp.epnp(T(same), T(xn[0]))[1].any()


def test_epnp_wins_on_planar():
    """Planar scene with noise: the 6-point DLT's projection-matrix null
    space is rank-deficient there, EPnP's control points stay well-posed."""
    wins_ep, wins_dlt = 0, 0
    for trial in range(12):
        r = np.random.default_rng(200 + trial)
        R = _rot(r)
        t = r.normal(size=3)
        t[2] = abs(t[2]) + 5.0
        X = np.concatenate([r.uniform(-2, 2, size=(16, 2)), np.zeros((16, 1))], axis=1)
        Xc = X @ R.T + t
        if (Xc[:, 2] < 0.5).any():
            continue
        xn = Xc[:, :2] / Xc[:, 2:3] + r.normal(scale=5e-4, size=(16, 2))
        models, valid = tpnp.epnp(T(X), T(xn))
        e_ep = min((rotation_angle_deg(m[:9].reshape(3, 3), R)
                    for m, ok in zip(models.numpy(), valid.numpy()) if ok), default=180.0)
        R_d, _ = tpnp.pnp_dlt(T(X), T(xn), torch.ones(16))
        wins_ep += e_ep < 1.0
        wins_dlt += rotation_angle_deg(R_d.numpy(), R) < 1.0
    assert wins_ep >= 9, (wins_ep, wins_dlt)
    assert wins_dlt <= wins_ep - 3, (wins_ep, wins_dlt)


def test_pnp_dlt_matches_jax(rng):
    """Weighted DLT on 64 noisy points (rotation to 1e-4, translation to
    1e-3) and a batch of exact 6-point samples."""
    scene = make_scene(rng, n_points=64, n_cams=2, noise_px=0.5)
    Kinv = np.linalg.inv(scene["K"])
    xn = (np.concatenate([scene["obs"][1], np.ones((64, 1))], axis=1) @ Kinv.T)[:, :2]
    w = (rng.uniform(size=64) > 0.2).astype(np.float32)
    R_ref, t_ref = jax.jit(jpnp.pnp_dlt)(J(scene["X"]), J(xn), J(w))
    R, t = tpnp.pnp_dlt(T(scene["X"]), T(xn), T(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=1e-3)
    assert rotation_angle_deg(R.numpy(), scene["Rs"][1]) < 0.3

    X, x6, Rs, ts = _samples(rng, 6, count=16)
    R, t = tpnp.pnp_dlt(T(X), T(x6), torch.ones(16, 6))
    assert R.shape == (16, 3, 3) and t.shape == (16, 3)
    good = sum(rotation_angle_deg(R[k].numpy(), Rs[k]) < 0.5 for k in range(16))
    assert good >= 13


def test_project_residuals_batch_matches_jax(rng):
    scene = make_scene(rng, n_points=96, n_cams=2, noise_px=0.5)
    models = np.concatenate([
        np.stack([_rot(rng, 0.2) @ scene["Rs"][1] for _ in range(7)]).reshape(7, 9),
        scene["ts"][1] + rng.normal(scale=0.1, size=(7, 3))], axis=1).astype(np.float32)
    models[3, 9:] = (0.0, 0.0, -1e6)            # the dead model: every point behind it
    ref = jpnp.project_residuals_batch(J(scene["K"]), J(models), J(scene["X"]),
                                       J(scene["obs"][1]))
    got = tpnp.project_residuals_batch(T(scene["K"]), T(models), T(scene["X"]),
                                       T(scene["obs"][1]))
    assert got.shape == (7, 96) and (got[3] == 1e9).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)
    px = tpnp.project_points(T(scene["K"]), T(models[0, :9]).reshape(3, 3), T(models[0, 9:]),
                             T(scene["X"]))
    ref_px = jpnp.project_points(J(scene["K"]), J(models[0, :9]).reshape(3, 3), J(models[0, 9:]),
                                 J(scene["X"]))
    np.testing.assert_allclose(px.numpy(), np.asarray(ref_px), rtol=1e-5, atol=1e-3)


def test_refine_pose_gn_matches_jax(rng):
    """The written-out Jacobian against the JAX autodiff one through 10
    iterations: the same pose to 1e-5 (rotation) and 1e-4 (translation),
    with zero-weight rows and a point behind the camera among the data."""
    scene = make_scene(rng, n_points=128, n_cams=2, noise_px=0.2)
    w = np.ones(128, np.float32)
    w[:10] = 0.0
    X = scene["X"].astype(np.float32).copy()
    X[5] = -scene["Rs"][1].T @ scene["ts"][1]   # at the camera centre: depth 0, weight 0
    R0 = _rot(rng, 0.02) @ scene["Rs"][1]
    t0 = scene["ts"][1] + np.array([0.03, -0.02, 0.04])
    R_ref, t_ref = jax.jit(lambda *a: jpnp.refine_pose_gn(*a, iterations=10))(
        J(scene["K"]), J(R0), J(t0), J(X), J(scene["obs"][1]), J(w))
    R, t = tpnp.refine_pose_gn(T(scene["K"]), T(R0), T(t0), T(X), T(scene["obs"][1]), T(w),
                               iterations=10)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=1e-4)
    assert rotation_angle_deg(R.numpy(), scene["Rs"][1]) < 0.1
    # a batch of starting poses refines row by row like single calls
    R0b = np.stack([R0, scene["Rs"][1], _rot(rng, 0.01) @ scene["Rs"][1]])
    t0b = np.stack([t0, scene["ts"][1], scene["ts"][1]])
    Rb, tb = tpnp.refine_pose_gn(T(scene["K"]), T(R0b), T(t0b), T(X).expand(3, -1, -1),
                                 T(scene["obs"][1]).expand(3, -1, -1), T(w).expand(3, -1),
                                 iterations=10)
    np.testing.assert_allclose(Rb[0].numpy(), R.numpy(), atol=1e-6)


@pytest.mark.parametrize("use_p3p", [True, False])
def test_pnp_ransac_multi_matches_jax_given_its_draws(rng, use_p3p):
    """Same winning model and the same inlier masks at every threshold."""
    scene = make_scene(rng, n_points=256, n_cams=2, noise_px=0.5, outlier_frac=0.3)
    valid = np.ones(256, np.float32)
    valid[240:] = 0.0
    thr = np.array([4.0, 8.0, 12.0], np.float32)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda k: jpnp.pnp_ransac_multi(
        k, J(scene["K"]), J(scene["X"]), J(scene["obs"][1]), J(valid), J(thr),
        num_hypotheses=512, use_p3p=use_p3p))(key)
    got = tpnp.pnp_ransac_multi(
        None, T(scene["K"]), T(scene["X"]), T(scene["obs"][1]), T(valid), T(thr),
        num_hypotheses=512, use_p3p=use_p3p, sample_indices=_jax_draws(key, valid, 512, use_p3p))
    assert got.R.shape == (3, 3, 3) and got.inliers.shape == (3, 256)
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(ref.num_inliers))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    assert not got.inliers[:, 240:].any()


def test_pnp_hypothesis_pool_keeps_its_counts_and_order():
    assert tpnp.pnp_hypothesis_counts(2048) == (768, 256, 128)
    assert tpnp.pnp_hypothesis_counts(512) == (192, 64, 32)
    assert tpnp.pnp_hypothesis_counts(512, use_p3p=False) == (512, 0, 0)
    assert tpnp.pnp_hypothesis_counts(4) == (1, 1, 1)


def _wave_problem(rng):
    """The indexed wave of tests/test_pnp_p3p.py: 4 images (one of them
    all padding, as a padded wave has) over one point table."""
    B, cap, P = 4, 256, 512
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    P_table = np.concatenate([rng.normal(size=(P, 2)), rng.uniform(3, 8, size=(P, 1))],
                             axis=1).astype(np.float32)
    kp_flat = np.zeros((P * 2, 2), np.float32)
    pid_idx = np.full((B, cap), -1, np.int32)
    kp_idx = np.zeros((B, cap), np.int32)
    for b, n in enumerate([60, 120, 200, 0]):
        R, t = _rot(rng, 0.2), np.array([0.1 * b, -0.1, 0.5])
        pids = rng.choice(P, size=n, replace=False)
        kps = rng.choice(P * 2, size=n, replace=False)
        Xc = P_table[pids] @ R.T + t
        px = (Xc[:, :2] / Xc[:, 2:]) * 300 + np.array([160, 120]) + rng.normal(0, 0.4, (n, 2))
        px[: n // 4] = rng.uniform(0, 320, size=(n // 4, 2))
        kp_flat[kps] = px
        pid_idx[b, :n], kp_idx[b, :n] = pids, kps
    return K, P_table, kp_flat, pid_idx, kp_idx


def test_pnp_wave_indexed_matches_jax_given_its_draws(rng):
    """estimate_pose_pnp_wave_indexed over a padded wave: per image and
    threshold the same inlier masks and the same pose as the JAX wave."""
    K, P_table, kp_flat, pid_idx, kp_idx = _wave_problem(rng)
    thr = np.array([4.0, 8.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    ref = jest.estimate_pose_pnp_wave_indexed(
        keys, J(K), J(P_table), J(kp_flat), jnp.asarray(pid_idx), jnp.asarray(kp_idx), J(thr),
        num_hypotheses=512)
    valid = (pid_idx >= 0).astype(np.float32)
    per_image = [_jax_draws(k, v, 512) for k, v in zip(keys, valid)]
    draws = [torch.stack([d[s] for d in per_image]) for s in range(3)]
    args = (T(K), T(P_table), T(kp_flat), torch.from_numpy(pid_idx), torch.from_numpy(kp_idx),
            T(thr))
    got = test_.estimate_pose_pnp_wave_indexed(None, *args, num_hypotheses=512,
                                               sample_indices=draws)
    assert got.R.shape == (4, 2, 3, 3) and got.inliers.shape == (4, 2, 256)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(ref.num_inliers))
    np.testing.assert_allclose(got.R[:3].numpy(), np.asarray(ref.R)[:3], atol=1e-4)
    np.testing.assert_allclose(got.t[:3].numpy(), np.asarray(ref.t)[:3], atol=1e-3)
    assert (got.num_inliers[3] == 0).all()
    assert (got.num_inliers[:3, 0].numpy() >= 0.4 * np.array([60, 120, 200])).all()
    # the dense wave on the gathered operands is the same computation
    X = P_table[np.clip(pid_idx, 0, None)]
    x = kp_flat[np.clip(kp_idx, 0, None)]
    dense = test_.estimate_pose_pnp_wave(None, T(K), T(X), T(x), T(valid), T(thr),
                                         num_hypotheses=512, sample_indices=draws)
    np.testing.assert_array_equal(dense.inliers.numpy(), got.inliers.numpy())
    np.testing.assert_array_equal(dense.R.numpy(), got.R.numpy())
    # and with its own generator the wave finds the same poses
    own = test_.estimate_pose_pnp_wave_indexed(torch.Generator().manual_seed(3), *args,
                                               num_hypotheses=512)
    for b in range(3):
        assert rotation_angle_deg(own.R[b, 0].numpy(), got.R[b, 0].numpy()) < 0.3


# ---------------------------------------------------------------------------
# the outcome tests of tests/test_ransac.py and tests/test_pnp_p3p.py, on the port


def test_pnp_dlt_exact(rng):
    scene = make_scene(rng, n_points=64, n_cams=2)
    Kinv = np.linalg.inv(scene["K"])
    xh = np.concatenate([scene["obs"][1], np.ones((64, 1))], axis=1) @ Kinv.T
    R, t = tpnp.pnp_dlt(T(scene["X"]), T(xh[:, :2]), torch.ones(64))
    assert rotation_angle_deg(R.numpy(), scene["Rs"][1]) < 0.2
    np.testing.assert_allclose(t.numpy(), scene["ts"][1], atol=5e-2)


def test_pnp_ransac_with_outliers(rng):
    scene = make_scene(rng, n_points=256, n_cams=2, noise_px=0.5, outlier_frac=0.4)
    res = test_.estimate_pose_pnp(
        torch.Generator().manual_seed(2), T(scene["K"]), T(scene["X"]), T(scene["obs"][1]),
        torch.ones(256), threshold_px=4.0, num_hypotheses=1024)
    assert rotation_angle_deg(res.R.numpy(), scene["Rs"][1]) < 0.5
    np.testing.assert_allclose(res.t.numpy(), scene["ts"][1], atol=0.05)
    assert res.inliers.numpy()[scene["outliers"][1]].mean() < 0.05
    assert int(res.num_inliers) > 120


def test_gn_refinement_improves(rng):
    scene = make_scene(rng, n_points=128, n_cams=2, noise_px=0.2)
    K, X, x = T(scene["K"]), T(scene["X"]), T(scene["obs"][1])
    R0 = T(_rot(rng, 0.02) @ scene["Rs"][1])
    t0 = T(scene["ts"][1] + np.array([0.03, -0.02, 0.04]))

    def mean_err(R, t):
        return float(torch.linalg.norm(tpnp.project_points(K, R, t, X) - x, dim=1).mean())

    before = mean_err(R0, t0)
    R, t = tpnp.refine_pose_gn(K, R0, t0, X, x, torch.ones(128), iterations=10)
    assert mean_err(R, t) < before * 0.2
    assert rotation_angle_deg(R.numpy(), scene["Rs"][1]) < 0.1


def test_pnp_ransac_multi_threshold_cascade(rng):
    scene = make_scene(rng, n_points=256, n_cams=2, noise_px=0.5, outlier_frac=0.3)
    res = tpnp.pnp_ransac_multi(
        torch.Generator().manual_seed(5), T(scene["K"]), T(scene["X"]), T(scene["obs"][1]),
        torch.ones(256), torch.tensor([4.0, 8.0, 12.0]), num_hypotheses=1024)
    counts = res.num_inliers.numpy()
    assert counts.shape == (3,) and (np.diff(counts) >= 0).all(), counts
    for ti in range(3):
        assert rotation_angle_deg(res.R[ti].numpy(), scene["Rs"][1]) < 0.5
        np.testing.assert_allclose(res.t[ti].numpy(), scene["ts"][1], atol=0.05)


def test_pnp_ransac_low_inlier_ratio(rng):
    """At ~25% inliers the 6-point-DLT-only pool fails while the mixed
    pool's P3P part succeeds."""
    K, R, t, X, x, n_in = _low_inlier_problem(rng, inlier_ratio=0.25)
    thr = torch.tensor([3.0])
    args = (T(K), T(X), T(x), torch.ones(len(X)), thr)
    mixed = tpnp.pnp_ransac_multi(torch.Generator().manual_seed(11), *args,
                                  num_hypotheses=1024, use_p3p=True)
    assert int(mixed.num_inliers[0]) >= 0.8 * n_in
    assert rotation_angle_deg(mixed.R[0].numpy(), R) < 0.5
    np.testing.assert_allclose(mixed.t[0].numpy(), t, atol=0.05)
    dlt = tpnp.pnp_ransac_multi(torch.Generator().manual_seed(11), *args,
                                num_hypotheses=1024, use_p3p=False)
    assert (int(dlt.num_inliers[0]) < 0.8 * n_in
            or rotation_angle_deg(dlt.R[0].numpy(), R) > 0.5)


def test_pnp_ransac_high_inlier_unchanged(rng):
    K, R, t, X, x, n_in = _low_inlier_problem(rng, inlier_ratio=0.8)
    res = tpnp.pnp_ransac_multi(torch.Generator().manual_seed(0), T(K), T(X), T(x),
                                torch.ones(len(X)), torch.tensor([3.0]), num_hypotheses=512)
    assert int(res.num_inliers[0]) >= 0.9 * n_in
    assert rotation_angle_deg(res.R[0].numpy(), R) < 0.2
    np.testing.assert_allclose(res.t[0].numpy(), t, atol=0.02)
