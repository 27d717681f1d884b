"""The 5-point essential solver and the essential RANSAC of the PyTorch
port (ops/essential5.py, ops/estimation.py) against the JAX package's on
the CPU, and the essential outcome tests of tests/test_ransac.py run on the
port.

The same numpy inputs go through both; the RANSAC tests hand the port the
5-point samples that the JAX function draws from its key. The solver's
candidates are compared as sets up to sign: the port spans the null space
by another orthonormal basis than the JAX function's QR, so the same E's
come out of another degree-10 polynomial, in other slots.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.ops import epipolar as jepi
from recon3d_tpu.ops import essential5 as je5
from recon3d_tpu.ops import estimation as jest
from recon3d_tpu.ops import lie as jlie
from recon3d_tpu.ops.ransac import sample_indices as jax_sample_indices
from recon3d_tpu_torch.ops import epipolar as tepi
from recon3d_tpu_torch.ops import essential5 as te5
from recon3d_tpu_torch.ops import estimation as test_
from recon3d_tpu_torch.ops import lie as tlie
from recon3d_tpu_torch.ops import linalg as tlin
from tests.synthetic import make_scene, rotation_angle_deg

torch.set_num_threads(2)


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _draws(key, valid, num_hypotheses, size):
    return torch.from_numpy(np.array(jax_sample_indices(key, J(valid), num_hypotheses, size))).long()


def _five_point_samples(rng, count):
    """`count` exact 5-point samples in normalized coordinates under one
    relative pose: (x1n, x2n (count, 5, 2), E_true (3, 3) of unit norm)."""
    R = np.asarray(jlie.so3_exp(J([0.05, -0.1, 0.02])), np.float64)
    t = np.array([0.5, 0.1, -0.05])
    X = np.concatenate([rng.uniform(-1.5, 1.5, (count, 5, 2)),
                        rng.uniform(2.0, 4.5, (count, 5, 1))], axis=-1)
    Xc = X @ R.T + t
    E = np.cross(np.eye(3), t) @ R
    return ((X[..., :2] / X[..., 2:]).astype(np.float32),
            (Xc[..., :2] / Xc[..., 2:]).astype(np.float32), E / np.linalg.norm(E))


def _set_distance(a, b):
    """(len(a), len(b)) max-entry distances between E's up to sign."""
    a = a.reshape(-1, 1, 9)
    b = b.reshape(1, -1, 9)
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def _constraint_residual(E, x1n, x2n):
    """Largest violation by unit-norm E's (n, 3, 3) of the 5 epipolar and
    the 9 trace constraints."""
    E = E.astype(np.float64)
    h = lambda x: np.concatenate([x, np.ones((5, 1))], axis=1)
    epi = np.abs(np.einsum("ni,kij,nj->kn", h(x2n), E, h(x1n))).max(-1)
    EEt = E @ np.swapaxes(E, -1, -2)
    tr = np.abs(2 * EEt @ E - np.trace(EEt, axis1=-2, axis2=-1)[:, None, None] * E).max((-1, -2))
    return np.maximum(epi, tr)


# ---------------------------------------------------------------------------
# parity with the JAX functions


def test_so3_exp_jacobian_matches_jax_autodiff():
    for w in ([0.0, 0.0, 0.0], [1e-5, 2e-5, 0.0], [0.1, -0.2, 0.3], [1.0, 2.0, -0.5]):
        ref = np.moveaxis(np.asarray(jax.jacfwd(jlie.so3_exp)(J(w))), -1, 0)
        got = tlie.so3_exp_jacobian(T(w))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    batch = tlie.so3_exp_jacobian(T([[0.1, -0.2, 0.3], [0.0, 0.0, 0.0]]))
    assert batch.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(batch[0].numpy(), got.numpy() * 0 + tlie.so3_exp_jacobian(
        T([0.1, -0.2, 0.3])).numpy(), atol=0)


def test_null_space_rows_matches_the_complete_qr(rng):
    x1n, x2n, _ = _five_point_samples(rng, 64)
    Q = te5._epipolar_rows(T(x1n), T(x2n))
    B = tlin.null_space_rows(Q)
    assert B.shape == (64, 4, 9)
    np.testing.assert_allclose((B @ B.transpose(-1, -2)).numpy(),
                               torch.eye(4).expand(64, 4, 4).numpy(), atol=2e-6)
    assert float((Q @ B.transpose(-1, -2)).abs().max()) <= 5e-7 * float(Q.abs().max())
    # LAPACK's complete QR of Q^T, in float64: the same basis vectors
    qf, _ = np.linalg.qr(np.swapaxes(Q.numpy().astype(np.float64), -1, -2), mode="complete")
    np.testing.assert_allclose(B.numpy(), np.swapaxes(qf[:, :, 5:], -1, -2), atol=1e-5)


def test_nister_5point_candidate_sets_match_jax(rng):
    """20 candidates a sample in both. The true E is among the port's
    valid candidates (to 1e-3 of its unit norm) for as many samples as
    among the JAX function's, less 2 of 96 at most; of the JAX function's
    valid candidates that satisfy the constraints to 1e-3, at least 95%
    have a port candidate within 1e-2, and the reverse. (A candidate from
    a badly converged root passes the solver's loose gate in one package
    and not in the other: those are the rest.)"""
    x1n, x2n, E_true = _five_point_samples(rng, 96)
    ref_E, ref_ok = jax.jit(jax.vmap(je5.nister_5point))(J(x1n), J(x2n))
    got_E, got_ok = te5.nister_5point(T(x1n), T(x2n))
    assert got_E.shape == (96, 20, 3, 3) and got_ok.shape == (96, 20)
    ref_E, ref_ok, got_E, got_ok = np.asarray(ref_E), np.asarray(ref_ok), got_E.numpy(), got_ok.numpy()
    np.testing.assert_allclose(np.linalg.norm(got_E.reshape(96, 20, 9), axis=-1), 1.0, atol=1e-5)
    dead = got_E[~got_ok]
    assert (dead == np.array([[0, 0, 0], [0, 0, 0], [0, 0, 1]], np.float32)).all()

    found_true = found_true_ref = matched = total = matched_back = total_back = 0
    for s in range(96):
        if got_ok[s].any():
            found_true += _set_distance(E_true[None], got_E[s][got_ok[s]]).min() < 1e-3
        if ref_ok[s].any():
            found_true_ref += _set_distance(E_true[None], ref_E[s][ref_ok[s]]).min() < 1e-3
        good_ref = ref_E[s][ref_ok[s]]
        good_ref = good_ref[_constraint_residual(good_ref, x1n[s], x2n[s]) < 1e-3]
        good_got = got_E[s][got_ok[s]]
        good_got = good_got[_constraint_residual(good_got, x1n[s], x2n[s]) < 1e-3]
        if len(good_ref) and got_ok[s].any():
            matched += (_set_distance(good_ref, got_E[s][got_ok[s]]).min(1) < 1e-2).sum()
        total += len(good_ref)
        if len(good_got) and ref_ok[s].any():
            matched_back += (_set_distance(good_got, ref_E[s][ref_ok[s]]).min(1) < 1e-2).sum()
        total_back += len(good_got)
    assert found_true_ref >= 80 and found_true >= found_true_ref - 2, (found_true, found_true_ref)
    assert total >= 300 and matched >= 0.95 * total, (matched, total)
    assert total_back >= 300 and matched_back >= 0.95 * total_back, (matched_back, total_back)


def test_nister_5point_degenerate_samples_give_no_nan(rng):
    """Five equal points (what a padded pair's samples are) and a sample
    with NaN: every candidate is finite, the NaN sample has no valid one."""
    x = np.zeros((2, 5, 2), np.float32)
    x[1, 0, 0] = np.nan
    E, ok = te5.nister_5point(T(x), T(x))
    assert torch.isfinite(E).all() and not ok[1].any()


def test_refine_essential_manifold_matches_jax(rng):
    """The written-out Jacobian against jax.jacobian through 12 LM rounds:
    the same E up to sign to 1e-4 of its unit norm."""
    scene = make_scene(rng, n_points=128, n_cams=2, noise_px=0.5, outlier_frac=0.2)
    K = scene["K"].astype(np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    R_rel = scene["Rs"][1] @ scene["Rs"][0].T
    t_rel = scene["ts"][1] - R_rel @ scene["ts"][0]
    R0 = np.asarray(jlie.so3_exp(J([0.01, -0.015, 0.005]))) @ R_rel
    E0 = np.cross(np.eye(3), t_rel / np.linalg.norm(t_rel)) @ R0
    E0 = (E0 / np.linalg.norm(E0)).astype(np.float32)
    valid = np.ones(128, bool)
    valid[120:] = False
    w = (valid & ~(scene["outliers"][0] | scene["outliers"][1])).astype(np.float32)
    x1, x2 = scene["obs"][0].astype(np.float32), scene["obs"][1].astype(np.float32)
    ref = jax.jit(lambda *a: jest._refine_essential_manifold(*a, 2.0))(
        J(E0), J(K), J(Kinv.T), J(Kinv), J(x1), J(x2), J(w), jnp.asarray(valid))
    got = test_._refine_essential_manifold(
        T(E0), T(K), T(Kinv.T), T(Kinv), T(x1), T(x2), T(w), torch.from_numpy(valid), 2.0)
    ref = np.asarray(ref)
    assert min(np.abs(got.numpy() - ref).max(), np.abs(got.numpy() + ref).max()) < 1e-4
    assert min(np.abs(ref - E0).max(), np.abs(ref + E0).max()) > 1e-3     # it moved
    # sampson distance with its derivative: the value is sampson_distance
    F = Kinv.T @ E0 @ Kinv
    r, dr = test_._sampson_with_jacobian(T(F), T(x1), T(x2))
    np.testing.assert_allclose(r.numpy(), np.asarray(jepi.sampson_distance(J(F), J(x1), J(x2))),
                               rtol=1e-4, atol=1e-4)
    ref_dr = jax.jacfwd(lambda f: jepi.sampson_distance(f, J(x1), J(x2)))(J(F))
    np.testing.assert_allclose(dr.numpy(), np.asarray(ref_dr), rtol=2e-3,
                               atol=2e-3 * float(np.abs(np.asarray(ref_dr)).max()))


def test_recover_pose_takes_a_batch_of_pairs(rng):
    scenes = [make_scene(np.random.default_rng(s), n_points=64, n_cams=2) for s in (1, 2, 3)]
    K = scenes[0]["K"].astype(np.float32)
    Es, x1s, x2s = [], [], []
    for sc in scenes:
        R_rel = sc["Rs"][1] @ sc["Rs"][0].T
        t_rel = sc["ts"][1] - R_rel @ sc["ts"][0]
        Es.append(np.cross(np.eye(3), t_rel) @ R_rel)
        x1s.append(sc["obs"][0]), x2s.append(sc["obs"][1])
    mask = np.ones((3, 64), np.float32)
    mask[2] = 0.0                                   # a padded pair
    R, t, front = tepi.recover_pose(T(np.stack(Es)), T(np.stack(x1s)), T(np.stack(x2s)), T(K),
                                    T(mask))
    assert R.shape == (3, 3, 3) and t.shape == (3, 3) and front.shape == (3, 64)
    for b in range(2):
        R1, t1, f1 = jepi.recover_pose(J(Es[b]), J(x1s[b]), J(x2s[b]), J(K), J(mask[b]))
        np.testing.assert_allclose(R[b].numpy(), np.asarray(R1), atol=1e-4)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(t1), atol=1e-4)
        np.testing.assert_array_equal(front[b].numpy(), np.asarray(f1))
    assert not front[2].any() and torch.isfinite(R[2]).all()


def _essential_problem(seed, n_points, noise_px=1.0, outlier_frac=0.25):
    scene = make_scene(np.random.default_rng(100 + seed), n_points=n_points, n_cams=2,
                       noise_px=noise_px, outlier_frac=outlier_frac)
    return (scene, scene["K"].astype(np.float32), scene["obs"][0].astype(np.float32),
            scene["obs"][1].astype(np.float32), scene["Rs"][1] @ scene["Rs"][0].T)


def test_estimate_essential_ransac_matches_jax_given_its_draws(rng):
    """The same E up to sign (1e-3 of its unit norm) and the same inlier
    mask, on a pair and on a batch of pairs with a padded one."""
    problems = [_essential_problem(seed, 96, noise_px=0.5) for seed in (0, 1)]
    valid = np.ones(96, np.float32)
    valid[90:] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    draws, refs = [], []
    for key, (_, K, x1, x2, _) in zip(keys, problems):
        refs.append(jest.estimate_essential_ransac(key, J(K), J(x1), J(x2), J(valid),
                                                   threshold_px=2.0, num_hypotheses=128))
        draws.append(_draws(key, valid, 128, 5))
    K = problems[0][1]
    x1 = np.stack([p[2] for p in problems] + [np.zeros((96, 2), np.float32)])
    x2 = np.stack([p[3] for p in problems] + [np.zeros((96, 2), np.float32)])
    valid_b = np.stack([valid, valid, np.zeros(96, np.float32)])
    idx = torch.stack(draws + [torch.zeros_like(draws[0])])
    got = test_.estimate_essential_ransac(None, T(K), T(x1), T(x2), T(valid_b), threshold_px=2.0,
                                          num_hypotheses=128, sample_indices=idx)
    assert got.E.shape == (3, 3, 3) and got.inliers.shape == (3, 96)
    assert torch.isfinite(got.E).all() and int(got.num_inliers[2]) == 0
    for b, ref in enumerate(refs):
        E_ref = np.asarray(ref.E)
        E = got.E[b].numpy()
        assert min(np.abs(E - E_ref).max(), np.abs(E + E_ref).max()) < 1e-3
        assert (got.inliers[b].numpy() == np.asarray(ref.inliers)).mean() >= 0.99
        assert abs(int(got.num_inliers[b]) - int(ref.num_inliers)) <= 1
        single = test_.estimate_essential_ransac(
            None, T(K), T(x1[b]), T(x2[b]), T(valid), threshold_px=2.0, num_hypotheses=128,
            sample_indices=draws[b])
        np.testing.assert_allclose(single.E.numpy(), E, atol=1e-5)


# ---------------------------------------------------------------------------
# the outcome tests of tests/test_ransac.py, on the port


def test_essential_ransac_with_outliers(rng):
    scene = make_scene(rng, n_points=256, n_cams=2, noise_px=0.5, outlier_frac=0.3)
    x1, x2, K = T(scene["obs"][0]), T(scene["obs"][1]), T(scene["K"])
    res = test_.estimate_essential_ransac(torch.Generator().manual_seed(1), K, x1, x2,
                                          torch.ones(256), threshold_px=2.0)
    inl = res.inliers.numpy()
    out_mask = scene["outliers"][0] | scene["outliers"][1]
    assert inl[out_mask].mean() < 0.05
    assert inl[~out_mask].mean() > 0.9
    R_rel = scene["Rs"][1] @ scene["Rs"][0].T
    t_rel = scene["ts"][1] - R_rel @ scene["ts"][0]
    R, t, _ = tepi.recover_pose(res.E, x1, x2, K, res.inliers.float())
    assert rotation_angle_deg(R.numpy(), R_rel) < 0.3
    cos = abs(float(np.dot(t.numpy(), t_rel) / (np.linalg.norm(t.numpy()) * np.linalg.norm(t_rel))))
    assert cos > 0.999


def _pairwise_rot_errors(n_points, seeds):
    """(err_E, err_F) rotation errors per seed for both init-pair routes,
    each given the samples that the JAX estimator draws from the seed's
    key (the low-count regime is chaotic in the draw)."""
    err_E, err_F = [], []
    ones = np.ones(n_points, np.float32)
    for seed in seeds:
        _, K, x1, x2, R_rel = _essential_problem(seed, n_points)
        key = jax.random.PRNGKey(seed)
        rE = test_.estimate_essential_ransac(None, T(K), T(x1), T(x2), T(ones), threshold_px=2.0,
                                             sample_indices=_draws(key, ones, 512, 5))
        R1, _, _ = tepi.recover_pose(rE.E, T(x1), T(x2), T(K), rE.inliers.float())
        err_E.append(rotation_angle_deg(R1.numpy(), R_rel))
        rF = test_.estimate_fundamental_ransac(None, T(x1), T(x2), T(ones), threshold_px=2.0,
                                               sample_indices=_draws(key, ones, 1024, 8))
        EF = tepi.essential_from_fundamental(rF.F, T(K))
        R2, _, _ = tepi.recover_pose(EF, T(x1), T(x2), T(K), rF.inliers.float())
        err_F.append(rotation_angle_deg(R2.numpy(), R_rel))
    return err_E, err_F


def test_essential_beats_fundamental_at_low_counts():
    """16 points with 25% outliers per view: the 5-DoF E (known K) degrades
    gracefully where the 7-DoF F route falls apart."""
    err_E, err_F = _pairwise_rot_errors(16, range(6))
    for e, f in zip(err_E, err_F):
        assert e <= f + 0.1, (err_E, err_F)
    assert np.median(err_E) <= np.median(err_F) + 0.05
    assert np.median(err_E) < 5.0


def test_essential_never_catastrophic_at_init_counts():
    err_E, _ = _pairwise_rot_errors(64, range(6))
    assert np.max(err_E) < 5.0, err_E
