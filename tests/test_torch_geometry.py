"""Geometry ops of the PyTorch port against their JAX counterparts (CPU):
linalg, lie, triangulate, epipolar, ransac and the two-view estimators.

The same numpy inputs go through both. Null vectors, F and H are defined
up to sign and are compared up to sign; decompositions (eigh, svd) differ
between the two backends in the last bits, so matrices are held to 1e-4
relative to their largest entry unless a test states another tolerance.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from recon3d_tpu.camera import projection_from_KRt
from recon3d_tpu.ops import epipolar as jepi
from recon3d_tpu.ops import estimation as jest
from recon3d_tpu.ops import lie as jlie
from recon3d_tpu.ops import linalg as jlin
from recon3d_tpu.ops import ransac as jransac
from recon3d_tpu.ops import triangulate as jtri
from recon3d_tpu_torch.ops import epipolar as tepi
from recon3d_tpu_torch.ops import estimation as test_
from recon3d_tpu_torch.ops import lie as tlie
from recon3d_tpu_torch.ops import linalg as tlin
from recon3d_tpu_torch.ops import ransac as transac
from recon3d_tpu_torch.ops import select as tselect
from recon3d_tpu_torch.ops import triangulate as ttri
from tests.synthetic import make_scene, random_rotation

RTOL = 1e-4   # relative to the reference's largest entry

# The test workers share the machine's cores: PyTorch's default of one
# thread per core in every worker makes them wait on one another.
torch.set_num_threads(2)


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def assert_close_rel(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rtol * scale


def errors_up_to_sign(got, ref, lead_dims):
    """Per item (over the first lead_dims dims): the largest deviation from
    the reference or from its negative, relative to the reference's
    largest entry."""
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    g = got.reshape(int(np.prod(got.shape[:lead_dims])), -1)
    r = ref.reshape(g.shape)
    err = np.minimum(np.abs(g - r).max(1), np.abs(g + r).max(1))
    return err / np.abs(r).max(1)


def assert_close_up_to_sign(got, ref, lead_dims, rtol=RTOL):
    assert float(errors_up_to_sign(got, ref, lead_dims).max()) <= rtol


def _two_view(rng, **kw):
    scene = make_scene(rng, n_cams=2, **kw)
    K = scene["K"]
    Ps = [np.asarray(projection_from_KRt(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t)))
          for R, t in zip(scene["Rs"], scene["ts"])]
    return scene, K, Ps[0], Ps[1]


def random_spd(rng, n, batch):
    A = rng.standard_normal((batch, n + 3, n)).astype(np.float32)
    return np.einsum("bki,bkj->bij", A, A)


# ---------------------------------------------------------------------------
# select


def test_selection_helpers_break_ties_by_the_lower_index():
    x = torch.tensor([[3.0, 1.0, 1.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0, 2.0]])
    assert tselect.argmin_first(x, -1).tolist() == [4, 0]
    assert tselect.argmax_first(x, -1).tolist() == [0, 0]
    assert tselect.argmin_first(x.T, 0).tolist() == [4, 0]
    vals, idx = tselect.topk_nonneg_first(x, 3)
    assert idx.tolist() == [[0, 3, 1], [0, 1, 2]]
    assert vals.tolist() == [[3.0, 3.0, 1.0], [2.0, 2.0, 2.0]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(np.asarray(ji), idx.numpy())
    keys = torch.tensor([1.0, 0.0, 1.0, 0.0, float("inf"), 0.0])
    assert torch.argsort(keys, stable=True).tolist() == [1, 3, 5, 0, 2, 4]
    np.testing.assert_array_equal(np.asarray(jnp.argsort(jnp.asarray(keys.numpy()))),
                                  torch.argsort(keys, stable=True).numpy())


def test_topk_nonneg_first_matches_lax_top_k_on_a_score_volume(rng):
    """The detector's use: mostly zeros (the filler), a few positive
    scores, some of them equal."""
    score = np.zeros((2, 5000), np.float32)
    pos = rng.choice(5000, 300, replace=False)
    score[:, pos] = rng.choice(np.linspace(0.01, 0.2, 40).astype(np.float32), (2, 300))
    jv, ji = jax.lax.top_k(jnp.asarray(score), 512)
    tv, ti = tselect.topk_nonneg_first(torch.from_numpy(score), 512)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


# ---------------------------------------------------------------------------
# linalg


def test_smallest_eigvec_matches_jax_up_to_sign(rng):
    A = random_spd(rng, 9, 64)
    ref = jlin.smallest_eigvec(jnp.asarray(A))
    got = tlin.smallest_eigvec(T(A))
    assert_close_up_to_sign(got, ref, 1, rtol=1e-3)   # A^T A squares the conditioning
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_eigh3x3_matches_jax_and_numpy(rng):
    A = random_spd(rng, 3, 128)
    wj, Vj = jlin.eigh3x3(jnp.asarray(A))
    wt, Vt = tlin.eigh3x3(T(A))
    assert_close_rel(wt, wj)
    np.testing.assert_allclose(wt.numpy(), np.linalg.eigvalsh(A.astype(np.float64)),
                               rtol=1e-3, atol=1e-3)
    # closed-form eigenvectors: same columns up to sign
    assert_close_up_to_sign(Vt.transpose(-1, -2).reshape(-1, 3),
                            np.asarray(Vj).transpose(0, 2, 1).reshape(-1, 3), 1, rtol=1e-3)


def test_eigh3x3_exactly_isotropic():
    A = np.stack([np.eye(3, dtype=np.float32) * s for s in (1.0, 1e-3, 7.5)])
    w, V = tlin.eigh3x3(T(A))
    assert torch.isfinite(w).all() and torch.isfinite(V).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(jlin.eigh3x3(jnp.asarray(A))[0]), atol=1e-6)
    np.testing.assert_allclose((V.transpose(-1, -2) @ V).numpy(),
                               np.broadcast_to(np.eye(3), (3, 3, 3)), atol=1e-5)


def test_nearest_rotation_matches_jax(rng):
    M = np.stack([random_rotation(rng) for _ in range(32)]).astype(np.float32)
    M = M + 0.05 * rng.standard_normal(M.shape).astype(np.float32)
    M[5] *= -1.0     # improper: the det correction must flip it back
    ref = jlin.nearest_rotation(jnp.asarray(M))
    got = tlin.nearest_rotation(T(M))
    assert_close_rel(got, ref)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, atol=1e-4)


def test_solve_psd_and_homogeneous_match_jax(rng):
    A = random_spd(rng, 6, 8)
    b = rng.standard_normal((8, 6)).astype(np.float32)
    B = rng.standard_normal((8, 6, 2)).astype(np.float32)
    assert_close_rel(tlin.solve_psd(T(A), T(b), 1e-3),
                     jlin.solve_psd(jnp.asarray(A), jnp.asarray(b), 1e-3), rtol=1e-3)
    assert_close_rel(tlin.solve_psd(T(A), T(B)),
                     jlin.solve_psd(jnp.asarray(A), jnp.asarray(B)), rtol=1e-3)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    x[0, -1] = 0.0
    x[1, -1] = -1e-14
    np.testing.assert_array_equal(tlin.homogeneous(T(x)).numpy(),
                                  np.asarray(jlin.homogeneous(jnp.asarray(x))))
    np.testing.assert_allclose(tlin.from_homogeneous(T(x)).numpy(),
                               np.asarray(jlin.from_homogeneous(jnp.asarray(x))), rtol=1e-6)
    a = rng.standard_normal((4, 3, 5)).astype(np.float32)
    c = rng.standard_normal((4, 5, 2)).astype(np.float32)
    assert_close_rel(tlin.matmul_hp(T(a), T(c)), jlin.matmul_hp(jnp.asarray(a), jnp.asarray(c)),
                     rtol=1e-6)
    assert_close_rel(tlin.einsum_hp("bij,bjk->bik", T(a), T(c)),
                     jlin.einsum_hp("bij,bjk->bik", jnp.asarray(a), jnp.asarray(c)), rtol=1e-6)


# ---------------------------------------------------------------------------
# lie


def test_lie_maps_match_jax(rng):
    w = (rng.standard_normal((64, 3)) * 0.8).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-6          # the series branch
    xi = np.concatenate([w, rng.standard_normal((64, 3)).astype(np.float32)], -1)
    R = jlie.so3_exp(jnp.asarray(w))
    np.testing.assert_allclose(tlie.hat(T(w)).numpy(), np.asarray(jlie.hat(jnp.asarray(w))))
    np.testing.assert_allclose(tlie.so3_exp(T(w)).numpy(), np.asarray(R), atol=1e-6)
    np.testing.assert_allclose(tlie.so3_log(T(np.asarray(R))).numpy(),
                               np.asarray(jlie.so3_log(R)), atol=1e-5)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(T(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(tlie.se3_log(Rt, tt).numpy(),
                               np.asarray(jlie.se3_log(Rj, tj)), atol=1e-4)
    # and the round trip inside the port
    np.testing.assert_allclose(tlie.se3_log(Rt, tt).numpy()[2:], xi[2:], atol=1e-4)


def test_so3_exp_is_differentiable_at_zero():
    w = torch.zeros(3, requires_grad=True)
    tlie.so3_exp(w)[0, 1].backward()
    assert torch.isfinite(w.grad).all() and w.grad[2] == -1.0


# ---------------------------------------------------------------------------
# triangulate


def test_triangulation_matches_jax(rng):
    scene, K, P1, P2 = _two_view(rng, n_points=100, noise_px=0.5)
    x1, x2 = scene["obs"]
    ref = jtri.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(x1), jnp.asarray(x2))
    got = ttri.triangulate_dlt(T(P1), T(P2), T(x1), T(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)
    np.testing.assert_allclose(got.numpy(), scene["X"], atol=0.1)   # 0.5 px of noise

    R1, t1, R2, t2 = scene["Rs"][0], scene["ts"][0], scene["Rs"][1], scene["ts"][1]
    X = np.array(ref)
    X[:10] *= -1.0                                   # behind the cameras
    x2_bad = x2.copy()
    x2_bad[10:20] += 30.0                            # reprojection gate
    args = (K, R1, t1, R2, t2, X, x1, x2_bad)
    ok_ref = jtri.validate_triangulation(*map(jnp.asarray, args))
    ok = ttri.validate_triangulation(*map(T, args))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert not ok[:20].any() and ok[20:].all()
    np.testing.assert_allclose(
        ttri.reprojection_errors(T(K), T(R2), T(t2), T(X), T(x2_bad)).numpy(),
        np.asarray(jtri.reprojection_errors(*map(jnp.asarray, (K, R2, t2, X, x2_bad)))),
        rtol=1e-3, atol=1e-3)
    C1, C2 = -R1.T @ t1, -R2.T @ t2
    np.testing.assert_allclose(
        ttri.triangulation_angles(T(C1), T(C2), T(X)).numpy(),
        np.asarray(jtri.triangulation_angles(jnp.asarray(C1), jnp.asarray(C2), jnp.asarray(X))),
        atol=1e-3)


def test_triangulate_nview_masked_matches_jax(rng):
    scene = make_scene(rng, n_points=50, n_cams=4)
    K = jnp.asarray(scene["K"])
    Ps = np.stack([np.asarray(projection_from_KRt(K, jnp.asarray(R), jnp.asarray(t)))
                   for R, t in zip(scene["Rs"], scene["ts"])])
    xs = scene["obs"].transpose(1, 0, 2).copy()     # (N, V, 2)
    mask = np.tile([1.0, 1.0, 0.0, 1.0], (50, 1)).astype(np.float32)
    xs[:, 2] = -1e4                                  # masked out: must be ignored
    ref = jtri.triangulate_nview(jnp.asarray(Ps), jnp.asarray(xs), jnp.asarray(mask))
    got = ttri.triangulate_nview(T(Ps), T(xs), T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)
    np.testing.assert_allclose(got.numpy(), scene["X"], atol=5e-2)


# ---------------------------------------------------------------------------
# epipolar


def test_fundamental_8point_matches_jax_up_to_sign(rng):
    scene, K, _, _ = _two_view(rng, n_points=64, noise_px=0.3)
    x1, x2 = scene["obs"]
    mask = np.ones(64, np.float32)
    mask[50:] = 0.0
    ref = jepi.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    got = tepi.fundamental_8point(T(x1), T(x2), T(mask))
    assert_close_up_to_sign(got[None], np.asarray(ref)[None], 1)
    assert abs(float(torch.linalg.det(got))) < 1e-6
    # a batch of minimal samples, as RANSAC gives them: (H, 8, 2) systems
    idx = np.stack([rng.choice(50, 8, replace=False) for _ in range(32)])
    ones = np.ones((32, 8), np.float32)
    ref_b = jax.vmap(jepi.fundamental_8point)(jnp.asarray(x1[idx]), jnp.asarray(x2[idx]),
                                              jnp.asarray(ones))
    got_b = tepi.fundamental_8point(T(x1[idx]), T(x2[idx]), T(ones))
    # A minimal system's smallest two eigenvalues can lie close together,
    # and the null vector then turns with the last bits of A^T A: nine in
    # ten within 1e-3, all within 0.1, and every one of rank 2.
    err = errors_up_to_sign(got_b, ref_b, 1)
    assert np.mean(err < 1e-3) >= 0.9 and err.max() < 0.1, np.sort(err)[-5:]
    assert float(torch.linalg.det(got_b).abs().max()) < 1e-6


def test_distances_match_jax(rng):
    scene, K, _, _ = _two_view(rng, n_points=80, noise_px=1.0)
    x1, x2 = scene["obs"]
    F = np.asarray(jepi.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2), jnp.ones(80)))
    Fs = np.stack([F, F.T, F + 1e-3 * rng.standard_normal((3, 3)).astype(np.float32)])
    for name in ("sampson_distance", "epipolar_distance"):
        ref = getattr(jepi, name)(jnp.asarray(F), jnp.asarray(x1), jnp.asarray(x2))
        got = getattr(tepi, name)(T(F), T(x1), T(x2))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)
    ref = jepi.sampson_distance_batch(jnp.asarray(Fs), jnp.asarray(x1), jnp.asarray(x2))
    got = tepi.sampson_distance_batch(T(Fs), T(x1), T(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-3)
    # the batch form equals the per-hypothesis one, with a leading pair axis too
    per = tepi.sampson_distance(T(Fs), T(x1), T(x2))
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-3, atol=1e-3)
    two = tepi.sampson_distance_batch(T(np.stack([Fs, Fs[::-1]])), T(np.stack([x1, x1])),
                                      T(np.stack([x2, x2])))
    np.testing.assert_allclose(two[1].numpy(), got.numpy()[::-1], rtol=1e-5, atol=1e-5)


def test_homography_dlt_and_transfer_distance_match_jax(rng):
    n = 64
    Kc = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    R = np.array([[0.9689, 0, 0.2474], [0, 1, 0], [-0.2474, 0, 0.9689]])
    t = np.array([0.8, 0.1, 0.2])

    def project(X, Rm, tm):
        Xc = X @ Rm.T + tm
        return ((Xc[:, :2] / Xc[:, 2:]) @ Kc[:2, :2].T + Kc[:2, 2]).astype(np.float32)

    Xp = np.concatenate([rng.uniform(-2, 2, size=(n, 2)), np.full((n, 1), 4.0)], axis=1)
    x1 = project(Xp, np.eye(3), np.zeros(3))
    x2 = project(Xp, R, t) + rng.normal(scale=0.3, size=(n, 2)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-6:] = 0.0
    ref = jepi.homography_dlt(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    got = tepi.homography_dlt(T(x1), T(x2), T(mask))
    assert_close_up_to_sign(got[None], np.asarray(ref)[None], 1, rtol=1e-3)
    d_ref = jepi.homography_transfer_distance(ref, jnp.asarray(x1), jnp.asarray(x2))
    d_got = tepi.homography_transfer_distance(T(np.asarray(ref)), T(x1), T(x2))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), rtol=1e-3, atol=1e-3)
    assert float(d_got[:-6].median()) < 1.0


def test_essential_and_pose_recovery_match_jax(rng):
    scene, K, _, _ = _two_view(rng, n_points=100)
    x1, x2 = scene["obs"]
    F = jepi.fundamental_8point(jnp.asarray(x1), jnp.asarray(x2), jnp.ones(100))
    Ej = jepi.essential_from_fundamental(F, jnp.asarray(K))
    Et = tepi.essential_from_fundamental(T(np.asarray(F)), T(K))
    assert_close_up_to_sign(Et[None], np.asarray(Ej)[None], 1, rtol=1e-3)
    s = torch.linalg.svdvals(Et)
    assert abs(float(s[0] - s[1])) < 1e-4 * float(s[0]) and float(s[2]) < 1e-4 * float(s[0])

    Rs, ts = tepi.decompose_essential(T(np.asarray(Ej)))
    assert Rs.shape == (4, 3, 3) and ts.shape == (4, 3)
    np.testing.assert_allclose(torch.linalg.det(Rs).numpy(), 1.0, atol=1e-4)
    mask = np.ones(100, np.float32)
    Rj, tj, fj = jepi.recover_pose(Ej, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(K),
                                   jnp.asarray(mask))
    Rt, tt, ft = tepi.recover_pose(T(np.asarray(Ej)), T(x1), T(x2), T(K), T(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    # against the scene: the relative pose of camera 1 in camera 0's frame
    R_true = scene["Rs"][1] @ scene["Rs"][0].T
    np.testing.assert_allclose(Rt.numpy(), R_true, atol=2e-2)


# ---------------------------------------------------------------------------
# ransac


def test_sample_indices_properties():
    gen = torch.Generator().manual_seed(0)
    valid = T(np.r_[np.ones(50), np.zeros(14)])
    idx = transac.sample_indices(gen, valid, 128, 8)
    assert idx.shape == (128, 8) and int(idx.max()) < 50      # never an invalid slot
    assert all(len(set(row)) == 8 for row in idx.tolist())    # without replacement
    assert len({tuple(sorted(row)) for row in idx.tolist()}) > 100   # diverse
    masks = transac.sample_masks(gen, valid, 128, 8)
    np.testing.assert_array_equal(masks.sum(dim=1).numpy(), 8)
    assert float(masks[:, 50:].sum()) == 0.0
    # a leading batch of pairs, each with its own validity
    both = transac.sample_indices(gen, torch.stack([valid, valid.flip(0)]), 64, 8)
    assert both.shape == (2, 64, 8)
    assert int(both[0].max()) < 50 and int(both[1].min()) >= 14
    # every valid slot is drawn about equally often: 512 * 8 / 50 = 82 each
    many = transac.sample_indices(gen, valid, 512, 8)
    hits = torch.bincount(many.flatten(), minlength=64)[:50]
    assert int(hits.min()) > 50 and int(hits.max()) < 120


def test_sample_indices_with_too_few_valid_points_keeps_the_valid_ones():
    gen = torch.Generator().manual_seed(1)
    valid = T(np.r_[np.ones(5), np.zeros(27)])
    masks = transac.sample_masks(gen, valid, 16, 8)
    np.testing.assert_array_equal(masks.sum(dim=1).numpy(), 5)


def test_sample_masks_of_jax_draws_match_jax():
    key = jax.random.PRNGKey(0)
    valid = np.r_[np.ones(50), np.zeros(14)].astype(np.float32)
    idx = np.asarray(jransac.sample_indices(key, jnp.asarray(valid), 128, 8))
    ref = jransac.sample_masks(key, jnp.asarray(valid), 128, 8)
    got = transac.sample_masks(None, T(valid), 128, 8, indices=T(idx, torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _ransac_scene(rng, n=256, n_valid=240):
    scene = make_scene(rng, n_points=n, n_cams=2, noise_px=0.5, outlier_frac=0.3)
    x1, x2 = scene["obs"]
    valid = np.ones(n, np.float32)
    valid[n_valid:] = 0.0
    return scene, x1, x2, valid


def _near_threshold(F, x1, x2, thr, tol=1e-3):
    d = np.asarray(jepi.sampson_distance(jnp.asarray(F), jnp.asarray(x1), jnp.asarray(x2)))
    return np.abs(d - thr) < tol


def test_estimate_fundamental_ransac_given_jax_draws(rng):
    """Same inlier mask as the JAX estimator, but for points within 1e-3 px
    of the threshold."""
    scene, x1, x2, valid = _ransac_scene(rng)
    key = jax.random.PRNGKey(1)
    idx = np.asarray(jransac.sample_indices(key, jnp.asarray(valid), 256, 8))
    ref = jest.estimate_fundamental_ransac(key, jnp.asarray(x1), jnp.asarray(x2),
                                           jnp.asarray(valid), threshold_px=2.0,
                                           num_hypotheses=256)
    got = test_.estimate_fundamental_ransac(None, T(x1), T(x2), T(valid), threshold_px=2.0,
                                            num_hypotheses=256,
                                            sample_indices=T(idx, torch.int64))
    differ = got.inliers.numpy() != np.asarray(ref.inliers)
    assert not (differ & ~_near_threshold(np.asarray(ref.F), x1, x2, 2.0)).any()
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= int(differ.sum())
    assert_close_up_to_sign(got.F[None], np.asarray(ref.F)[None], 1, rtol=1e-3)
    out = scene["outliers"][0] | scene["outliers"][1]
    inl = got.inliers.numpy()
    assert not inl[240:].any()
    assert inl[out].mean() < 0.05 and inl[~out & (valid > 0)].mean() > 0.9


def test_estimate_fundamental_ransac_batched_over_pairs_equals_per_pair(rng):
    """The pair axis is a tensor dimension: each pair's result equals the
    one it gets alone, given the same samples."""
    _, x1, x2, valid = _ransac_scene(rng)
    xa, xb = np.stack([x1, x2]), np.stack([x2, x1])
    va = np.stack([valid, np.roll(valid, 16)])
    gen = torch.Generator().manual_seed(3)
    idx = transac.sample_indices(gen, T(va), 128, 8)
    both = test_.estimate_fundamental_ransac(None, T(xa), T(xb), T(va), num_hypotheses=128,
                                             sample_indices=idx)
    assert both.F.shape == (2, 3, 3) and both.inliers.shape == (2, 256)
    for p in range(2):
        one = test_.estimate_fundamental_ransac(None, T(xa[p]), T(xb[p]), T(va[p]),
                                                num_hypotheses=128, sample_indices=idx[p])
        np.testing.assert_array_equal(one.inliers.numpy(), both.inliers[p].numpy())
        assert int(one.num_inliers) == int(both.num_inliers[p])
        assert_close_up_to_sign(both.F[p][None], one.F.numpy()[None], 1, rtol=1e-3)


def test_estimate_fundamental_ransac_with_its_own_draws(rng):
    scene, x1, x2, valid = _ransac_scene(rng)
    res = test_.estimate_fundamental_ransac(torch.Generator().manual_seed(0), T(x1), T(x2),
                                            T(valid), num_hypotheses=256)
    out = scene["outliers"][0] | scene["outliers"][1]
    inl = res.inliers.numpy()
    assert inl[out].mean() < 0.05 and inl[~out & (valid > 0)].mean() > 0.9


def test_estimate_homography_ransac_given_jax_draws(rng):
    n = 128
    Kc = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    R = np.array([[0.9689, 0, 0.2474], [0, 1, 0], [-0.2474, 0, 0.9689]])
    t = np.array([0.8, 0.1, 0.2])

    def project(X, Rm, tm):
        Xc = X @ Rm.T + tm
        return ((Xc[:, :2] / Xc[:, 2:]) @ Kc[:2, :2].T + Kc[:2, 2]).astype(np.float32)

    planar = np.concatenate([rng.uniform(-2, 2, size=(n, 2)), np.full((n, 1), 4.0)], axis=1)
    deep = np.concatenate([rng.uniform(-2, 2, size=(n, 2)),
                           rng.uniform(2.5, 8.0, size=(n, 1))], axis=1)
    valid = np.ones(n, np.float32)
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jransac.sample_indices(key, jnp.asarray(valid), 128, 4))
    counts = []
    for X in (planar, deep):
        x1 = project(X, np.eye(3), np.zeros(3)) + rng.normal(scale=0.3, size=(n, 2)).astype(np.float32)
        x2 = project(X, R, t) + rng.normal(scale=0.3, size=(n, 2)).astype(np.float32)
        ref = jest.estimate_homography_ransac(key, jnp.asarray(x1), jnp.asarray(x2),
                                              jnp.asarray(valid), threshold_px=3.0,
                                              num_hypotheses=128)
        got = test_.estimate_homography_ransac(None, T(x1), T(x2), T(valid), threshold_px=3.0,
                                               num_hypotheses=128,
                                               sample_indices=T(idx, torch.int64))
        d = np.asarray(jepi.homography_transfer_distance(ref.H, jnp.asarray(x1), jnp.asarray(x2)))
        differ = got.inliers.numpy() != np.asarray(ref.inliers)
        assert not (differ & ~(np.abs(d - 3.0) < 1e-3)).any()
        counts.append(int(got.num_inliers))
    # one H explains the planar pair and not the pair with depth spread
    assert counts[0] > 0.9 * n and counts[1] < 0.6 * n


def test_ransac_picks_the_first_of_equal_hypotheses(rng):
    """Duplicate samples give duplicate models with equal votes: the winner
    is the first, as jnp.argmax picks it."""
    _, x1, x2, valid = _ransac_scene(rng)
    gen = torch.Generator().manual_seed(5)
    idx = transac.sample_indices(gen, T(valid), 16, 8)
    idx = torch.cat([idx, idx])                      # every hypothesis twice
    x1t, x2t, vt = T(x1), T(x2), T(valid)

    def sample_solver(i):
        return tepi.fundamental_8point(x1t[i], x2t[i], torch.ones(i.shape))

    seen = {}

    def batch_residual_fn(Fs):
        seen["r"] = tepi.sampson_distance_batch(Fs, x1t, x2t)
        return seen["r"]

    res = transac.ransac(None, None, None, vt, 8, 32, 2.0, batch_residual_fn=batch_residual_fn,
                         sample_solver=sample_solver, sample_indices=idx)
    counts = ((seen["r"] < 2.0) & (vt > 0)).sum(-1)
    best = int(torch.nonzero(counts == counts.max())[0])
    assert best < 16
    assert int(res.num_inliers) == int(counts.max())
    np.testing.assert_array_equal(res.inliers.numpy(), ((seen["r"][best] < 2.0) & (vt > 0)).numpy())
