"""High-level robust estimators built on the RANSAC harness.

PyTorch port of recon3d_tpu/ops/estimation.py: the fundamental,
homography and essential estimators of the two-view stage and the PnP
estimators of the registration waves. All take padded correspondences with
any leading batch (pairs, or the images of a wave), a torch.Generator (or
pre-drawn `sample_indices`) and a fixed hypothesis budget.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from recon3d_tpu_torch.ops.epipolar import (
    fundamental_8point,
    homography_dlt,
    homography_transfer_distance,
    recover_pose,
    sampson_distance,
    sampson_distance_batch,
)
from recon3d_tpu_torch.ops import ransac as _ransac
from recon3d_tpu_torch.ops.essential5 import nister_5point
from recon3d_tpu_torch.ops.lie import hat, so3_exp, so3_exp_jacobian
from recon3d_tpu_torch.ops.linalg import einsum_hp, homogeneous, matmul_hp
from recon3d_tpu_torch.ops.pnp import PnPResult, pnp_ransac, pnp_ransac_multi
from recon3d_tpu_torch.ops.select import argmax_first, argmin_first


class FundamentalResult(NamedTuple):
    F: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def estimate_fundamental_ransac(
    generator: Optional[torch.Generator],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 2.0,
    num_hypotheses: int = 1024,
    sample_indices: Optional[torch.Tensor] = None,
) -> FundamentalResult:
    """RANSAC fundamental matrix on padded correspondences.

    x1, x2: (..., N, 2) pixels, valid: (..., N). 8-point samples; the final
    model is least-squares refit on all inliers (2 rounds).
    sample_indices: pre-drawn (..., num_hypotheses, 8) samples."""

    def solver(mask):
        if mask.dim() == valid.dim():          # one weight row per pair
            return fundamental_8point(x1, x2, mask)
        return fundamental_8point(x1[..., None, :, :], x2[..., None, :, :], mask)

    def sample_solver(idx):
        # gathered 8-point samples: (8, 2) systems instead of masked (N, 9)
        ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
        return fundamental_8point(_ransac.gather_rows(x1, idx), _ransac.gather_rows(x2, idx), ones)

    def residual_fn(F):
        return sampson_distance(F, x1, x2)

    def batch_residual_fn(Fs):
        return sampson_distance_batch(Fs, x1, x2)

    res = _ransac.ransac_with_refit(
        generator, solver, residual_fn, valid, 8, num_hypotheses, threshold_px,
        batch_residual_fn=batch_residual_fn, sample_solver=sample_solver,
        sample_indices=sample_indices,
    )
    return FundamentalResult(F=res.model, inliers=res.inliers, num_inliers=res.num_inliers)


class HomographyResult(NamedTuple):
    H: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def estimate_homography_ransac(
    generator: Optional[torch.Generator],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 3.0,
    num_hypotheses: int = 512,
    sample_indices: Optional[torch.Tensor] = None,
) -> HomographyResult:
    """RANSAC homography on padded correspondences (N, 2): 4-point DLT
    samples, symmetric transfer distance, one least-squares refit on the
    winner's inliers. The consumer is the two-view degeneracy gate: if a
    single H explains (almost) all of a pair's F-inliers, the pair carries
    no parallax signal (pure rotation, a single plane, or self-similar
    texture producing a false wide-baseline match)."""
    idx = sample_indices
    if idx is None:
        idx = _ransac.sample_indices(generator, valid, num_hypotheses, 4)
    ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    Hs = homography_dlt(_ransac.gather_rows(x1, idx), _ransac.gather_rows(x2, idx), ones)
    res = homography_transfer_distance(Hs, x1, x2)  # (Hyp, N)
    valid_b = valid > 0
    inl = (res < threshold_px) & valid_b
    counts = inl.sum(dim=-1)
    r2 = torch.square(res).clamp_max(threshold_px * threshold_px)
    score = torch.where(valid_b, r2, 0.0).sum(dim=-1)
    norm_score = score / (score.amax() + 1e-12)
    best = argmax_first(counts.to(torch.float32) - 0.5 * norm_score, -1)
    # one LS refit on the winner's inliers
    w = inl[best].to(x1.dtype)
    H = torch.where(w.sum() >= 4, homography_dlt(x1, x2, w), Hs[best])
    r = homography_transfer_distance(H, x1, x2)
    inliers = (r < threshold_px) & valid_b
    return HomographyResult(H=H, inliers=inliers, num_inliers=inliers.sum())


class EssentialResult(NamedTuple):
    E: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _sampson_with_jacobian(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """sampson_distance (..., N) and its derivative with respect to F,
    (..., N, 3, 3). The clamp of the denominator has derivative zero on its
    clamped side, as autodiff takes it; at a residual of exactly zero the
    derivative is written as 0 (the square root's own is not finite)."""
    x1h = homogeneous(x1)
    x2h = homogeneous(x2)
    Fx1 = einsum_hp("...ij,...nj->...ni", F, x1h)
    Ftx2 = einsum_hp("...ji,...nj->...ni", F, x2h)
    e = (x2h * Fx1).sum(dim=-1)
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    free = (den >= 1e-12).to(F.dtype)
    den = den.clamp_min(1e-12)
    root = torch.sqrt(den)
    xy = torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype, device=F.device)
    de = x2h[..., :, None] * x1h[..., None, :]
    dden = 2.0 * ((Fx1 * xy)[..., :, None] * x1h[..., None, :]
                  + x2h[..., :, None] * (Ftx2 * xy)[..., None, :])
    dr = ((torch.sign(e) / root)[..., None, None] * de
          - (e.abs() * free / (2.0 * den * root))[..., None, None] * dden)
    return e.abs() / root, dr


def _refine_essential_manifold(
    E0: torch.Tensor,
    K: torch.Tensor,
    KinvT: torch.Tensor,
    Kinv: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    weights: torch.Tensor,
    valid_b: torch.Tensor,
    threshold_px: float,
) -> torch.Tensor:
    """LM refinement of E constrained to the essential manifold.

    Parameterizes E(w, dt) = [t']_x (exp(w) R0) with (R0, t0) from the
    cheirality-voted decomposition of E0 and t' = normalize(t0 + dt), and
    minimizes the weighted PIXEL Sampson error over the 6 parameters (5
    DoF: the normalization flattens the translation-scale direction, and
    the LM damping absorbs the null direction). This is the local
    optimization that the unconstrained 8-point refit cannot provide: at
    low correspondence counts an unconstrained rank-2 refit drifts off the
    essential manifold, while the manifold step can only move within valid
    (R, t) geometry. The caller gates acceptance on the MSAC score.

    E0 (..., 3, 3), x1, x2 (..., N, 2), weights and valid_b (..., N). The
    Jacobian is written out; the JAX function takes it by autodiff."""
    dt_ = E0.dtype
    dev = E0.device
    lead = E0.shape[:-2]
    R0, t0, _ = recover_pose(E0, x1, x2, K, weights)
    t0 = t0 / torch.linalg.norm(t0, dim=-1, keepdim=True).clamp_min(1e-12)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def pose_of(params):
        Rn = matmul_hp(so3_exp(params[..., :3]), R0)
        u = t0 + params[..., 3:]
        norm = torch.linalg.norm(u, dim=-1, keepdim=True).clamp_min(1e-12)
        return Rn, u / norm, norm

    def E_of(params):
        Rn, tn, _ = pose_of(params)
        return matmul_hp(hat(tn), Rn)

    def to_F(E):
        return matmul_hp(matmul_hp(KinvT, E), Kinv)

    def resid(params, w):
        return sampson_distance(to_F(E_of(params)), x1, x2) * w

    def resid_with_jacobian(params, w):
        Rn, tn, norm = pose_of(params)
        r, dF = _sampson_with_jacobian(to_F(matmul_hp(hat(tn), Rn)), x1, x2)
        dE = matmul_hp(matmul_hp(Kinv, dF), KinvT)                    # (..., N, 3, 3)
        # dE/dw_k = [t']_x (d exp(w)/dw_k) R0; dE/d(dt)_k = [d t'/d(dt)_k]_x R'
        dR = matmul_hp(so3_exp_jacobian(params[..., :3]), R0[..., None, :, :])
        dE_w = matmul_hp(hat(tn)[..., None, :, :], dR)                # (..., 3, 3, 3)
        dtn = (eye3 - tn[..., :, None] * tn[..., None, :]) / norm[..., None]
        dE_t = matmul_hp(hat(dtn.transpose(-1, -2)), Rn[..., None, :, :])
        dparams = torch.cat([dE_w, dE_t], dim=-3)                     # (..., 6, 3, 3)
        J = einsum_hp("...ncd,...kcd->...nk", dE, dparams)
        return r * w, J * w[..., None]

    def lm_rounds(params, w, lam, n):
        for _ in range(n):
            rr, J = resid_with_jacobian(params, w)
            JTJ = einsum_hp("...ni,...nj->...ij", J, J)
            g = einsum_hp("...ni,...n->...i", J, rr)
            step = torch.linalg.solve_ex(JTJ + lam[..., None, None] * eye6, g[..., None])[0][..., 0]
            new_params = params - step
            # accept only if the weighted SSE improves
            new_sse = torch.square(resid(new_params, w)).sum(dim=-1)
            old_sse = torch.square(rr).sum(dim=-1)
            better = torch.isfinite(new_sse) & (new_sse < old_sse)
            params = torch.where(better[..., None], new_params, params)
            lam = torch.where(better, lam * 0.5, lam * 4.0)
        return params, lam

    params = torch.zeros(lead + (6,), dtype=dt_, device=dev)
    lam = torch.full(lead, 1e-4, dtype=dt_, device=dev)
    params, lam = lm_rounds(params, weights, lam, 6)
    # re-estimate the inlier set once at the refined model, polish again
    r_mid = sampson_distance(to_F(E_of(params)), x1, x2)
    w2 = ((r_mid < threshold_px) & valid_b).to(dt_)
    w2 = torch.where(w2.sum(dim=-1, keepdim=True) >= 5, w2, weights)
    params, _ = lm_rounds(params, w2, lam, 6)
    E = E_of(params)
    return E / torch.linalg.norm(E.reshape(lead + (9,)), dim=-1).clamp_min(1e-12)[..., None, None]


def estimate_essential_ransac(
    generator: Optional[torch.Generator],
    K: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 2.0,
    num_hypotheses: int = 512,
    sample_indices: Optional[torch.Tensor] = None,
) -> EssentialResult:
    """RANSAC essential matrix with KNOWN intrinsics (Nistér 5-point).

    F's 7 DoF must be pinned down by the data where E has only 5, so at low
    correspondence counts or thin parallax the F route admits distortion
    that the E route rejects, and a 5-point minimal sample is far more
    likely to be outlier-free than an 8-point one. Hypotheses are the 20
    gated candidates per 5-sample of ops/essential5 (num_hypotheses samples,
    20 models each); the vote is MSAC on the pixel Sampson distance via
    F = K^-T E K^-1. Then a guarded local optimization: the winner, its
    least-squares refit on its inlier set (masked 8-point in normalized
    coordinates, 2 rounds; rank 2, singular values not equalized) and its
    manifold-constrained LM refinement compete on the MSAC score, so the
    refinement can never degrade the result.

    x1, x2: (..., N, 2) pixels; valid: (..., N); K: (3, 3). sample_indices:
    pre-drawn (..., num_hypotheses, 5) samples. Returns E with ||E|| = 1."""
    lead = valid.shape[:-1]
    Kinv = torch.linalg.inv(K)
    KinvT = Kinv.T

    def norm_pts(x):
        n = einsum_hp("ij,...nj->...ni", Kinv, homogeneous(x))
        return n[..., :2] / n[..., 2:].clamp_min(1e-12)

    x1n = norm_pts(x1)
    x2n = norm_pts(x2)

    def to_F(E):
        return matmul_hp(matmul_hp(KinvT, E), Kinv)

    idx = sample_indices
    if idx is None:
        idx = _ransac.sample_indices(generator, valid, num_hypotheses, 5)
    Es, ok = nister_5point(_ransac.gather_rows(x1n, idx), _ransac.gather_rows(x2n, idx))
    Es = Es.reshape(lead + (-1, 3, 3))
    ok = ok.reshape(lead + (-1,))

    residuals = sampson_distance_batch(to_F(Es), x1, x2)  # (..., 20H, N)
    valid_b = valid > 0
    inl = (residuals < threshold_px) & valid_b[..., None, :] & ok[..., None]
    r2 = torch.square(residuals).clamp_max(threshold_px * threshold_px)
    score = torch.where(valid_b[..., None, :], r2, 0.0).sum(dim=-1)
    counts = inl.sum(dim=-1)
    norm_score = score / (score.amax(dim=-1, keepdim=True) + 1e-12)
    best = argmax_first(
        torch.where(ok, counts.to(torch.float32) - 0.5 * norm_score, -1.0), -1)
    E0 = _ransac.select_best(Es, best, 2)
    inliers0 = _ransac.select_best(inl, best, 1)

    def msac_of(E):
        r = sampson_distance(to_F(E), x1, x2)
        sc = torch.where(
            valid_b, torch.square(r).clamp_max(threshold_px * threshold_px), 0.0).sum(dim=-1)
        return torch.where(torch.isfinite(sc), sc, float("inf"))

    # Candidate 1: iterative unconstrained LS refit (masked normalized
    # 8-point, rank 2 enforced inside fundamental_8point).
    E1 = E0
    inliers = inliers0
    for _ in range(2):
        w = inliers.to(torch.float32) * valid_b
        enough = w.sum(dim=-1) >= 8
        E1 = torch.where(enough[..., None, None], fundamental_8point(x1n, x2n, w), E1)
        inliers = (sampson_distance(to_F(E1), x1, x2) < threshold_px) & valid_b
    # Candidate 2: manifold-constrained LM from the winner's pose.
    E2 = _refine_essential_manifold(
        E0, K, KinvT, Kinv, x1, x2, inliers0.to(torch.float32), valid_b, threshold_px)
    cands = torch.stack([E0, E1, E2], dim=-3)
    scores3 = torch.stack([msac_of(E0), msac_of(E1), msac_of(E2)], dim=-1)
    E = _ransac.select_best(cands, argmin_first(scores3, -1), 2)
    inliers = (sampson_distance(to_F(E), x1, x2) < threshold_px) & valid_b
    return EssentialResult(E=E, inliers=inliers, num_inliers=inliers.sum(dim=-1))


def estimate_pose_pnp_wave(
    generator: Optional[torch.Generator],
    K: torch.Tensor,
    X: torch.Tensor,
    x_px: torch.Tensor,
    valid: torch.Tensor,
    thresholds_px: torch.Tensor,
    num_hypotheses: int = 2048,
    refine_iterations: int = 8,
    sample_indices: Optional[Sequence[torch.Tensor]] = None,
) -> PnPResult:
    """Batched RANSAC-PnP: a whole registration wave in one call.

    Every eligible image x every threshold of the cascade solves at once:
    X (B, N, 3), x_px (B, N, 2), valid (B, N), thresholds_px (T,) ->
    PnPResult with (B, T, ...) fields; one hypothesis batch per image,
    scored against the whole cascade (ops/pnp.py pnp_ransac_multi). The
    host then picks, per image, the tightest threshold whose inlier count
    passes the acceptance rule, as a sequential cascade would."""
    return pnp_ransac_multi(
        generator, K, X, x_px, valid, thresholds_px, num_hypotheses=num_hypotheses,
        refine_iterations=refine_iterations, sample_indices=sample_indices)


def estimate_pose_pnp_wave_indexed(
    generator: Optional[torch.Generator],
    K: torch.Tensor,
    P_table: torch.Tensor,
    kp_flat: torch.Tensor,
    pid_idx: torch.Tensor,
    kp_idx: torch.Tensor,
    thresholds_px: torch.Tensor,
    num_hypotheses: int = 2048,
    refine_iterations: int = 8,
    sample_indices: Optional[Sequence[torch.Tensor]] = None,
) -> PnPResult:
    """estimate_pose_pnp_wave with the gathers on the device.

    The host uploads only integer index tables (pid_idx, kp_idx) and the
    raw (P, 3) point table; the keypoint table is uploaded once per
    reconstruction (it does not change after extraction) and the
    (B, cap, ...) operands are gathered on the device. pid_idx < 0 marks
    padded slots.

      P_table (P, 3), kp_flat (sumK, 2), pid_idx (B, cap), kp_idx (B, cap),
      thresholds_px (T,)."""
    valid = (pid_idx >= 0).to(P_table.dtype)
    X = P_table[pid_idx.clamp(0, P_table.shape[0] - 1).long()]
    x_px = kp_flat[kp_idx.clamp(0, kp_flat.shape[0] - 1).long()]
    return pnp_ransac_multi(
        generator, K, X, x_px, valid, thresholds_px, num_hypotheses=num_hypotheses,
        refine_iterations=refine_iterations, sample_indices=sample_indices)


def estimate_pose_pnp(
    generator: Optional[torch.Generator],
    K: torch.Tensor,
    X: torch.Tensor,
    x_px: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 8.0,
    num_hypotheses: int = 2048,
    refine_iterations: int = 8,
    sample_indices: Optional[Sequence[torch.Tensor]] = None,
) -> PnPResult:
    """RANSAC-PnP + GN polish at one threshold (see ops/pnp.py)."""
    return pnp_ransac(
        generator, K, X, x_px, valid, num_hypotheses=num_hypotheses,
        threshold_px=threshold_px, refine_iterations=refine_iterations,
        sample_indices=sample_indices)
