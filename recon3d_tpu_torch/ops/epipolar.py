"""Two-view epipolar geometry: 8-point fundamental, homography DLT, the
distances, essential decomposition and pose recovery.

PyTorch port of recon3d_tpu/ops/epipolar.py on its CPU branch (the rank-2
constraint of `fundamental_8point` through the SVD). RANSAC wrapping lives
in ops/ransac.py. All solvers accept a validity `mask` and broadcast over
leading batch dimensions (pairs, hypotheses); the mask doubles as the
minimal-sample selector. F, H and the null vectors are defined up to sign.
"""

from __future__ import annotations

import math

import torch

from recon3d_tpu_torch.ops.linalg import (
    einsum_hp,
    homogeneous,
    matmul_hp,
    smallest_eigvec,
    sum_batch_invariant,
)
from recon3d_tpu_torch.ops.ransac import select_best
from recon3d_tpu_torch.ops.select import argmax_first
from recon3d_tpu_torch.ops.triangulate import triangulate_dlt


def _normalization_transform(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hartley normalization: similarity T so that the masked points have
    zero mean and mean distance sqrt(2). x: (..., N, 2), mask: (..., N) ->
    T (..., 3, 3). Its sums do not depend on the batch's size
    (sum_batch_invariant)."""
    w = mask[..., None]
    count = sum_batch_invariant(mask, -1)[..., None].clamp_min(1.0)
    mean = sum_batch_invariant(x * w, -2) / count
    d = torch.linalg.norm(x - mean[..., None, :], dim=-1)
    mean_dist = sum_batch_invariant(d * mask, -1) / count[..., 0]
    s = math.sqrt(2.0) / mean_dist.clamp_min(1e-8)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
            torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def _apply_h(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply the affine part of T (..., 3, 3) to points (..., N, 2)."""
    return einsum_hp("...ij,...nj->...ni", T[..., :2, :2], x) + T[..., None, :2, 2]


def _unit_frobenius(M: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(M.reshape(M.shape[:-2] + (9,)), dim=-1)
    return M / norm.clamp_min(1e-12)[..., None, None]


def _bilinear_basis(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Row per correspondence of [u2u1, u2v1, u2, v2u1, v2v1, v2, u1, v1, 1]:
    x2h^T F x1h = row . vec(F)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1
    )


def fundamental_8point(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked normalized 8-point algorithm.

    x1, x2: (..., N, 2) correspondences; mask: (..., N) with >= 8 valid.
    Returns F (..., 3, 3) with the rank-2 constraint enforced, scaled so
    that ||F|| = 1."""
    T1 = _normalization_transform(x1, mask)
    T2 = _normalization_transform(x2, mask)
    A = _bilinear_basis(_apply_h(T1, x1), _apply_h(T2, x2)) * mask[..., None]
    AtA = einsum_hp("...ni,...nj->...ij", A, A)
    f = smallest_eigvec(AtA)
    F = f.reshape(f.shape[:-1] + (3, 3))

    # Enforce rank 2: zero the smallest singular value.
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = matmul_hp(U * S[..., None, :], Vt)

    # Denormalize: F = T2^T F_norm T1
    return _unit_frobenius(matmul_hp(matmul_hp(T2.transpose(-1, -2), F), T1))


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked normalized DLT homography (x2 ~ H x1).

    x1, x2: (..., N, 2); mask: (..., N) with >= 4 valid. Returns H
    (..., 3, 3) scaled so that ||H||_F = 1. Used by the two-view degeneracy
    test: a pair whose F-inliers are explained by a single H carries no
    parallax information."""
    T1 = _normalization_transform(x1, mask)
    T2 = _normalization_transform(x2, mask)
    n1 = _apply_h(T1, x1)
    n2 = _apply_h(T2, x2)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    ones = torch.ones_like(u1)
    zero = torch.zeros_like(u1)
    # two rows per correspondence of the standard 9-column DLT system
    r1 = torch.stack([u1, v1, ones, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, u1, v1, ones, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([mask, mask], dim=-1)[..., None]
    AtA = einsum_hp("...ni,...nj->...ij", A, A)
    h = smallest_eigvec(AtA)
    H = h.reshape(h.shape[:-1] + (3, 3))
    # Denormalize: H = T2^-1 H_norm T1
    return _unit_frobenius(matmul_hp(matmul_hp(torch.linalg.inv(T2), H), T1))


def homography_transfer_distance(
    H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Symmetric transfer distance (||H x1 - x2|| + ||H^-1 x2 - x1||) / 2,
    in pixels. H: (..., 3, 3); x1, x2: (..., N, 2)."""
    def fwd(Hm, a, b):
        p = einsum_hp("...ij,...nj->...ni", Hm, homogeneous(a))
        z = p[..., 2:]
        z = torch.where(z.abs() < 1e-12, 1e-12, z)
        return torch.linalg.norm(p[..., :2] / z - b, dim=-1)

    # inv_ex: a singular hypothesis gives a garbage distance and loses the
    # vote instead of stopping the batch
    Hinv = torch.linalg.inv_ex(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device))[0]
    return 0.5 * (fwd(H, x1, x2) + fwd(Hinv, x2, x1))


def epipolar_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Symmetric epipolar (point-to-line) distance in pixels.
    F: (..., 3, 3); x1, x2: (..., N, 2). Returns (..., N)."""
    x1h = homogeneous(x1)
    x2h = homogeneous(x2)
    l2 = einsum_hp("...ij,...nj->...ni", F, x1h)  # epipolar lines in image 2
    l1 = einsum_hp("...ji,...nj->...ni", F, x2h)  # lines in image 1
    num = (x2h * l2).sum(dim=-1).abs()
    d2 = num / torch.linalg.norm(l2[..., :2], dim=-1).clamp_min(1e-12)
    d1 = num / torch.linalg.norm(l1[..., :2], dim=-1).clamp_min(1e-12)
    return 0.5 * (d1 + d2)


def sampson_distance(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance, (..., N)."""
    x1h = homogeneous(x1)
    x2h = homogeneous(x2)
    Fx1 = einsum_hp("...ij,...nj->...ni", F, x1h)
    Ftx2 = einsum_hp("...ji,...nj->...ni", F, x2h)
    num = (x2h * Fx1).sum(dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return torch.sqrt(num / den.clamp_min(1e-12))


def sampson_distance_batch(
    F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Sampson distance of H hypotheses against N shared correspondences.

    F: (..., H, 3, 3); x1, x2: (..., N, 2). Returns (..., H, N). Equal to
    sampson_distance mapped over the hypotheses, but shaped as matrix
    products: x2' F x1 is linear in vec(F) over the 9-dim bilinear basis of
    the correspondences, so the three per-hypothesis products are three
    (H, .) @ (., N) products."""
    Hn = F.shape[-3]
    lead = F.shape[:-3]
    Z = _bilinear_basis(x1, x2)                                   # (..., N, 9)
    e = matmul_hp(F.reshape(lead + (Hn, 9)), Z.transpose(-1, -2))  # (..., H, N)

    x1h = homogeneous(x1).transpose(-1, -2)                       # (..., 3, N)
    x2h = homogeneous(x2).transpose(-1, -2)
    # (F x1h)[h, i, n] and (F^T x2h)[h, i, n], rows of F stacked as (H*3, 3)
    Fx1 = matmul_hp(F.reshape(lead + (Hn * 3, 3)), x1h).reshape(lead + (Hn, 3, -1))
    Ftx2 = matmul_hp(F.transpose(-1, -2).reshape(lead + (Hn * 3, 3)), x2h
                     ).reshape(lead + (Hn, 3, -1))
    den = (Fx1[..., 0, :] ** 2 + Fx1[..., 1, :] ** 2
           + Ftx2[..., 0, :] ** 2 + Ftx2[..., 1, :] ** 2)
    return torch.sqrt(e * e / den.clamp_min(1e-12))


def essential_from_fundamental(F: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """E = K^T F K, projected to the essential manifold (singular values
    (s, s, 0)), because the decomposition downstream assumes that form."""
    E = matmul_hp(matmul_hp(K.transpose(-1, -2), F), K)
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S_proj = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return matmul_hp(U * S_proj[..., None, :], Vt)


def decompose_essential(E: torch.Tensor):
    """Four (R, t) candidates from E: (R1, t), (R1, -t), (R2, t), (R2, -t).
    Returns Rs (..., 4, 3, 3), ts (..., 4, 3) with unit-norm t."""
    U, _, Vt = torch.linalg.svd(E)
    # Keep rotations proper.
    detU = torch.linalg.det(U)
    detVt = torch.linalg.det(Vt)
    one = torch.ones_like(detU)
    U = U * torch.stack([one, one, detU], dim=-1)[..., None, :]
    Vt = Vt * torch.stack([one, one, detVt], dim=-1)[..., :, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = matmul_hp(matmul_hp(U, W), Vt)
    R2 = matmul_hp(matmul_hp(U, W.T), Vt)
    t = U[..., :, 2]
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def recover_pose(
    E: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    K: torch.Tensor,
    mask: torch.Tensor,
):
    """Select the (R, t) candidate with the most points in front of both
    cameras. E: (..., 3, 3); x1, x2: (..., N, 2) pixels; mask: (..., N)
    valid correspondences; K: (3, 3).
    Returns (R (..., 3, 3), t (..., 3), cheirality_mask (..., N))."""
    Rs, ts = decompose_essential(E)  # (..., 4, 3, 3), (..., 4, 3)
    P1 = matmul_hp(K, torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                                 torch.zeros((3, 1), dtype=K.dtype, device=K.device)], dim=1))
    P2s = einsum_hp("ij,...cjk->...cik", K, torch.cat([Rs, ts[..., None]], dim=-1))
    X = triangulate_dlt(P1.expand_as(P2s), P2s, x1[..., None, :, :], x2[..., None, :, :])
    z1 = X[..., 2]                                            # (..., 4, N)
    z2 = (einsum_hp("...cij,...cnj->...cni", Rs, X) + ts[..., None, :])[..., 2]
    fronts = (z1 > 1e-6) & (z2 > 1e-6) & (mask[..., None, :] > 0)
    best = argmax_first(fronts.sum(dim=-1), -1)
    return select_best(Rs, best, 2), select_best(ts, best, 1), select_best(fronts, best, 1)
