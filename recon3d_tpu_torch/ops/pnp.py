"""Perspective-n-Point: batched minimal solvers + Gauss-Newton refinement.

PyTorch port of recon3d_tpu/ops/pnp.py: 6-point DLT, P3P (Grunert) and
EPnP hypotheses over RANSAC batches, a linear pose extraction whose sign
comes from the depths, and an unrolled Gauss-Newton polish on se(3).

Where the JAX package maps a solver over hypotheses, thresholds and the
images of a wave with vmap, every function here takes leading batch
dimensions: X is (..., N, 3), a model batch is (..., H, 12), a threshold
cascade adds an axis (..., T) behind the images. The Jacobian of the polish
is written out (the JAX function takes it by forward-mode autodiff at a
zero twist, which is the same matrix).
Random draws come from a torch.Generator on the data's device, or are
handed in as `sample_indices` (tests pass the JAX package's draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from recon3d_tpu_torch.ops import ransac as _ransac
from recon3d_tpu_torch.ops.lie import hat, se3_exp
from recon3d_tpu_torch.ops.linalg import (
    _chol_solve_unrolled,
    _cholesky_unrolled,
    eigh_batched,
    einsum_hp,
    homogeneous,
    matmul_hp,
    nearest_rotation,
    smallest_eigvec,
)
from recon3d_tpu_torch.ops.select import argmax_first


def _ones_col(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x[..., :1])


def pnp_dlt(
    X: torch.Tensor, x_norm: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted linear PnP from >= 6 3D-2D correspondences.

    X: (..., N, 3) world points; x_norm: (..., N, 2) *normalized* image
    coordinates (K^-1 applied); weights: (..., N) sample/inlier mask.
    Returns (R (..., 3, 3), t (..., 3)); the sign is the one that puts the
    weighted points in front of the camera."""
    lead = X.shape[:-2]
    # Hartley-style world normalization (zero mean, unit mean distance over
    # the weighted points): the raw DLT normal matrix mixes coordinate
    # scales, and its float32 condition suffers on minimal samples.
    wsum = weights.sum(dim=-1, keepdim=True).clamp_min(1.0)
    c = (X * weights[..., None]).sum(dim=-2) / wsum
    d = torch.linalg.norm(X - c[..., None, :], dim=-1)
    s = ((d * weights).sum(dim=-1, keepdim=True) / wsum).clamp_min(1e-8)
    Xn = (X - c[..., None, :]) / s[..., None]

    Xh = torch.cat([Xn, _ones_col(Xn)], dim=-1)            # (..., N, 4)
    zeros = torch.zeros_like(Xh)
    u, v = x_norm[..., 0:1], x_norm[..., 1:2]
    # Rows [X 0 -u*X ; 0 X -v*X] for P (3, 4) flattened row-major (12,)
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([weights, weights], dim=-1)[..., None]
    AtA = einsum_hp("...ni,...nj->...ij", A, A)
    P = smallest_eigvec(AtA).reshape(lead + (3, 4))
    # Denormalize: x ~ P' Xh_n = (P' T) Xh with T = [[I/s, -c/s], [0, 1]]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    top = torch.cat([eye / s[..., None], (-c / s)[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=X.dtype, device=X.device)
    T = torch.cat([top, bottom.expand(lead + (1, 4))], dim=-2)
    P = matmul_hp(P, T)

    # Scale by the third row of M (its norm is 1 for a true [R|t]), then
    # fix the overall sign so that the weighted depths (P[2] . Xh) are
    # positive; the depths are those of the original points.
    m3 = torch.linalg.norm(P[..., 2, :3], dim=-1)
    P = P / m3.clamp_min(1e-12)[..., None, None]
    depth = einsum_hp("...nj,...j->...n", torch.cat([X, _ones_col(X)], dim=-1), P[..., 2, :])
    sign = torch.where((depth * weights).sum(dim=-1) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    return nearest_rotation(P[..., :3]), P[..., 3]


def _real_cubic_root(a, b, c):
    """A real root of z^3 + a z^2 + b z + c = 0 (the largest real root):
    Cardano's form where one root is real, the trigonometric form where
    three are; branch-free, elementwise over any batch."""
    p = b - a * a / 3.0
    q = 2.0 * a**3 / 27.0 - a * b / 3.0 + c
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(disc.clamp_min(0.0))

    def cbrt(x):
        return torch.sign(x) * x.abs() ** (1.0 / 3.0)

    t_card = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)
    m = 2.0 * torch.sqrt((-p / 3.0).clamp_min(1e-20))
    arg = (3.0 * q / (p * m + torch.where(p == 0, 1e-20, 0.0))).clamp(-1.0, 1.0)
    t_trig = m * torch.cos(torch.acos(arg) / 3.0)
    return torch.where(disc > 0, t_card, t_trig) - a / 3.0


def _quartic_roots(c4, c3, c2, c1, c0):
    """Real roots of c4 v^4 + ... + c0 = 0 by Ferrari's method.

    Returns (roots (..., 4), valid (..., 4) bool): closed form and
    branch-free; complex roots are masked out."""
    bad_lead = c4.abs() < 1e-12
    c4s = torch.where(bad_lead, 1.0, c4)
    p, q, r, s = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # depressed quartic y^4 + al y^2 + be y + ga, v = y - p/4
    al = q - 3.0 * p * p / 8.0
    be = r - p * q / 2.0 + p**3 / 8.0
    ga = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p**4 / 256.0
    # the resolvent cubic z^3 + 2 al z^2 + (al^2 - 4 ga) z - be^2 = 0 has a
    # real root z0 >= 0 (the product of its roots is be^2 >= 0)
    z0 = _real_cubic_root(2.0 * al, al * al - 4.0 * ga, -be * be).clamp_min(0.0)
    w = torch.sqrt(z0)
    # (y^2 + w y + (al + z0)/2 - be/(2w)) (y^2 - w y + (al + z0)/2 + be/(2w))
    half = (al + z0) / 2.0
    corr = torch.where(w > 1e-10, be / (2.0 * torch.where(w > 1e-10, w, 1.0)), 0.0)
    d1 = w * w - 4.0 * (half - corr)
    d2 = w * w - 4.0 * (half + corr)
    s1 = torch.sqrt(d1.clamp_min(0.0))
    s2 = torch.sqrt(d2.clamp_min(0.0))
    ys = torch.stack([(-w + s1) / 2.0, (-w - s1) / 2.0, (w + s2) / 2.0, (w - s2) / 2.0], dim=-1)
    valid = torch.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], dim=-1) & ~bad_lead[..., None]
    return ys - p[..., None] / 4.0, valid


def p3p_grunert(X: torch.Tensor, x_norm: torch.Tensor):
    """P3P minimal solver (Grunert 1841, in the formulation of Haralick et
    al. 1994).

    X: (..., 3, 3) world points; x_norm: (..., 3, 2) normalized image
    coordinates. Returns (models (..., 4, 12) flattened [R|t], valid
    (..., 4) bool): up to four poses, each its own RANSAC hypothesis.

    A 3-point sample needs ~eps^-3 hypotheses where the 6-point DLT needs
    eps^-6, which keeps registration alive at low inlier ratios."""
    f = torch.cat([x_norm, _ones_col(x_norm)], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)      # unit bearings
    P1, P2, P3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(dim=-1)
    b2 = ((P1 - P3) ** 2).sum(dim=-1)
    c2 = ((P1 - P2) ** 2).sum(dim=-1)
    b2s = torch.where(b2 < 1e-12, 1.0, b2)
    ca = (f[..., 1, :] * f[..., 2, :]).sum(dim=-1)   # cos(alpha): angle opposite side a
    cb = (f[..., 0, :] * f[..., 2, :]).sum(dim=-1)
    cg = (f[..., 0, :] * f[..., 1, :]).sum(dim=-1)
    A = a2 / b2s
    B = c2 / b2s
    AmB = A - B                      # (a^2 - c^2)/b^2
    ApB = A + B
    # Grunert's quartic in v = s3/s1, from the three law-of-cosines
    # constraints
    A4 = (AmB - 1.0) ** 2 - 4.0 * B * ca * ca
    A3 = 4.0 * (AmB * (1.0 - AmB) * cb - (1.0 - ApB) * ca * cg
                + 2.0 * B * ca * ca * cb)
    A2 = 2.0 * (AmB**2 - 1.0 + 2.0 * AmB**2 * cb * cb
                + 2.0 * (1.0 - B) * ca * ca
                - 4.0 * ApB * ca * cb * cg + 2.0 * (1.0 - A) * cg * cg)
    A1 = 4.0 * (-AmB * (1.0 + AmB) * cb + 2.0 * A * cg * cg * cb
                - (1.0 - ApB) * ca * cg)
    A0 = (1.0 + AmB) ** 2 - 4.0 * A * cg * cg
    v, v_ok = _quartic_roots(A4, A3, A2, A1, A0)             # (..., 4)

    degenerate = (a2 < 1e-12) | (b2 < 1e-12) | (c2 < 1e-12)

    # one pose per root; the scalars of the sample broadcast over the roots
    AmB, ca, cb, cg, b2 = (q[..., None] for q in (AmB, ca, cb, cg, b2))
    den = 2.0 * (cg - v * ca)
    den = torch.where(den.abs() < 1e-10, 1e-10, den)
    u = ((-1.0 + AmB) * v * v - 2.0 * AmB * cb * v + 1.0 + AmB) / den
    s1sq = b2 / (1.0 + v * v - 2.0 * v * cb).clamp_min(1e-12)
    s1 = torch.sqrt(s1sq.clamp_min(0.0))
    s2 = u * s1
    s3 = v * s1
    s_ok = (s1 > 1e-9) & (s2 > 1e-9) & (s3 > 1e-9)
    Q = torch.stack([s1, s2, s3], dim=-1)[..., None] * f[..., None, :, :]  # (..., 4, 3, 3)
    # Procrustes: R = nearest rotation to sum_i Q~_i P~_i^T
    X_mean = X.mean(dim=-2)
    Q_mean = Q.mean(dim=-2)
    Pc = X - X_mean[..., None, :]
    Qc = Q - Q_mean[..., None, :]
    R = nearest_rotation(einsum_hp("...vni,...nj->...vij", Qc, Pc))
    t = Q_mean - einsum_hp("...vij,...j->...vi", R, X_mean)
    models = torch.cat([R.reshape(R.shape[:-2] + (9,)), t], dim=-1)
    return models, v_ok & s_ok & ~degenerate[..., None]


# pairwise distance index pairs of the 4 EPnP control points
_EPNP_I = (0, 0, 0, 1, 1, 2)
_EPNP_J = (1, 2, 3, 2, 3, 3)


def epnp(X: torch.Tensor, x_norm: torch.Tensor):
    """EPnP (Lepetit, Moreno-Noguer, Fua 2009) from n >= 4 correspondences.

    X: (..., n, 3) world points; x_norm: (..., n, 2) normalized image
    coordinates. Returns (models (..., 2, 12) flattened [R|t], valid
    (..., 2) bool): the N=1 and N=2 null-space candidates, each its own
    RANSAC hypothesis.

    Next to DLT6/P3P: the control-point formulation stays well-posed on
    planar scenes (where the 6-point DLT's projection-matrix null space is
    rank-deficient) while using every sample point."""
    n = X.shape[-2]
    lead = X.shape[:-2]
    dt, dev = X.dtype, X.device
    # Control points: centroid + principal axes scaled to the data spread.
    c0 = X.mean(dim=-2)
    Xc = X - c0[..., None, :]
    cov = einsum_hp("...ni,...nj->...ij", Xc, Xc) / n
    evals, evecs = eigh_batched(cov)  # ascending
    # Planar data: the smallest axis collapses; give it the mean spread so
    # the control tetrahedron stays affinely independent.
    scale = torch.sqrt(torch.maximum(evals, 1e-6 * evals[..., 2:3].clamp_min(1e-12)))
    ctrl = c0[..., None, :] + (evecs * scale[..., None, :]).transpose(-1, -2)  # c1..c3
    C = torch.cat([c0[..., None, :], ctrl], dim=-2)    # (..., 4, 3)

    # Barycentric coordinates: [C^T; 1] alpha = [X; 1]
    Ch = torch.cat([C.transpose(-1, -2), torch.ones(lead + (1, 4), dtype=dt, device=dev)], dim=-2)
    Xh = torch.cat([X.transpose(-1, -2), torch.ones(lead + (1, n), dtype=dt, device=dev)], dim=-2)
    alphas = torch.linalg.solve_ex(Ch, Xh)[0].transpose(-1, -2)  # (..., n, 4)

    # M (2n, 12): sum_j a_ij (x_j^c - u_i z_j^c) = 0 per image axis, in the
    # column layout (x1, y1, z1, x2, y2, z2, ...).
    u, v = x_norm[..., 0:1], x_norm[..., 1:2]
    zero = torch.zeros_like(alphas)
    rows_u = torch.stack([alphas, zero, -u * alphas], dim=-1)  # (..., n, 4, 3)
    rows_v = torch.stack([zero, alphas, -v * alphas], dim=-1)
    M = torch.cat([rows_u.reshape(lead + (n, 12)), rows_v.reshape(lead + (n, 12))], dim=-2)
    MtM = einsum_hp("...ni,...nj->...ij", M, M)
    _, V = eigh_batched(MtM)
    Cc1 = V[..., :, 0].reshape(lead + (4, 3))  # smallest: camera-frame control points up to scale
    Cc2 = V[..., :, 1].reshape(lead + (4, 3))

    pi = torch.tensor(_EPNP_I, device=dev)
    pj = torch.tensor(_EPNP_J, device=dev)
    dC = torch.linalg.norm(C[..., pi, :] - C[..., pj, :], dim=-1)  # (..., 6) world distances

    def pose_from_ctrl(Cc):
        """[R|t] from camera-frame control points (Procrustes), with the
        sign that makes the mean depth of the data points positive."""
        Pc = matmul_hp(alphas, Cc)  # (..., n, 3) camera-frame data points
        sign = torch.where(Pc[..., 2].mean(dim=-1) < 0, -1.0, 1.0)
        Pc = Pc * sign[..., None, None]
        Pc_mean = Pc.mean(dim=-2)
        Qc = Pc - Pc_mean[..., None, :]
        R = nearest_rotation(einsum_hp("...ni,...nj->...ij", Qc, Xc))
        t = Pc_mean - einsum_hp("...ij,...j->...i", R, c0)
        return torch.cat([R.reshape(lead + (9,)), t], dim=-1)

    # --- N=1: single null vector, scale from the distance ratio
    dv1 = Cc1[..., pi, :] - Cc1[..., pj, :]  # (..., 6, 3)
    d1 = torch.linalg.norm(dv1, dim=-1)
    beta1 = (d1 * dC).sum(dim=-1) / (d1 * d1).sum(dim=-1).clamp_min(1e-12)
    m1 = pose_from_ctrl(Cc1 * beta1[..., None, None])

    # --- N=2: betas from the linearized 3-unknown distance system
    # ||b1 dv1 + b2 dv2||^2 = dC^2, unknowns (b11, b12, b22)
    dv2 = Cc2[..., pi, :] - Cc2[..., pj, :]
    L = torch.stack([
        (dv1 * dv1).sum(dim=-1),
        2.0 * (dv1 * dv2).sum(dim=-1),
        (dv2 * dv2).sum(dim=-1),
    ], dim=-1)  # (..., 6, 3)
    rhs = dC * dC
    Lt = L.transpose(-1, -2)
    LtL = matmul_hp(Lt, L) + 1e-10 * torch.eye(3, dtype=dt, device=dev)
    b = torch.linalg.solve_ex(LtL, matmul_hp(Lt, rhs[..., None]))[0][..., 0]
    b1 = torch.sqrt(b[..., 0].clamp_min(1e-12))
    b2 = b[..., 1] / b1
    m2 = pose_from_ctrl(Cc1 * b1[..., None, None] + Cc2 * b2[..., None, None])

    models = torch.stack([m1, m2], dim=-2)
    finite = torch.isfinite(models).all(dim=-1)
    nondeg = torch.square(Xc).sum(dim=(-2, -1)) > 1e-10
    return models, finite & nondeg[..., None]


def _camera_points(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return einsum_hp("...ij,...nj->...ni", R, X) + t[..., None, :]


def _pinhole(K: torch.Tensor, Xc: torch.Tensor, eps: float):
    """(pixels (..., 2), clamped depth zs, clamp-free mask) of camera-frame
    points (..., 3); |z| below eps is clamped with its sign kept."""
    z = Xc[..., 2]
    zs = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    x, y = Xc[..., 0] / zs, Xc[..., 1] / zs
    u = K[0, 0] * x + K[0, 1] * y + K[0, 2]
    v = K[1, 1] * y + K[1, 2]
    return torch.stack([u, v], dim=-1), zs, z.abs() >= eps


def pinhole_jacobian(K: torch.Tensor, Xc: torch.Tensor, eps: float):
    """Pixels (..., 2) of camera-frame points (..., 3) and their Jacobian
    (..., 2, 3) with respect to the point. Where the depth is clamped
    (|z| < eps) the clamped value is a constant, so the column of z is
    zero there: the derivative that autodiff takes through the `where`."""
    px, zs, free = _pinhole(K, Xc, eps)
    x, y = Xc[..., 0] / zs, Xc[..., 1] / zs
    dz = free.to(Xc.dtype) / zs
    zero = torch.zeros_like(zs)
    du = torch.stack([K[0, 0] / zs, K[0, 1] / zs, -(K[0, 0] * x + K[0, 1] * y) * dz], dim=-1)
    dv = torch.stack([zero, K[1, 1] / zs, -K[1, 1] * y * dz], dim=-1)
    return px, torch.stack([du, dv], dim=-2)


def twist_jacobian(Xc: torch.Tensor) -> torch.Tensor:
    """d(exp(xi) Xc)/d xi at xi = 0 for xi = [w, v]: [-[Xc]_x | I],
    (..., 3, 6)."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    return torch.cat([-hat(Xc), eye], dim=-1)


def project_points(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor
) -> torch.Tensor:
    """Pinhole projection of world points: R (..., 3, 3), t (..., 3),
    X (..., N, 3) -> (..., N, 2) pixels."""
    return _pinhole(K, _camera_points(R, t, X), 1e-8)[0]


def project_residuals_batch(
    K: torch.Tensor, models: torch.Tensor, X: torch.Tensor, x_px: torch.Tensor
) -> torch.Tensor:
    """Reprojection residuals of H pose hypotheses against N shared points.

    models: (..., H, 12) flattened [R | t]; X: (..., N, 3); x_px:
    (..., N, 2). Returns (..., H, N) pixel errors (1e9 behind the camera).
    One (3H, 3) @ (3, N) product instead of H small ones."""
    lead, H = models.shape[:-2], models.shape[-2]
    N = X.shape[-2]
    R_rows = models[..., :9].reshape(lead + (H * 3, 3))
    t = models[..., 9:]
    Xc = matmul_hp(R_rows, X.transpose(-1, -2)).reshape(lead + (H, 3, N)) + t[..., None]
    z = Xc[..., 2, :]
    zs = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)
    u = K[0, 0] * Xc[..., 0, :] / zs + K[0, 1] * Xc[..., 1, :] / zs + K[0, 2]
    v = K[1, 1] * Xc[..., 1, :] / zs + K[1, 2]
    err = torch.hypot(u - x_px[..., None, :, 0], v - x_px[..., None, :, 1])
    return torch.where(z > 1e-6, err, 1e9)


def refine_pose_gn(
    K: torch.Tensor,
    R0: torch.Tensor,
    t0: torch.Tensor,
    X: torch.Tensor,
    x_px: torch.Tensor,
    weights: torch.Tensor,
    iterations: int = 8,
    damping: float = 1e-6,
):
    """Gauss-Newton pose polish on se(3) (motion only, points fixed).

    R0 (..., 3, 3), t0 (..., 3), X (..., N, 3), x_px (..., N, 2), weights
    (..., N). Minimizes the weighted pixel reprojection error over a left
    twist; the 6x6 normal equations are solved per iteration by the
    unrolled Cholesky; a step that raises the cost is not taken."""
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    w = weights[..., None]

    def residuals(R, t):
        return (project_points(K, R, t, X) - x_px) * w

    R, t = R0, t0
    for _ in range(iterations):
        Xc = _camera_points(R, t, X)
        px, Dp = pinhole_jacobian(K, Xc, 1e-8)
        r = (px - x_px) * w                                       # (..., N, 2)
        J = matmul_hp(Dp, twist_jacobian(Xc)) * w[..., None]      # (..., N, 2, 6)
        JtJ = einsum_hp("...nai,...naj->...ij", J, J) + damping * eye6
        Jtr = einsum_hp("...nai,...na->...i", J, r)
        xi = -_chol_solve_unrolled(_cholesky_unrolled(JtJ), Jtr)
        dR, dt = se3_exp(xi)
        Rn = matmul_hp(dR, R)
        tn = einsum_hp("...ij,...j->...i", dR, t) + dt
        c_old = torch.square(r).sum(dim=(-2, -1))
        c_new = torch.square(residuals(Rn, tn)).sum(dim=(-2, -1))
        better = c_new < c_old
        R = torch.where(better[..., None, None], Rn, R)
        t = torch.where(better[..., None], tn, t)
    return R, t


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def pnp_hypothesis_counts(num_hypotheses: int, use_p3p: bool = True) -> Tuple[int, int, int]:
    """(6-point DLT samples, 3-point P3P samples, 8-point EPnP samples) of
    a budget of `num_hypotheses` models: an eighth of the budget in P3P
    samples of 4 models each, a sixteenth in EPnP samples of 2, the rest
    DLT."""
    n_tri = max(num_hypotheses // 8, 1) if use_p3p else 0
    n_ep = max(num_hypotheses // 16, 1) if use_p3p else 0
    return max(num_hypotheses - 4 * n_tri - 2 * n_ep, 1), n_tri, n_ep


def pnp_ransac(
    generator: Optional[torch.Generator],
    K: torch.Tensor,
    X: torch.Tensor,
    x_px: torch.Tensor,
    valid: torch.Tensor,
    num_hypotheses: int = 2048,
    threshold_px: float = 8.0,
    refine_iterations: int = 8,
    sample_indices: Optional[Sequence[torch.Tensor]] = None,
) -> PnPResult:
    """RANSAC PnP at one threshold: the mixed hypothesis pool of
    pnp_ransac_multi + GN polish on the inlier set.

    X: (..., N, 3) padded 3D points, x_px: (..., N, 2) pixels, valid:
    (..., N) mask."""
    thr = torch.tensor([threshold_px], dtype=X.dtype, device=X.device)
    res = pnp_ransac_multi(
        generator, K, X, x_px, valid, thr, num_hypotheses=num_hypotheses,
        refine_iterations=refine_iterations, sample_indices=sample_indices,
    )
    return PnPResult(R=res.R[..., 0, :, :], t=res.t[..., 0, :],
                     inliers=res.inliers[..., 0, :], num_inliers=res.num_inliers[..., 0])


def pnp_ransac_multi(
    generator: Optional[torch.Generator],
    K: torch.Tensor,
    X: torch.Tensor,
    x_px: torch.Tensor,
    valid: torch.Tensor,
    thresholds_px: torch.Tensor,
    num_hypotheses: int = 2048,
    refine_iterations: int = 8,
    use_p3p: bool = True,
    sample_indices: Optional[Sequence[torch.Tensor]] = None,
) -> PnPResult:
    """RANSAC PnP scored against a whole threshold cascade at once.

    X (..., N, 3), x_px (..., N, 2), valid (..., N) with any leading batch
    (the images of a wave); thresholds_px (T,). The hypothesis batch
    (sampling, minimal solves, residuals) is shared by the T thresholds;
    only the vote and the GN polish are per threshold. Result fields carry
    (..., T) in front of their own dimensions.

    The hypothesis pool is mixed, in this order (the vote takes the first
    of equal scores): 6-point DLT samples (accurate when inlier-rich), P3P
    minimal samples (4 solutions per 3-point draw, which survive outlier
    contamination far longer), 8-point EPnP samples (2 candidates each;
    robust on planar scenes).

    sample_indices: pre-drawn (idx6 (..., n_dlt, 6), idx3 (..., n_tri, 3),
    idx8 (..., n_ep, 8)) with the counts of pnp_hypothesis_counts."""
    dt, dev = X.dtype, X.device
    Kinv = torch.linalg.inv(K)
    x_norm = einsum_hp("ij,...nj->...ni", Kinv, homogeneous(x_px))[..., :2]

    # invalid minimal-solver outputs become no-inlier models (t_z = -1e6
    # puts every point behind the camera: residual 1e9)
    dead = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0, 0, 0, -1e6], dtype=dt, device=dev)

    n_dlt, n_tri, n_ep = pnp_hypothesis_counts(num_hypotheses, use_p3p)
    if sample_indices is None:
        sample_indices = [
            _ransac.sample_indices(generator, valid, n, k) if n else None
            for n, k in ((n_dlt, 6), (n_tri, 3), (n_ep, 8))
        ]
    idx6, idx3, idx8 = sample_indices
    X6 = _ransac.gather_rows(X, idx6)
    R, t = pnp_dlt(X6, _ransac.gather_rows(x_norm, idx6), torch.ones_like(X6[..., 0]))
    models = [torch.cat([R.reshape(R.shape[:-2] + (9,)), t], dim=-1)]   # (..., n_dlt, 12)
    for n, idx, solver in ((n_tri, idx3, p3p_grunert), (n_ep, idx8, epnp)):
        if n:
            m, ok = solver(_ransac.gather_rows(X, idx), _ransac.gather_rows(x_norm, idx))
            m = torch.where(ok[..., None], m, dead)
            models.append(m.reshape(m.shape[:-3] + (-1, 12)))
    models = torch.cat(models, dim=-2)                           # (..., H, 12)
    residuals = project_residuals_batch(K, models, X, x_px)      # (..., H, N)

    valid_b = valid > 0
    thr = thresholds_px.to(dt)[:, None, None]                    # (T, 1, 1)
    res_t = residuals[..., None, :, :]                           # (..., 1, H, N)
    valid_t = valid_b[..., None, None, :]
    inl = (res_t < thr) & valid_t                                # (..., T, H, N)
    r2 = torch.minimum(torch.square(res_t), thr * thr)
    score = torch.where(valid_t, r2, 0.0).sum(dim=-1)            # (..., T, H)
    counts = inl.sum(dim=-1)
    norm_score = score / (score.amax(dim=-1, keepdim=True) + 1e-12)
    best = argmax_first(counts.to(torch.float32) - 0.5 * norm_score, -1)   # (..., T)
    T = thresholds_px.shape[0]
    model = _ransac.select_best(models[..., None, :, :].expand(best.shape + models.shape[-2:]),
                                best, 1)                         # (..., T, 12)
    # Polish on the inlier set, then re-evaluate the inliers.
    w = _ransac.select_best(inl, best, 1).to(dt)                 # (..., T, N)
    X_t = X[..., None, :, :].expand(best.shape + X.shape[-2:])
    x_t = x_px[..., None, :, :].expand(best.shape + x_px.shape[-2:])
    R, t = refine_pose_gn(K, model[..., :9].reshape(best.shape + (3, 3)), model[..., 9:],
                          X_t, x_t, w, iterations=refine_iterations)
    polished = torch.cat([R.reshape(best.shape + (9,)), t], dim=-1)[..., None, :]
    err = project_residuals_batch(K, polished, X_t, x_t)[..., 0, :]        # (..., T, N)
    inliers = (err < thresholds_px.to(dt).reshape((T, 1))) & valid_b[..., None, :]
    return PnPResult(R=R, t=t, inliers=inliers, num_inliers=inliers.sum(dim=-1))
