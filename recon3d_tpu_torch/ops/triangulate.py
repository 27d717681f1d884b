"""Batched DLT triangulation and track validation.

PyTorch port of recon3d_tpu/ops/triangulate.py: fully vectorized, masked
functions; the DLT null space comes from eigh of the 4x4 normal matrix.
"""

from __future__ import annotations

import torch

from recon3d_tpu_torch.ops.linalg import einsum_hp, smallest_eigvec


def _dlt_rows(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per observation: (..., 3, 4), (..., 2) -> (..., 2, 4)."""
    r0 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    rows = torch.stack([r0, r1], dim=-2)
    # Row normalization improves the conditioning of A^T A.
    norm = torch.linalg.norm(rows, dim=-1, keepdim=True)
    return rows / norm.clamp_min(1e-12)


def _null_point(A: torch.Tensor) -> torch.Tensor:
    """World point (..., 3) from DLT rows A (..., R, 4)."""
    AtA = einsum_hp("...ki,...kj->...ij", A, A)
    X = smallest_eigvec(AtA)
    w = X[..., 3:4]
    w = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12).to(w.dtype), w)
    return X[..., :3] / w


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Two-view DLT triangulation.

    P1, P2: (..., 3, 4) projection matrices (K [R|t]).
    x1, x2: (..., N, 2) pixel observations.
    Returns (..., N, 3) world points."""
    A = torch.cat(
        [
            _dlt_rows(P1[..., None, :, :], x1),
            _dlt_rows(P2[..., None, :, :], x2),
        ],
        dim=-2,
    )  # (..., N, 4, 4)
    return _null_point(A)


def triangulate_nview(Ps: torch.Tensor, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """N-view masked DLT: Ps (V, 3, 4), xs (..., V, 2), mask (..., V) ->
    (..., 3). Invalid views contribute zero rows; needs >= 2 valid views
    for a well-posed solve (the caller gates on that)."""
    rows = _dlt_rows(Ps, xs) * mask[..., None, None]   # (..., V, 2, 4)
    return _null_point(rows.reshape(rows.shape[:-3] + (-1, 4)))


def reprojection_errors(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Pixel reprojection error of world points X (..., 3) against the
    observations x. Points behind the camera get a large finite error, so
    masked reductions stay NaN-free."""
    Xc = einsum_hp("...ij,...j->...i", R, X) + t
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-8, 1e-8, z)
    uv = Xc[..., :2] / zs[..., None]
    u = K[..., 0, 0] * uv[..., 0] + K[..., 0, 1] * uv[..., 1] + K[..., 0, 2]
    v = K[..., 1, 1] * uv[..., 1] + K[..., 1, 2]
    err = torch.linalg.norm(torch.stack([u, v], dim=-1) - x, dim=-1)
    return torch.where(z > 1e-6, err, 1e9)


def triangulation_angles(C1: torch.Tensor, C2: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Parallax angle (degrees) at X between camera centers C1, C2."""
    r1 = C1 - X
    r2 = C2 - X
    cosang = (r1 * r2).sum(dim=-1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    )
    return torch.rad2deg(torch.acos(cosang.clamp(-1.0, 1.0)))


def validate_triangulation(
    K: torch.Tensor,
    R1: torch.Tensor,
    t1: torch.Tensor,
    R2: torch.Tensor,
    t2: torch.Tensor,
    X: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    max_reproj_px: float = 4.0,
    min_parallax_deg: float = 1.0,
    max_depth_factor: float = 200.0,
) -> torch.Tensor:
    """Vectorized validity mask over triangulated points X (..., N, 3),
    with poses R (..., 3, 3), t (..., 3) and pixels x (..., N, 2):
      1. cheirality in both cameras (z > 0),
      2. depth < max_depth_factor * baseline,
      3. parallax >= min_parallax_deg,
      4. reprojection error <= max_reproj_px in both views."""
    z1 = (einsum_hp("...ij,...nj->...ni", R1, X) + t1[..., None, :])[..., 2]
    z2 = (einsum_hp("...ij,...nj->...ni", R2, X) + t2[..., None, :])[..., 2]
    cheirality = (z1 > 1e-6) & (z2 > 1e-6)

    C1 = -einsum_hp("...ji,...j->...i", R1, t1)
    C2 = -einsum_hp("...ji,...j->...i", R2, t2)
    limit = max_depth_factor * (torch.linalg.norm(C2 - C1, dim=-1, keepdim=True) + 1e-12)
    depth_ok = (z1 < limit) & (z2 < limit)

    parallax_ok = triangulation_angles(C1[..., None, :], C2[..., None, :], X) >= min_parallax_deg

    e1 = reprojection_errors(K, R1[..., None, :, :], t1[..., None, :], X, x1)
    e2 = reprojection_errors(K, R2[..., None, :, :], t2[..., None, :], X, x2)
    reproj_ok = (e1 <= max_reproj_px) & (e2 <= max_reproj_px)

    return cheirality & depth_ok & parallax_ok & reproj_ok
