"""SO(3)/SE(3) exponential and logarithm maps.

PyTorch port of recon3d_tpu/ops/lie.py: batched, differentiable maps used
by pose refinement and bundle adjustment. All functions broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _coefficients(theta2: torch.Tensor):
    """sin(t)/t and (1-cos(t))/t^2, with their series near t = 0 so that
    the maps stay differentiable there."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    return theta, small, A, B


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    _, _, A, B = _coefficients((w * w).sum(-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_exp_jacobian(w: torch.Tensor) -> torch.Tensor:
    """d so3_exp(w) / d w_k as (..., 3, 3, 3), the derivative index first
    of the three: out[..., k, :, :] = dR/dw_k. Written out from
    R = I + A W + B W^2 with the branches of `_coefficients`, so that it is
    the derivative autodiff takes of so3_exp."""
    theta2 = (w * w).sum(-1)
    theta, small, A, B = _coefficients(theta2)
    sin, cos = torch.sin(theta), torch.cos(theta)
    # dA/d(theta2) and dB/d(theta2), with d theta / d theta2 = 1 / (2 theta)
    dA = torch.where(small, -1.0 / 6.0, (theta * cos - sin) / (theta * theta) / (2.0 * theta))
    den = theta2 + _EPS
    dB = torch.where(small, -1.0 / 24.0, (sin / (2.0 * theta) * den - (1.0 - cos)) / (den * den))
    W = hat(w)
    W2 = W @ W
    G = hat(torch.eye(3, dtype=w.dtype, device=w.device))            # (3, 3, 3) generators
    radial = dA[..., None, None] * W + dB[..., None, None] * W2      # (..., 3, 3)
    GW = G @ W[..., None, :, :] + W[..., None, :, :] @ G             # (..., 3, 3, 3)
    return (2.0 * w[..., None, None] * radial[..., None, :, :]
            + A[..., None, None, None] * G + B[..., None, None, None] * GW)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3): the trace
    formulation, clamped; accurate away from theta = pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) * 0.5).clamp(-1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.acos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    scale = torch.where(
        theta < 1e-5, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.sin(theta) + _EPS),
    )
    return v * scale[..., None]


def se3_exp(xi: torch.Tensor):
    """se(3) twist (..., 6) = [w, v] -> (R (..., 3, 3), t (..., 3)), with
    t = V(w) v for the left Jacobian V."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    _, small, A, B = _coefficients(theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    return R, torch.einsum("...ij,...j->...i", V, v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist (..., 6) = [w, v] with v = V(w)^-1 t."""
    w = so3_log(R)
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    # V^-1 = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + _EPS)) / (theta2 + _EPS),
    )
    W = hat(w)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * (W @ W)
    return torch.cat([w, torch.einsum("...ij,...j->...i", Vinv, t)], dim=-1)
