"""Camera intrinsics and extrinsics as plain dataclasses over tensors.

PyTorch port of recon3d_tpu/camera.py (Camera :26-109, CameraPose :112-155,
stack_poses :158-162). The JAX package uses
flax.struct pytrees so cameras batch under vmap; here they are plain
dataclasses holding float32 torch tensors, batched by a leading dimension.

Conventions (same as the reference):
  - K is the 3x3 intrinsic matrix; images are undistorted at load time.
  - CameraPose (R, t) maps world -> camera:  x_cam = R @ x_world + t.
  - camera center C = -R^T t.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclass(frozen=True)
class Camera:
    """Pinhole camera intrinsics (+ stored distortion for undistort-at-load).

    K:    (..., 3, 3) intrinsic matrix.
    dist: (..., 5) OpenCV-convention distortion [k1, k2, p1, p2, k3].
    """

    K: torch.Tensor
    dist: torch.Tensor

    @classmethod
    def create(cls, fx, fy, cx, cy, skew=0.0, dist=None) -> "Camera":
        K = _f32([[fx, skew, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        dist = torch.zeros(5) if dist is None else _f32(dist)
        return cls(K=K, dist=dist)

    @classmethod
    def from_matrix(cls, K, dist=None) -> "Camera":
        K = _f32(K)
        if dist is None:
            dist = torch.zeros(K.shape[:-2] + (5,))
        else:
            dist = _f32(dist)
        return cls(K=K, dist=dist)

    def scaled(self, scale: float) -> "Camera":
        """Intrinsics for an image resized by `scale` (used by dense backends)."""
        S = torch.tensor(
            [[scale, 0.0, 0.0], [0.0, scale, 0.0], [0.0, 0.0, 1.0]],
            dtype=self.K.dtype, device=self.K.device,
        )
        return Camera(K=S @ self.K, dist=self.dist)


@dataclass(frozen=True)
class CameraPose:
    """World -> camera rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @property
    def center(self) -> torch.Tensor:
        """Camera center in world frame: C = -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)

    def look_at(self) -> torch.Tensor:
        """Unit forward (+z of camera) direction in world frame."""
        return self.R[..., 2, :]


def stack_poses(poses) -> CameraPose:
    """Stack a list of CameraPose into one batched CameraPose."""
    return CameraPose(
        R=torch.stack([p.R for p in poses]), t=torch.stack([p.t for p in poses])
    )
