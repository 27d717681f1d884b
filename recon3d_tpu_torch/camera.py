"""Camera intrinsics and extrinsics as plain dataclasses over tensors.

PyTorch port of recon3d_tpu/camera.py (Camera :26-109, CameraPose :112-155,
stack_poses :158-162, projection_from_KRt :165-168, load_calibration
:171-182). The JAX package uses
flax.struct pytrees so cameras batch under vmap; here they are plain
dataclasses holding float32 torch tensors, batched by a leading dimension.

Conventions (same as the reference):
  - K is the 3x3 intrinsic matrix; images are undistorted at load time.
  - CameraPose (R, t) maps world -> camera:  x_cam = R @ x_world + t.
  - camera center C = -R^T t.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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

    @property
    def fx(self) -> torch.Tensor:
        return self.K[..., 0, 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.K[..., 1, 1]

    @property
    def cx(self) -> torch.Tensor:
        return self.K[..., 0, 2]

    @property
    def cy(self) -> torch.Tensor:
        return self.K[..., 1, 2]

    def scaled(self, scale: float) -> "Camera":
        """Intrinsics for an image resized by `scale` (used by dense backends)."""
        S = torch.tensor(
            [[scale, 0.0, 0.0], [0.0, scale, 0.0], [0.0, 0.0, 1.0]],
            dtype=self.K.dtype, device=self.K.device,
        )
        return Camera(K=S @ self.K, dist=self.dist)

    def project(self, points_cam: torch.Tensor) -> torch.Tensor:
        """Project camera-frame 3D points to pixels (pinhole, no distortion).

        points_cam: (..., 3) -> (..., 2). z is clamped away from 0 to avoid
        NaNs; callers gate on z > 0."""
        z = points_cam[..., 2:3]
        z = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8).to(z.dtype), z)
        xy = points_cam[..., :2] / z
        u = self.fx * xy[..., 0] + self.K[..., 0, 1] * xy[..., 1] + self.cx
        v = self.fy * xy[..., 1] + self.cy
        return torch.stack([u, v], dim=-1)

    def unproject(self, pixels: torch.Tensor, depth=1.0) -> torch.Tensor:
        """Back-project pixels to camera-frame rays scaled by depth.

        pixels: (..., 2), depth scalar or (...,) -> (..., 3)."""
        depth = torch.as_tensor(depth, dtype=pixels.dtype, device=pixels.device)
        x = (pixels[..., 0] - self.cx) / self.fx
        y = (pixels[..., 1] - self.cy) / self.fy
        d = torch.broadcast_to(depth, x.shape)
        return torch.stack([x * d, y * d, d], dim=-1)

    def normalized(self, pixels: torch.Tensor) -> torch.Tensor:
        """Pixel -> normalized image coordinates (z=1 plane)."""
        return self.unproject(pixels, 1.0)[..., :2]


@dataclass(frozen=True)
class CameraPose:
    """World -> camera rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=()) -> "CameraPose":
        batch_shape = tuple(batch_shape)
        R = torch.eye(3).expand(batch_shape + (3, 3)).clone()
        return cls(R=R, t=torch.zeros(batch_shape + (3,)))

    @property
    def center(self) -> torch.Tensor:
        """Camera center in world frame: C = -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)

    @property
    def projection_matrix(self) -> torch.Tensor:
        """[R | t], (..., 3, 4)."""
        return torch.cat([self.R, self.t[..., :, None]], dim=-1)

    def transform_points(self, points_world: torch.Tensor) -> torch.Tensor:
        """(..., N, 3) world -> camera frame."""
        return (torch.einsum("...ij,...nj->...ni", self.R, points_world)
                + self.t[..., None, :])

    def inverse(self) -> "CameraPose":
        Rt = self.R.transpose(-1, -2)
        return CameraPose(R=Rt, t=-torch.einsum("...ij,...j->...i", Rt, self.t))

    def compose(self, other: "CameraPose") -> "CameraPose":
        """self o other: apply `other` first, then `self`."""
        return CameraPose(
            R=self.R @ other.R,
            t=torch.einsum("...ij,...j->...i", self.R, other.t) + self.t,
        )

    def look_at(self) -> torch.Tensor:
        """Unit forward (+z of camera) direction in world frame."""
        return self.R[..., 2, :]


def stack_poses(poses) -> CameraPose:
    """Stack a list of CameraPose into one batched CameraPose."""
    return CameraPose(
        R=torch.stack([p.R for p in poses]), t=torch.stack([p.t for p in poses])
    )


def projection_from_KRt(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t], (..., 3, 4)."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def load_calibration(path: str) -> Camera:
    """Load a .npz calibration file (keys mtx, dist) into a Camera; a
    distortion vector shorter than 5 is zero-padded."""
    data = np.load(path)
    K = np.asarray(data["mtx"], dtype=np.float32)
    dist = np.asarray(data["dist"], dtype=np.float32).reshape(-1)
    if dist.size < 5:
        dist = np.pad(dist, (0, 5 - dist.size))
    return Camera(K=torch.from_numpy(K), dist=torch.from_numpy(dist[:5].copy()))
