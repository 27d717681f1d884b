"""A chessboard rendered through the full K + distortion + pose model with
the port's ops and no JAX: tests/render.py::render_chessboard's formula
(unit squares at integer board coordinates, the corner pixels the distorted
projections of the integer board points) with the port's undistort_points,
so3_exp and gaussian_blur, numpy outside them. chip_smoke.py renders its
calibration boards with it on a machine without JAX."""

from typing import Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import gaussian_blur, undistort_points
from recon3d_tpu_torch.ops.lie import so3_exp


def render_chessboard(
    K: np.ndarray,
    dist: np.ndarray,
    rvec: np.ndarray,
    tvec: np.ndarray,
    image_size: Tuple[int, int] = (240, 320),
    pattern: Tuple[int, int] = (9, 6),
    blur_sigma: float = 0.8,
) -> np.ndarray:
    H, W = image_size
    cols, rows = pattern
    R = so3_exp(torch.as_tensor(np.asarray(rvec, np.float32))).numpy()

    ys, xs = np.meshgrid(np.arange(H) + 0.0, np.arange(W) + 0.0, indexing="ij")
    xn = (xs - K[0, 2]) / K[0, 0]
    yn = (ys - K[1, 2]) / K[1, 1]
    und = undistort_points(
        torch.from_numpy(np.stack([xn, yn], -1).astype(np.float32)),
        torch.from_numpy(np.asarray(dist, np.float32)),
        iterations=20,
    ).numpy()
    d = np.concatenate([und, np.ones((H, W, 1))], axis=-1)  # camera-frame rays
    n = R[:, 2]  # board normal in camera frame
    denom = d @ n
    s = (np.asarray(tvec) @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    Xc = s[..., None] * d
    Xb = (Xc - tvec) @ R  # board frame (z ~ 0)
    u, v = Xb[..., 0], Xb[..., 1]
    inside = (u > -1) & (u < cols) & (v > -1) & (v < rows) & (s > 0)
    checker = ((np.floor(u) + np.floor(v)).astype(int) % 2 == 0)
    img = np.where(inside, np.where(checker, 0.95, 0.08), 0.5).astype(np.float32)
    return gaussian_blur(torch.from_numpy(img), blur_sigma).numpy()


def board_poses(n: int, K: np.ndarray, dist: np.ndarray, image_size: Tuple[int, int],
                pattern: Tuple[int, int] = (9, 6), seed: int = 3):
    """n board poses (rvec, tvec) drawn as tests/test_calibration.py::_poses
    draws them (tilted, rotated, at a varying distance), resampled until
    every corner projects inside the image with a margin of 1/32 of its
    width (10 px at 320). Returns the poses and their true corners (n, N, 2)."""
    from recon3d_tpu_torch.calib.calibrate import _project, board_points

    H, W = image_size
    margin = W / 32.0
    cam = torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2], *np.asarray(dist)[:4]],
                       dtype=torch.float32)
    X = torch.from_numpy(board_points(pattern))
    rng = np.random.default_rng(seed)
    poses, corners = [], []
    while len(poses) < n:
        rvec = np.array([0.25 * rng.normal(), 0.25 * rng.normal(), 0.2 * rng.normal()],
                        np.float32)
        tvec = np.array([-4.0 + 0.5 * rng.normal(), -2.5 + 0.4 * rng.normal(),
                         10.0 + 1.5 * rng.normal()], np.float32)
        gt = _project(cam, torch.from_numpy(rvec), torch.from_numpy(tvec), X).numpy()
        if ((gt[:, 0] > margin).all() and (gt[:, 0] < W - margin).all()
                and (gt[:, 1] > margin).all() and (gt[:, 1] < H - margin).all()):
            poses.append((rvec, tvec))
            corners.append(gt)
    return poses, np.stack(corners)
