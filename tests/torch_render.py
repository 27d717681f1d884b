"""tests/render.py's distorted capture without JAX.

tests/render.py undistorts the pixel grid of a distorted render with the
JAX package's undistort_points, so a machine without JAX cannot render a
capture through a lens. `render_views` here renders the same views (the
same camera arc, planes, textures and tint) with numpy and the port's
recon3d_tpu_torch/ops/image.py::undistort_points on the CPU;
tests/test_torch_robustness.py holds it to tests.render.render_views.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import undistort_points
from tests.render import Plane, _value_noise, default_scene_planes


def _arc_poses(n_views: int, arc_step: float, arc_offset: float, rng_seed: int):
    """tests.render.render_views' camera arc (no roll): world-to-camera R, t."""
    rng = np.random.default_rng(rng_seed)
    Rs, ts = [], []
    for i in range(n_views):
        theta = (i - (n_views - 1) / 2.0) * arc_step + arc_offset
        C = np.array([3.5 * np.sin(theta), -0.3 + 0.1 * rng.normal(), -3.5 * np.cos(theta)])
        z = -C / np.linalg.norm(C)
        x = np.cross(np.array([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=0)
        Rs.append(R.astype(np.float32))
        ts.append((-R @ C).astype(np.float32))
    return Rs, ts


def render_views(
    n_views: int = 6,
    image_size: Tuple[int, int] = (192, 256),
    planes: Optional[List[Plane]] = None,
    rng_seed: int = 0,
    arc_step: float = 0.12,
    arc_offset: float = 0.0,
    dist: Optional[np.ndarray] = None,
) -> dict:
    """tests.render.render_views(...) for cameras with (K, dist): each
    pixel's ray goes through its undistorted normalized coordinates (20
    fixed-point iterations, as there). Returns the same dict: images (V, H,
    W, 3) float32, K, Rs, ts, depth, image_size."""
    planes = planes or default_scene_planes()
    H, W = image_size
    f = 0.9 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]], np.float32)
    Rs, ts = _arc_poses(n_views, arc_step, arc_offset, rng_seed)

    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    xn = (xs - K[0, 2]) / K[0, 0]
    yn = (ys - K[1, 2]) / K[1, 1]
    if dist is not None and np.any(np.abs(np.asarray(dist)) > 1e-12):
        und = undistort_points(
            torch.from_numpy(np.stack([xn, yn], -1).astype(np.float32)),
            torch.from_numpy(np.asarray(dist, np.float32)),
            iterations=20,
        ).numpy()
        xn, yn = und[..., 0], und[..., 1]
    dirs_cam = np.stack([xn, yn, np.ones_like(xs)], axis=-1)

    images = np.zeros((n_views, H, W, 3), np.float32)
    depths = np.zeros((n_views, H, W), np.float32)
    for vi, (R, t) in enumerate(zip(Rs, ts)):
        C = -R.T @ t
        dirs = dirs_cam @ R
        best_t = np.full((H, W), np.inf)
        shade = np.zeros((H, W))
        for p in planes:
            n = p.normal
            denom = dirs @ n
            tt = ((p.origin - C) @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            pt = C + tt[..., None] * dirs
            lu = (pt - p.origin) @ p.u
            lv = (pt - p.origin) @ p.v
            hit = (tt > 0.1) & (np.abs(lu) <= p.half_u) & (np.abs(lv) <= p.half_v)
            closer = hit & (tt < best_t)
            tex = _value_noise(np.where(closer, lu / p.half_u, 0.0),
                               np.where(closer, lv / p.half_v, 0.0), p.seed)
            shade = np.where(closer, 0.15 + 0.8 * tex, shade)
            best_t = np.where(closer, tt, best_t)
        img = np.repeat(shade[..., None], 3, axis=-1).astype(np.float32)
        images[vi] = img * np.array([1.0, 0.95, 0.9], np.float32)
        depths[vi] = np.where(np.isfinite(best_t), best_t, 0.0)

    return dict(images=images, K=K, Rs=np.array(Rs), ts=np.array(ts), depth=depths,
                image_size=image_size)
