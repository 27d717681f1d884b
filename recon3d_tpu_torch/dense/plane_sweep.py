"""Depth-map fusion helpers shared by the dense backends.

PyTorch port of the parts of recon3d_tpu/dense/plane_sweep.py that
PatchMatch uses: `backproject_depth` (:296-311) with the batch over views
that `_fuse_program` jits (:286-293), `fused_points_compact` with
`_compact_masked` (:314-346), `depth_range_from_poses` and
`depth_range_from_sparse` (:349-368). The plane sweep itself is a later
slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def backproject_depth(
    depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
    valid: torch.Tensor,
):
    """Depth map(s) -> world points (..., H*W, 3) + mask (..., H*W).

    depth (..., H, W) with R (..., 3, 3), t (..., 3) and valid (..., H, W)
    for the same leading views; K (3, 3) shared. Invalid pixels keep their
    back-projected point with mask False."""
    H, W = depth.shape[-2], depth.shape[-1]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    x = (xs - K[0, 2]) / K[0, 0] * depth
    y = (ys - K[1, 2]) / K[1, 1] * depth
    lead = depth.shape[:-2]
    Xc = torch.stack([x, y, depth], dim=-1).reshape(lead + (H * W, 3))
    # einsum("ji,nj->ni", R, Xc - t) == (Xc - t) @ R
    Xw = torch.matmul(Xc - t[..., None, :], R)
    return Xw, valid.reshape(lead + (H * W,))


def _compact_masked(pts: torch.Tensor, mask: torch.Tensor):
    """Rows of (N, 3) points where mask is set, and their flat indices, in
    index order. Dynamic shapes make the JAX version's fixed capacity
    buckets unnecessary."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
    return pts.reshape(-1, 3).index_select(0, idx), idx


def fused_points_compact(pts_b: torch.Tensor, mask_b: torch.Tensor):
    """Compact on the device, download only the selected points. Returns
    (points (M, 3) float32 numpy, flat_indices (M,) int64 numpy)."""
    taken, idx = _compact_masked(pts_b, mask_b)
    return (
        taken.cpu().numpy().astype(np.float32),
        idx.cpu().numpy().astype(np.int64),
    )


def depth_range_from_poses(Rs: np.ndarray, ts: np.ndarray) -> Tuple[float, float]:
    """Depth bounds from the camera-center spread (reference :86-92)."""
    C = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    spread = np.linalg.norm(C - C.mean(0), axis=1).max() * 2 + 1e-6
    return 0.5 * spread, 20.0 * spread


def depth_range_from_sparse(
    points: np.ndarray, R: np.ndarray, t: np.ndarray
) -> Optional[Tuple[float, float]]:
    """1st/99th percentile of sparse depths x1.5 margin (reference
    mvs_patchmatch.py:141-165)."""
    if len(points) < 20:
        return None
    z = (points @ R.T + t)[:, 2]
    z = z[z > 1e-6]
    if len(z) < 20:
        return None
    lo, hi = np.percentile(z, [1, 99])
    return float(max(lo / 1.5, 1e-3)), float(hi * 1.5)
