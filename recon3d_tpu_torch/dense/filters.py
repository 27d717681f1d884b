"""Point-cloud filtering: statistical k-NN outlier removal, radius filter,
voxel downsampling.

PyTorch port of recon3d_tpu/dense/filters.py. The k-NN mean distances are
K2 (kernels/pointcloud.py: a CUDA kernel on the card, its plain version
on the CPU) under the JAX native search's ring rule, and the voxel dedup
runs as torch ops on the device, so the points kept are the JAX package's
native path's. The threshold is taken with numpy in float32 from the
pulled distances, as the JAX function takes it.

`knn_statistical_filter`, `voxel_downsample` and `bbox_voxel_downsample`
take numpy points, which they move to `device` (the card unless the
caller asks for the CPU), or a torch tensor, which stays on its device;
they return points of the kind they were given, and numpy colours.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from recon3d_tpu_torch.kernels import pointcloud
from recon3d_tpu_torch.runtime.device import resolve_device

Points = Union[np.ndarray, torch.Tensor]


def radius_outlier_filter(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    percentile: float = 95.0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Drop points farther from the centroid than the Nth percentile radius
    (reference dense_stereo.py:463-473)."""
    if len(points) == 0:
        return points, colors
    c = points.mean(axis=0)
    r = np.linalg.norm(points - c, axis=1)
    keep = r <= np.percentile(r, percentile)
    return points[keep], (colors[keep] if colors is not None else None)


def _on_device(points: Points, device) -> torch.Tensor:
    if torch.is_tensor(points):
        return points.to(torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(resolve_device(device))


def _select(points: Points, colors: Optional[np.ndarray], keep: np.ndarray):
    """points[keep] in their own kind (a tensor on its device), colors[keep]."""
    if torch.is_tensor(points):
        picked = points[torch.from_numpy(keep).to(points.device)]
    else:
        picked = points[keep]
    return picked, (colors[keep] if colors is not None else None)


def knn_statistical_filter(
    points: Points,
    colors: Optional[np.ndarray] = None,
    k: int = 20,
    std_factor: float = 2.5,
    max_points: int = 2_000_000,
    device="cuda",
) -> Tuple[Points, Optional[np.ndarray]]:
    """Remove points whose mean k-NN distance exceeds mu + std_factor*sigma
    (reference dense.py:261-275), the distances from K2."""
    n = len(points)
    if n < k + 1:
        return points, colors
    mean_d = pointcloud.knn_mean_dist(_on_device(points, device), k).cpu().numpy()
    mu = mean_d.mean()
    sigma = mean_d.std()
    return _select(points, colors, mean_d <= mu + std_factor * sigma)


def voxel_downsample(
    points: Points,
    colors: Optional[np.ndarray] = None,
    voxel_size: float = 0.02,
    device="cuda",
) -> Tuple[Points, Optional[np.ndarray]]:
    """Keep the first point of every occupied voxel (reference
    dense_stereo.py:475-492), on the device."""
    if len(points) == 0 or voxel_size <= 0:
        return points, colors
    keep = pointcloud.voxel_first_indices(_on_device(points, device), float(voxel_size))
    return _select(points, colors, keep.cpu().numpy())


def bbox_voxel_downsample(
    points: Points,
    colors: Optional[np.ndarray] = None,
    divisions: int = 1200,
    device="cuda",
) -> Tuple[Points, Optional[np.ndarray]]:
    """Voxel dedup with cell = bbox diagonal / divisions (reference
    dense.py:283-314)."""
    if len(points) == 0:
        return points, colors
    if torch.is_tensor(points):
        hi, lo = (v.values.cpu().numpy() for v in (points.max(0), points.min(0)))
    else:
        hi, lo = points.max(0), points.min(0)
    diag = np.linalg.norm(hi - lo)
    return voxel_downsample(points, colors, max(diag / divisions, 1e-9), device)
