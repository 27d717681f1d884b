"""Point-cloud filtering: statistical k-NN outlier removal, radius filter,
voxel downsampling.

PyTorch port of recon3d_tpu/dense/filters.py, copied. Host-side numpy; the
native C++ fast path of runtime/native.py is used when the shared library
is present, else numpy or scipy's cKDTree, as in the JAX package
(`native_available()` says which ran).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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


def knn_statistical_filter(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    k: int = 20,
    std_factor: float = 2.5,
    max_points: int = 2_000_000,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Remove points whose mean k-NN distance exceeds mu + std_factor*sigma
    (reference dense.py:261-275). Uses the native grid-hash implementation
    when available, else scipy cKDTree."""
    n = len(points)
    if n < k + 1:
        return points, colors

    from recon3d_tpu_torch.runtime.native import native_knn_mean_dist

    mean_d = native_knn_mean_dist(points.astype(np.float32), k)
    if mean_d is None:
        from scipy.spatial import cKDTree

        tree = cKDTree(points)
        d, _ = tree.query(points, k=k + 1, workers=-1)
        mean_d = d[:, 1:].mean(axis=1)

    mu = mean_d.mean()
    sigma = mean_d.std()
    keep = mean_d <= mu + std_factor * sigma
    return points[keep], (colors[keep] if colors is not None else None)


def voxel_downsample(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    voxel_size: float = 0.02,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Keep one point per occupied voxel (reference dense_stereo.py:475-492)."""
    if len(points) == 0 or voxel_size <= 0:
        return points, colors

    from recon3d_tpu_torch.runtime.native import native_voxel_downsample

    keep = native_voxel_downsample(points.astype(np.float32), float(voxel_size))
    if keep is None:
        cells = np.floor(points / voxel_size).astype(np.int64)
        # hash cells; unique keeps first occurrence
        h = (
            cells[:, 0] * 73856093 ^ cells[:, 1] * 19349663 ^ cells[:, 2] * 83492791
        )
        _, keep = np.unique(h, return_index=True)
        keep = np.sort(keep)
    return points[keep], (colors[keep] if colors is not None else None)


def bbox_voxel_downsample(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    divisions: int = 1200,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Voxel dedup with cell = bbox diagonal / divisions (reference
    dense.py:283-314)."""
    if len(points) == 0:
        return points, colors
    diag = np.linalg.norm(points.max(0) - points.min(0))
    return voxel_downsample(points, colors, max(diag / divisions, 1e-9))
