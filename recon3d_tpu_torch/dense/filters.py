"""Point-cloud filtering: radius filter and voxel downsampling.

PyTorch port of recon3d_tpu/dense/filters.py: `radius_outlier_filter` and
`voxel_downsample`, copied. Host-side numpy; the native C++ fast path of
runtime/native.py is used when the shared library is present.
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
