"""Dense reconstruction backends (PyTorch port of recon3d_tpu/dense):
plane-sweep stereo, PatchMatch MVS, dense SIFT, the point-cloud filters and
the sharded dense stages (distributed.py)."""

from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS, patchmatch_depth
from recon3d_tpu_torch.dense.plane_sweep import (
    PlaneSweepReconstructor,
    create_combined_dense_cloud,
    sweep_depth_map,
)
from recon3d_tpu_torch.dense.sift_dense import DenseSiftReconstructor
from recon3d_tpu_torch.dense.filters import (
    knn_statistical_filter,
    radius_outlier_filter,
    voxel_downsample,
)

__all__ = [
    "PatchMatchMVS",
    "patchmatch_depth",
    "PlaneSweepReconstructor",
    "create_combined_dense_cloud",
    "sweep_depth_map",
    "DenseSiftReconstructor",
    "knn_statistical_filter",
    "radius_outlier_filter",
    "voxel_downsample",
]
