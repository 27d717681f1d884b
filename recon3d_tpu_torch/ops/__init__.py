"""Batched geometry and vision ops (PyTorch port of recon3d_tpu/ops): the
Lie maps, linear algebra, triangulation and epipolar geometry, plus the
image ops, RANSAC, PnP, SIFT and matching in their own modules."""

from recon3d_tpu_torch.ops.lie import so3_exp, so3_log, se3_exp, se3_log
from recon3d_tpu_torch.ops.linalg import smallest_eigvec, nearest_rotation
from recon3d_tpu_torch.ops.triangulate import (
    triangulate_dlt,
    triangulate_nview,
    validate_triangulation,
    reprojection_errors,
)
from recon3d_tpu_torch.ops.epipolar import (
    fundamental_8point,
    essential_from_fundamental,
    decompose_essential,
    recover_pose,
    sampson_distance,
    epipolar_distance,
)

__all__ = [
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "smallest_eigvec",
    "nearest_rotation",
    "triangulate_dlt",
    "triangulate_nview",
    "validate_triangulation",
    "reprojection_errors",
    "fundamental_8point",
    "essential_from_fundamental",
    "decompose_essential",
    "recover_pose",
    "sampson_distance",
    "epipolar_distance",
]
