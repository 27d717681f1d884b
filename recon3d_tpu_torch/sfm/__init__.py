"""Incremental and global SfM and bundle adjustment (PyTorch port of
recon3d_tpu/sfm)."""

from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from recon3d_tpu_torch.sfm.bundle import bundle_adjust

__all__ = ["SfMPipeline", "bundle_adjust"]
