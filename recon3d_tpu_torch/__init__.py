"""recon3d_tpu_torch: the PyTorch/CUDA port of recon3d_tpu.

A second package beside the JAX one, with the same layout, module names and
public names. It imports torch and never jax or recon3d_tpu. Its
hand-written CUDA kernels live in csrc/ and are bound in kernels/, each
built on its first launch, not on import. Entry points run on "cuda" unless
the caller passes device="cpu".

Ported: incremental SfM (`SfMPipeline.reconstruct`), the dense backends
(PatchMatch, plane sweep, dense SIFT) and the TSDF mesh, COLMAP and PLY
I/O, stage checkpoints, and the CLI `python -m recon3d_tpu_torch.cli`
(see ROADMAP.md for what is still to come).
"""

from recon3d_tpu_torch.camera import Camera, CameraPose, load_calibration
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from recon3d_tpu_torch.io.ply import load_ply, save_ply, save_cameras_ply
from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS
from recon3d_tpu_torch.dense.plane_sweep import PlaneSweepReconstructor
from recon3d_tpu_torch.dense.sift_dense import DenseSiftReconstructor

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraPose",
    "load_calibration",
    "ReconstructionConfig",
    "SfMPipeline",
    "PatchMatchMVS",
    "PlaneSweepReconstructor",
    "DenseSiftReconstructor",
    "load_ply",
    "save_ply",
    "save_cameras_ply",
]
