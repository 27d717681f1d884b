"""PLY and COLMAP I/O and image loading (PyTorch port of recon3d_tpu/io)."""

from recon3d_tpu_torch.io.ply import load_ply, save_ply, save_cameras_ply, compute_scene_bounds
from recon3d_tpu_torch.io.colmap import (
    ColmapModel,
    load_colmap_text,
    save_colmap_text,
)

__all__ = [
    "load_ply",
    "save_ply",
    "save_cameras_ply",
    "compute_scene_bounds",
    "ColmapModel",
    "load_colmap_text",
    "save_colmap_text",
]
