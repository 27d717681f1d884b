"""Multi-device substrate: the mesh over torch.distributed ranks and its
sharding helpers (port of recon3d_tpu/parallel/)."""

from recon3d_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshError,
    make_mesh,
    mesh_shape,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshError",
    "make_mesh",
    "mesh_shape",
]
