"""Multi-device substrate: the mesh over torch.distributed ranks and its
sharding helpers (port of recon3d_tpu/parallel/). `__all__` holds the JAX
package's names; Mesh, MeshError and mesh_shape, which the port adds, are
imported from here by name."""

from recon3d_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshError,
    data_sharding,
    make_mesh,
    mesh_shape,
    pad_to_multiple,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "data_sharding",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "shard_batch",
]
