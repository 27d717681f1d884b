"""Multi-device dense reconstruction: per-view depth-map jobs sharded over
the 'data' axis of a mesh (parallel/mesh.py).

Port of recon3d_tpu/dense/distributed.py. The reference-view axis is split
into contiguous shards, one per data index: the views are padded to a
multiple of the data size and split evenly, as a jax 'data' sharding
places them, and the padding rows are dropped before anything runs, so
they never reach an output. Each rank PatchMatches or plane-sweeps its
shard as one batch on its device (each through K1) and rank 0 gathers the
maps on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from recon3d_tpu_torch.dense.patchmatch import (
    DepthNormalMap,
    patchmatch_depth_batch,
    view_generator,
)
from recon3d_tpu_torch.dense.plane_sweep import sweep_depth_maps
from recon3d_tpu_torch.parallel.mesh import Mesh, data_rows, make_mesh


def _rows_payloads(mesh: Mesh, n: int, arrays: dict, common: dict) -> List[dict]:
    """Each rank's payload: its rows of every array of `arrays`, `common`
    whole, and its row range. Ranks of a model index > 0 get no rows (the
    dense jobs are replicated over 'model', so one copy runs)."""
    out = []
    for r, (lo, hi) in enumerate(data_rows(mesh, n)):
        if mesh.model_index_of(r):
            lo = hi
        out.append({"rows": (lo, hi),
                    "arrays": {k: v[lo:hi] for k, v in arrays.items()},
                    **common})
    return out


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _patchmatch_shard(mesh: Mesh, p: dict):
    """One rank's PatchMatch: its views as one patchmatch_depth_batch."""
    lo, hi = p["rows"]
    if hi <= lo:
        return None
    a, dev = p["arrays"], mesh.device
    fields = None
    if p["coarse_fields"] is not None:
        fields = [torch.from_numpy(np.asarray(f)) for f in p["coarse_fields"]]
    gens = None
    if fields is None:
        gens = [view_generator(p["seed"], int(v), dev) for v in a["positions"]]
    out = patchmatch_depth_batch(
        _t(a["ref_grays"], dev), _t(a["src_grays"], dev), _t(p["K"], dev),
        _t(a["R_refs"], dev), _t(a["t_refs"], dev), _t(a["R_srcss"], dev),
        _t(a["t_srcss"], dev), _t(a["depth_ranges"], dev),
        generators=gens, coarse_fields=fields, **p["kw"])
    return DepthNormalMap(*(x.cpu().numpy() for x in out))


def distributed_patchmatch(
    ref_grays: np.ndarray,     # (B, H, W)
    src_grays: np.ndarray,     # (B, J, H, W)
    K: np.ndarray,             # (3, 3)
    R_refs: np.ndarray,        # (B, 3, 3)
    t_refs: np.ndarray,        # (B, 3)
    R_srcss: np.ndarray,       # (B, J, 3, 3)
    t_srcss: np.ndarray,       # (B, J, 3)
    depth_ranges: np.ndarray,  # (B, 2)
    seed: int = 0,
    mesh: Optional[Mesh] = None,
    num_iterations: int = 3,
    num_samples: int = 8,
    patch: int = 11,
    ncc_threshold: float = 0.6,
    coarse_fields: Optional[Sequence[np.ndarray]] = None,
    coarse_factor: int = 4,
    fine_iterations: int = 1,
    positions: Optional[Sequence[int]] = None,
) -> DepthNormalMap:
    """PatchMatch a batch of reference views sharded over the mesh's 'data'
    axis. Returns a host (numpy) DepthNormalMap of all B views.

    Randomness, in place of the JAX function's `keys`: coarse_fields[k] is
    the (B,) + grid array of the k-th _smooth_field call (pre-drawn, each
    rank takes its rows), else view b draws from view_generator(seed,
    positions[b]) on its rank's device (positions default to 0..B-1), as
    PatchMatchMVS draws a view's fields: a view's map then does not
    depend on the shard it lands in."""
    own = mesh is None
    mesh = mesh or make_mesh()
    try:
        B = ref_grays.shape[0]
        pos = np.arange(B) if positions is None else np.asarray(positions, np.int64)
        arrays = dict(ref_grays=np.asarray(ref_grays), src_grays=np.asarray(src_grays),
                      R_refs=np.asarray(R_refs), t_refs=np.asarray(t_refs),
                      R_srcss=np.asarray(R_srcss), t_srcss=np.asarray(t_srcss),
                      depth_ranges=np.asarray(depth_ranges), positions=pos)
        kw = dict(num_iterations=num_iterations, num_samples=num_samples, patch=patch,
                  ncc_threshold=ncc_threshold, coarse_factor=coarse_factor,
                  fine_iterations=fine_iterations)
        payloads = _rows_payloads(mesh, B, arrays, dict(K=np.asarray(K), seed=seed, kw=kw,
                                                        coarse_fields=None))
        if coarse_fields is not None:
            for p in payloads:
                lo, hi = p["rows"]
                p["coarse_fields"] = [np.asarray(f)[lo:hi] for f in coarse_fields]
        outs = [o for o in mesh.call(_patchmatch_shard, payloads) if o is not None]
        return DepthNormalMap(*(np.concatenate(f, axis=0) for f in zip(*outs)))
    finally:
        if own:
            mesh.close()


def _sweep_shard(mesh: Mesh, p: dict):
    lo, hi = p["rows"]
    if hi <= lo:
        return None
    a, dev = p["arrays"], mesh.device
    out = sweep_depth_maps(
        _t(a["ref_grays"], dev), _t(a["src_grays"], dev), _t(p["K"], dev),
        _t(a["R_refs"], dev), _t(a["t_refs"], dev), _t(a["R_srcss"], dev),
        _t(a["t_srcss"], dev), _t(p["depth_range"], dev), **p["kw"])
    return tuple(x.cpu().numpy() for x in out)


def distributed_plane_sweep(
    ref_grays: np.ndarray,     # (B, H, W)
    src_grays: np.ndarray,     # (B, J, H, W)
    K: np.ndarray,
    R_refs: np.ndarray,
    t_refs: np.ndarray,
    R_srcss: np.ndarray,
    t_srcss: np.ndarray,
    depth_range: np.ndarray,   # (2,) shared
    mesh: Optional[Mesh] = None,
    num_depths: int = 64,
    patch: int = 5,
    ncc_threshold: float = 0.8,
    min_views: int = 3,
    hierarchical: bool = True,
):
    """Plane-sweep a batch of reference views sharded over the mesh's 'data'
    axis. Returns (depth (B,H,W), count (B,H,W), mean_ncc (B,H,W)) on the
    host. min_views is unused, as in the JAX function (the caller's fusion
    gate applies it)."""
    del min_views
    own = mesh is None
    mesh = mesh or make_mesh()
    try:
        B = ref_grays.shape[0]
        arrays = dict(ref_grays=np.asarray(ref_grays), src_grays=np.asarray(src_grays),
                      R_refs=np.asarray(R_refs), t_refs=np.asarray(t_refs),
                      R_srcss=np.asarray(R_srcss), t_srcss=np.asarray(t_srcss))
        kw = dict(num_depths=num_depths, patch=patch, ncc_threshold=ncc_threshold,
                  hierarchical=hierarchical)
        payloads = _rows_payloads(mesh, B, arrays, dict(
            K=np.asarray(K), depth_range=np.asarray(depth_range, np.float32), kw=kw))
        outs = [o for o in mesh.call(_sweep_shard, payloads) if o is not None]
        return tuple(np.concatenate(f, axis=0) for f in zip(*outs))
    finally:
        if own:
            mesh.close()
