"""TSDF fusion of per-view depth maps into a voxel volume: the mesh stage.

PyTorch port of recon3d_tpu/dense/tsdf.py (single device): the whole
voxel grid is projected into every view, each view's depth and confidence
are looked up at the nearest pixel, and truncated signed distances are
averaged with the confidences as weights (Curless & Levoy). Marching
tetrahedra on the result is dense/mesh.py.

What changes against the JAX version:
  - lax.scan over views becomes a Python loop that adds each view's
    contribution in view order, as the scan does;
  - the per-view lookup is K1 (kernels/warp.py) at snapped coordinates,
    where the tent weights are one-hot, so it is an exact nearest-pixel
    read: depth and confidence are two planes sharing one set of
    coordinates, so each view costs one K1 launch (ops/image.sample_planes);
  - coordinates are torch.round of u and v, which rounds half to even as
    jnp.round does;
  - over a mesh (parallel/mesh.py) the views shard over 'data': each rank
    adds its views into the whole grid, then one all_reduce pair sums the
    numerators and weights (the JAX shard_map's psum pair, tsdf.py:111-142).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import sample_planes
from recon3d_tpu_torch.runtime.device import resolve_device


class TSDFVolume(NamedTuple):
    tsdf: np.ndarray    # (N, N, N) float32 in [-1, 1]
    weight: np.ndarray  # (N, N, N) float32 accumulated weights
    origin: np.ndarray  # (3,) world position of voxel (0,0,0) CENTER
    voxel: float        # voxel edge length (world units)
    trunc: float        # truncation distance (world units)


def bounds_from_points(
    points: np.ndarray, margin: float = 0.05
) -> Tuple[np.ndarray, np.ndarray]:
    """Robust (1st/99th percentile) axis-aligned bounds with relative margin."""
    lo = np.percentile(points, 1, axis=0)
    hi = np.percentile(points, 99, axis=0)
    pad = (hi - lo).max() * margin + 1e-6
    return lo - pad, hi + pad


def voxel_centers(origin: torch.Tensor, voxel: float, n: int) -> torch.Tensor:
    """(n^3, 3) world voxel centres, x fastest: origin + voxel * (x, y, z)."""
    idx = torch.arange(n, dtype=torch.float32, device=origin.device)
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    grid = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], dim=-1)
    return origin[None, :] + voxel * grid


def tsdf_view_coords(X: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame depth z (M,) of world points X (M, 3) in one view, and
    their pixel coordinates snapped to the nearest pixel (M, 2) as (x, y)."""
    # einsum("ij,mj->mi", R, X) + t
    Xc = torch.matmul(X, R.T) + t[None, :]
    z = Xc[:, 2]
    u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
    v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
    return z, torch.stack([torch.round(u), torch.round(v)], dim=-1)


def _accumulate_views(depths, confs, K, Rs, ts, origin, voxel, trunc, n):
    """Weighted sums over views, added in view order: (num, den), each
    (n^3,), with num = sum_v w_v * clamp(sdf_v) and den = sum_v w_v.
    depths, confs (V, H, W); K (3, 3); Rs (V, 3, 3); ts (V, 3); origin (3,)."""
    X = voxel_centers(origin, voxel, n)
    M = n * n * n
    num = torch.zeros(M, dtype=torch.float32, device=X.device)
    den = torch.zeros(M, dtype=torch.float32, device=X.device)
    for v in range(depths.shape[0]):
        z, uv = tsdf_view_coords(X, K, Rs[v], ts[v])
        # one launch for both planes: nearest-pixel depth and confidence
        (d, w_px), valid = sample_planes(
            torch.stack([depths[v], confs[v]]), uv[None], fill=0.0)
        valid = valid[0]
        sdf = (d - z) / trunc
        ok = (
            valid
            & (z > 1e-6)
            & (d > 1e-6)
            & (sdf > -1.0)  # integrate only up to one truncation band behind
            & torch.isfinite(sdf)
        )
        w = torch.where(ok, torch.clamp_min(w_px, 0.0), 0.0)
        num = num + torch.clamp(sdf, -1.0, 1.0) * w
        den = den + w
    return num, den


def _integrate_shard(mesh, p: dict):
    """One rank's views added into the whole grid, then the sums over the
    data group: (tsdf, weight) on rank 0, None elsewhere. Ranks of a model
    index > 0 sit out (the views are replicated over 'model')."""
    if mesh.model_index:
        return None
    dev = mesh.device
    num, den = _accumulate_views(
        _as_tensor(p["depths"], dev), _as_tensor(p["confs"], dev), _as_tensor(p["K"], dev),
        _as_tensor(p["Rs"], dev), _as_tensor(p["ts"], dev), _as_tensor(p["origin"], dev),
        p["voxel"], p["trunc"], p["n"])
    mesh.all_reduce_(num)
    mesh.all_reduce_(den)
    if mesh.rank:
        return None
    return _finalize(num, den, p["n"])


def _integrate_sharded(mesh, depths, confs, K, Rs, ts, origin, voxel, trunc, n):
    """The views sharded over the mesh's 'data' axis (parallel/mesh.py
    data_rows): rank 0 keeps its views on its device, the other ranks get
    theirs as host arrays."""
    from recon3d_tpu_torch.parallel.mesh import data_rows

    common = dict(K=K, origin=origin, voxel=voxel, trunc=trunc, n=n)
    payloads = []
    for r, (lo, hi) in enumerate(data_rows(mesh, depths.shape[0])):
        payloads.append(dict(depths=depths[lo:hi], confs=confs[lo:hi], Rs=Rs[lo:hi],
                             ts=ts[lo:hi], **common))
    return mesh.call(_integrate_shard, payloads)[0]


def _finalize(num, den, n):
    tsdf = torch.where(den > 0, num / torch.clamp_min(den, 1e-12), 1.0)
    return tsdf.reshape(n, n, n), den.reshape(n, n, n)


def _as_tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), np.float32)).to(device, dtype)


def fuse_tsdf(
    depths,
    confs,
    K,
    Rs,
    ts,
    bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    resolution: int = 128,
    trunc_voxels: float = 3.0,
    min_conf: float = 0.0,
    sparse_points: Optional[np.ndarray] = None,
    timings: Optional[dict] = None,
    device="cuda",
    mesh=None,
) -> TSDFVolume:
    """Fuse per-view depth maps into a TSDF volume on `device`.

    depths: (V, H, W) world-unit depths, 0 = invalid (numpy or a tensor;
            tensors already on `device` are not copied).
    confs:  (V, H, W) per-pixel weights (MVS consistency counts) or None.
    bounds: (lo, hi) world AABB; derived from sparse_points (or from the
            depth maps' backprojection) when omitted.
    resolution: voxels per axis. trunc_voxels: truncation in voxel units.
    mesh: a parallel.mesh.Mesh whose 'data' axis shards the views; rank 0
    runs on the mesh's device.
    The volume comes back to the host (numpy) as the JAX function's does.
    """
    tm = timings if timings is not None else {}
    _t = time.time()
    dev = mesh.device if mesh is not None else resolve_device(device)
    depths = _as_tensor(depths, dev)
    V, H, W = depths.shape
    if confs is None:
        confs = (depths > 0).to(torch.float32)
    else:
        confs = _as_tensor(confs, dev)
        confs = torch.where(confs >= min_conf, confs, 0.0)
    confs = torch.where(depths > 0, confs, 0.0)

    if bounds is None:
        if sparse_points is not None and len(sparse_points) >= 20:
            bounds = bounds_from_points(np.asarray(sparse_points))
        else:
            pts = _backproject_samples(depths.cpu().numpy(), np.asarray(K),
                                       np.asarray(Rs), np.asarray(ts))
            if len(pts) < 8:
                raise ValueError("no valid depth pixels to bound the volume")
            bounds = bounds_from_points(pts)
    lo, hi = np.asarray(bounds[0], np.float64), np.asarray(bounds[1], np.float64)
    voxel = float((hi - lo).max() / (resolution - 1))
    trunc = trunc_voxels * voxel

    tm["host_prep_s"] = time.time() - _t
    _t = time.time()
    args = (depths, confs, _as_tensor(K, dev), _as_tensor(Rs, dev), _as_tensor(ts, dev),
            _as_tensor(lo.astype(np.float32), dev),
            float(np.float32(voxel)), float(np.float32(trunc)), int(resolution))
    if mesh is not None:
        tsdf, weight = _integrate_sharded(mesh, *args)
    else:
        tsdf, weight = _finalize(*_accumulate_views(*args), int(resolution))
    tm["upload_dispatch_s"] = time.time() - _t
    _t = time.time()
    vol = TSDFVolume(
        tsdf=tsdf.cpu().numpy(),
        weight=weight.cpu().numpy(),
        origin=lo.astype(np.float32),
        voxel=voxel,
        trunc=trunc,
    )
    tm["volume_fetch_s"] = time.time() - _t
    return vol


def _backproject_samples(
    depths: np.ndarray, K: np.ndarray, Rs: np.ndarray, ts: np.ndarray,
    stride: int = 4,
) -> np.ndarray:
    """Host-side sparse backprojection of the depth maps (bounds estimate)."""
    V, H, W = depths.shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    out = []
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    for v in range(V):
        d = depths[v, ys, xs]
        m = d > 0
        if not m.any():
            continue
        pix = np.stack([xs[m], ys[m], np.ones(m.sum())], axis=0)
        Xc = (Kinv @ pix) * d[m][None, :]
        Xw = Rs[v].T @ (Xc - ts[v][:, None])
        out.append(Xw.T)
    return np.concatenate(out, axis=0) if out else np.zeros((0, 3))
