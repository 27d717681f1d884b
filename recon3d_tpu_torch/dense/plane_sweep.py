"""Plane-sweep multi-view stereo, and the depth-map fusion helpers shared
by the dense backends.

PyTorch port of recon3d_tpu/dense/plane_sweep.py: per reference view,
sweep D fronto-parallel inverse-depth planes, score each with windowed NCC
against J neighbour views, count the consistent views, keep the best plane
per pixel, back-project. Hierarchical by default: the exhaustive sweep runs
at half resolution and a few per-pixel candidates around its winner are
re-scored at full resolution with PatchMatch's warp (dense/patchmatch.py).

What changes against the JAX version:
  - vmap over reference views and over sources becomes batch dimensions:
    all reference views sweep together;
  - lax.scan over chunks of 8 planes becomes a Python loop; each chunk
    warps the J sources of every reference view at its 8 plane
    homographies in ONE K1 launch (kernels/warp.py), planes (R*J, H, W);
  - the full-resolution candidates of the hierarchical sweep go through
    patchmatch._warp_sources, one K1 launch for all views, sources and
    candidates;
  - the JAX module's windowed NCC (`_ncc`) is ops/ncc.ncc_windowed, the
    same masked moments;
  - over a mesh (parallel/mesh.py) the reference views shard over 'data'
    (dense/distributed.py::distributed_plane_sweep) and rank 0 fuses.

`create_combined_dense_cloud` is the JAX package's library wrapper around
the sweep; the CLI's --combined does not call it (it runs the sweep and
dense SIFT, cli.py).

The fusion helpers `backproject_depth`, `fused_points_compact`,
`depth_range_from_poses` and `depth_range_from_sparse` serve PatchMatch too.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import PlaneSweepConfig
from recon3d_tpu_torch.ops.image import resize_batch_invariant, sample_planes
from recon3d_tpu_torch.ops.ncc import ncc_windowed
from recon3d_tpu_torch.runtime.device import resolve_device


def _relative_pose(R_ref, t_ref, R_src, t_src):
    """(R, t) of src relative to ref, x_src = R x_ref + t, for any leading
    batch dimensions."""
    R = torch.matmul(R_src, R_ref.transpose(-1, -2))
    t = t_src - torch.matmul(R, t_ref[..., None])[..., 0]
    return R, t


def plane_homography(K, R_rel, t_rel, inv_depth):
    """Homography ref -> src for the fronto-parallel plane z = 1/inv_depth
    (in the ref camera frame): H = K (R + t n^T * inv_depth) K^-1, n = e_z.
    R_rel (..., 3, 3), t_rel (..., 3) and inv_depth (...) broadcast."""
    n = torch.tensor([0.0, 0.0, 1.0], dtype=K.dtype, device=K.device)
    inv_depth = torch.as_tensor(inv_depth, dtype=K.dtype, device=K.device)
    M = R_rel + (t_rel[..., :, None] * n) * inv_depth[..., None, None]
    Kinv = torch.linalg.inv(K)
    return torch.matmul(torch.matmul(K, M), Kinv)


def _pixel_grid_h(H: int, W: int, dtype, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)


def _warp_by_homography(imgs, Hs, grid_h):
    """Sample each of N planes imgs (N, H, W) at its P homographies Hs
    (N, P, 3, 3) applied to every pixel of grid_h (H, W, 3) homogeneous:
    one K1 launch. Returns (samples (N, P, H, W), valid (N, P, H, W))."""
    N, P = Hs.shape[:2]
    H, W = grid_h.shape[:2]
    # einsum("ij,hwj->hwi", H, grid_h) for every (n, p)
    g = torch.matmul(grid_h.reshape(1, 1, H * W, 3), Hs.transpose(-1, -2))
    z = g[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    coords = g[..., :2] / z[..., None]
    samp, ok = sample_planes(imgs, coords.reshape(N, P * H * W, 2))
    ok = ok.reshape(N, P, H * W) & (z > 0)
    return samp.reshape(N, P, H, W), ok.reshape(N, P, H, W)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace's float32 formula: start * (1 - s) + stop * s with
    s = i / (num - 1), and the last entry exactly stop."""
    s = torch.arange(num - 1, dtype=start.dtype, device=start.device) / (num - 1)
    return torch.cat([start * (1 - s) + stop * s, stop[None]])


def _score(nccs, ncc_threshold: float, dim: int):
    """Consistent-view count, mean positive NCC and the plane score
    count + 0.5 * mean over the source dimension `dim`."""
    count = (nccs > ncc_threshold).sum(dim=dim)
    mean_ncc = torch.clamp_min(nccs, 0.0).mean(dim=dim)
    return count.to(nccs.dtype) + 0.5 * mean_ncc, count, mean_ncc


def _pick(score, values, dim: int = 1):
    """Per pixel, the entries of each tensor in `values` at the first
    maximum of `score` along `dim` (jnp.argmax's tie order)."""
    ci = torch.argmax(score, dim=dim, keepdim=True)
    return [torch.gather(v, dim, ci).squeeze(dim) for v in values]


def sweep_depth_maps(
    ref_grays: torch.Tensor,      # (R, H, W)
    src_grays: torch.Tensor,      # (R, J, H, W)
    K: torch.Tensor,              # (3, 3) at working scale
    R_refs: torch.Tensor,         # (R, 3, 3)
    t_refs: torch.Tensor,         # (R, 3)
    R_srcs: torch.Tensor,         # (R, J, 3, 3)
    t_srcs: torch.Tensor,         # (R, J, 3)
    depth_range: torch.Tensor,    # (2,) = (dmin, dmax), shared
    num_depths: int = 64,
    patch: int = 5,
    ncc_threshold: float = 0.8,
    hierarchical: bool = True,
):
    """Plane sweep of R reference views at once. Returns (depth (R, H, W),
    consistency count (R, H, W), mean NCC (R, H, W)).

    hierarchical=True runs the full D-plane sweep at half resolution,
    upsamples the winning inverse depth, and re-scores five per-pixel
    candidates around it at full resolution; hierarchical=False is the
    exhaustive sweep at full resolution."""
    H, W = ref_grays.shape[-2:]
    if hierarchical and num_depths >= 16 and min(H, W) >= 48:
        return _sweep_hier(ref_grays, src_grays, K, R_refs, t_refs, R_srcs, t_srcs,
                           depth_range, num_depths, patch, ncc_threshold)
    return _sweep_all_planes(ref_grays, src_grays, K, R_refs, t_refs, R_srcs, t_srcs,
                             depth_range, num_depths, patch, ncc_threshold)


def sweep_depth_map(
    ref_gray, src_grays, K, R_ref, t_ref, R_srcs, t_srcs, depth_range,
    num_depths: int = 64, patch: int = 5, ncc_threshold: float = 0.8,
    min_views: int = 3, hierarchical: bool = True,
):
    """One reference view: ref_gray (H, W), src_grays (J, H, W), R_srcs
    (J, 3, 3), t_srcs (J, 3), depth_range (2,). Returns (depth (H, W),
    consistency count (H, W), mean NCC (H, W)). min_views is unused, as in
    the JAX function (the caller's fusion gate applies it)."""
    out = sweep_depth_maps(
        ref_gray[None], src_grays[None], K, R_ref[None], t_ref[None],
        R_srcs[None], t_srcs[None], depth_range, num_depths=num_depths,
        patch=patch, ncc_threshold=ncc_threshold, hierarchical=hierarchical,
    )
    return tuple(x[0] for x in out)


def _sweep_all_planes(
    ref_grays, src_grays, K, R_refs, t_refs, R_srcs, t_srcs, depth_range,
    num_depths: int, patch: int, ncc_threshold: float,
):
    """Exhaustive sweep: every plane scored at the input resolution, in
    chunks of 8 planes; the last chunk repeats the final plane (re-scoring
    a plane changes no running maximum)."""
    R, J, H, W = src_grays.shape
    dt, dev = ref_grays.dtype, ref_grays.device
    grid_h = _pixel_grid_h(H, W, dt, dev)
    Rrel, trel = _relative_pose(R_refs[:, None], t_refs[:, None], R_srcs, t_srcs)
    inv_depths = _linspace(1.0 / depth_range[1], 1.0 / depth_range[0], num_depths)
    chunk = min(8, num_depths)
    n_chunks = (num_depths + chunk - 1) // chunk
    pad = n_chunks * chunk - num_depths
    inv_chunks = torch.cat([inv_depths, inv_depths[-1:].expand(pad)]).reshape(n_chunks, chunk)
    srcs = src_grays.reshape(R * J, H, W)

    best_score = torch.full((R, H, W), -float("inf"), dtype=dt, device=dev)
    best_inv = inv_depths[0].expand(R, H, W)
    best_cnt = torch.zeros((R, H, W), dtype=torch.int64, device=dev)
    best_ncc = torch.zeros((R, H, W), dtype=dt, device=dev)
    for inv_ds in inv_chunks:
        Hm = plane_homography(K, Rrel[:, :, None], trel[:, :, None], inv_ds)  # (R,J,c,3,3)
        warped, ok = _warp_by_homography(srcs, Hm.reshape(R * J, chunk, 3, 3), grid_h)
        nccs = ncc_windowed(ref_grays[:, None, None], warped.reshape(R, J, chunk, H, W),
                            ok.reshape(R, J, chunk, H, W), patch)
        score, count, mean_ncc = _score(nccs, ncc_threshold, dim=1)   # (R, c, H, W)
        c_inv = inv_ds[:, None, None].expand(R, chunk, H, W)
        c_score, c_inv, c_cnt, c_ncc = _pick(score, [score, c_inv, count, mean_ncc])
        better = c_score > best_score
        best_score = torch.where(better, c_score, best_score)
        best_inv = torch.where(better, c_inv, best_inv)
        best_cnt = torch.where(better, c_cnt, best_cnt)
        best_ncc = torch.where(better, c_ncc, best_ncc)
    return 1.0 / best_inv, best_cnt, best_ncc


def _sweep_hier(
    ref_grays, src_grays, K, R_refs, t_refs, R_srcs, t_srcs, depth_range,
    num_depths: int, patch: int, ncc_threshold: float,
):
    """Coarse-to-fine sweep: exhaustive D-plane sweep at half resolution,
    then full-resolution re-scoring of per-pixel inverse-depth candidates
    around the upsampled winner (offsets of 0, +-0.5, +-1 plane spacings).
    A candidate field has a depth per pixel, which a plane homography
    cannot express, so it goes through PatchMatch's per-pixel warp."""
    from recon3d_tpu_torch.dense.patchmatch import _rays_for, _warp_sources

    R, J, H, W = src_grays.shape
    H2, W2 = H // 2, W // 2
    ref2 = resize_batch_invariant(ref_grays, (H2, W2))
    src2 = resize_batch_invariant(src_grays, (H2, W2))
    # intrinsics at the half scale under resize's half-pixel convention
    S = torch.tensor([[0.5, 0.0, -0.25], [0.0, 0.5, -0.25], [0.0, 0.0, 1.0]],
                     dtype=K.dtype, device=K.device)
    d2, _, _ = _sweep_all_planes(ref2, src2, S @ K, R_refs, t_refs, R_srcs, t_srcs,
                                 depth_range, num_depths, patch, ncc_threshold)

    inv_lo = 1.0 / depth_range[1]
    inv_hi = 1.0 / depth_range[0]
    step = (inv_hi - inv_lo) / (num_depths - 1)
    inv_full = torch.clamp(resize_batch_invariant(1.0 / d2, (H, W)), inv_lo, inv_hi)
    offsets = torch.tensor([0.0, -1.0, -0.5, 0.5, 1.0], dtype=ref_grays.dtype,
                           device=ref_grays.device) * step
    cands = torch.clamp(inv_full[:, None] + offsets[:, None, None], inv_lo, inv_hi)  # (R,C,H,W)

    rays = _rays_for(K, H, W, ref_grays.dtype)
    warped, ok = _warp_sources(
        1.0 / cands, rays, R_refs, t_refs, R_srcs, t_srcs, K, src_grays,
        z_floor=(depth_range[0] * 0.05).expand(R),
    )                                                       # (R, J, C, H, W)
    ncc = ncc_windowed(ref_grays[:, None, None], warped, ok, patch)
    score, count, mean_ncc = _score(ncc, ncc_threshold, dim=1)   # (R, C, H, W)
    best_inv, best_cnt, best_ncc = _pick(score, [cands, count, mean_ncc])
    return 1.0 / best_inv, best_cnt, best_ncc


def backproject_depth(
    depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
    valid: torch.Tensor,
):
    """Depth map(s) -> world points (..., H*W, 3) + mask (..., H*W).

    depth (..., H, W) with R (..., 3, 3), t (..., 3) and valid (..., H, W)
    for the same leading views; K (3, 3) shared. Invalid pixels keep their
    back-projected point with mask False."""
    H, W = depth.shape[-2], depth.shape[-1]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    x = (xs - K[0, 2]) / K[0, 0] * depth
    y = (ys - K[1, 2]) / K[1, 1] * depth
    lead = depth.shape[:-2]
    Xc = torch.stack([x, y, depth], dim=-1).reshape(lead + (H * W, 3))
    # einsum("ji,nj->ni", R, Xc - t) == (Xc - t) @ R
    Xw = torch.matmul(Xc - t[..., None, :], R)
    return Xw, valid.reshape(lead + (H * W,))


def _compact_masked(pts: torch.Tensor, mask: torch.Tensor):
    """Rows of (N, 3) points where mask is set, and their flat indices, in
    index order. Dynamic shapes make the JAX version's fixed capacity
    buckets unnecessary."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
    return pts.reshape(-1, 3).index_select(0, idx), idx


def fused_points_compact(pts_b: torch.Tensor, mask_b: torch.Tensor, lo: int = 8192):
    """Compact on the device, download only the selected points. Returns
    (points (M, 3) float32 numpy, flat_indices (M,) int64 numpy).

    `lo` is accepted and ignored: in the JAX package it is the smallest
    capacity bucket of the compaction, which XLA needs as a static shape;
    here the compaction takes exactly the selected points."""
    taken, idx = _compact_masked(pts_b, mask_b)
    return (
        taken.cpu().numpy().astype(np.float32),
        idx.cpu().numpy().astype(np.int64),
    )


def depth_range_from_poses(Rs: np.ndarray, ts: np.ndarray) -> Tuple[float, float]:
    """Depth bounds from the camera-center spread (reference :86-92)."""
    C = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    spread = np.linalg.norm(C - C.mean(0), axis=1).max() * 2 + 1e-6
    return 0.5 * spread, 20.0 * spread


def depth_range_from_sparse(
    points: np.ndarray, R: np.ndarray, t: np.ndarray
) -> Optional[Tuple[float, float]]:
    """1st/99th percentile of sparse depths x1.5 margin (reference
    mvs_patchmatch.py:141-165)."""
    if len(points) < 20:
        return None
    z = (points @ R.T + t)[:, 2]
    z = z[z > 1e-6]
    if len(z) < 20:
        return None
    lo, hi = np.percentile(z, [1, 99])
    return float(max(lo / 1.5, 1e-3)), float(hi * 1.5)


class PlaneSweepReconstructor:
    """Dense reconstruction via plane sweep.

    reconstruct(images, poses, ...) -> (points (N,3), colors (N,3) uint8).
    `images` is (V, H, W, 3) float32 [0,1] at full scale; `poses` a dict
    {idx: (R, t)} of registered cameras (numpy). Runs on `device` ("cuda"
    unless the caller asks for "cpu").
    """

    def __init__(self, camera: Camera, config: Optional[PlaneSweepConfig] = None,
                 device="cuda"):
        self.camera = camera
        self.config = config or PlaneSweepConfig()
        self.device = resolve_device(device)

    def _neighbors(self, ids: List[int], poses, k: int) -> Dict[int, List[int]]:
        C = {i: -poses[i][0].T @ poses[i][1] for i in ids}
        out = {}
        for i in ids:
            d = sorted(
                ((np.linalg.norm(C[i] - C[j]), j) for j in ids if j != i)
            )
            out[i] = [j for _, j in d[:k]]
        return out

    def reconstruct(
        self,
        images: np.ndarray,
        poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
        sparse_points: Optional[np.ndarray] = None,
        max_ref_views: Optional[int] = None,
        return_maps: bool = False,
        host_small: Optional[np.ndarray] = None,
        mesh=None,
    ):
        """With return_maps=True, returns (points, colors, maps): per-ref
        depth and consistency-count maps (on the device) and their
        geometry, for the TSDF mesh stage (the contract of
        PatchMatchMVS.reconstruct). host_small: optional load-time
        prescaled (N, H*scale, W*scale, 3) colour stack. mesh: a
        parallel.mesh.Mesh whose 'data' axis shards the reference views
        (recon3d_tpu/dense/plane_sweep.py:444-500); the fusion runs here."""
        cfg = self.config
        dev = self.device
        t0 = time.time()
        ids = sorted(poses.keys())
        V = len(ids)
        empty = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
        if V < 2:
            return (*empty, None) if return_maps else empty

        scale = cfg.scale
        Hs = int(images.shape[1] * scale)
        Ws = int(images.shape[2] * scale)
        K = self.camera.scaled(scale).K.cpu().numpy().astype(np.float32)

        # Downscale + gray on the host: only the small gray planes go to
        # the device.
        from recon3d_tpu_torch.io.hostimg import resize_batch_np, rgb_to_gray_np

        if host_small is not None and host_small.shape[1:3] == (Hs, Ws):
            small = np.asarray(host_small[ids], np.float32)
        else:
            small = resize_batch_np(images[ids], (Hs, Ws))
        grays = rgb_to_gray_np(small)
        id_row = {i: r for r, i in enumerate(ids)}

        Rs = np.stack([poses[i][0] for i in ids])
        ts = np.stack([poses[i][1] for i in ids])
        dr = depth_range_from_poses(Rs, ts)
        if sparse_points is not None:
            dr2 = depth_range_from_sparse(sparse_points, Rs[0], ts[0])
            if dr2:
                dr = dr2

        max_refs = max_ref_views or cfg.max_ref_views
        step = max(1, V // max_refs)
        ref_ids = [i for i in ids[::step]]
        neighbors = self._neighbors(ids, poses, cfg.num_neighbors)
        ref_ids = [i for i in ref_ids if len(neighbors[i]) >= 1]
        J = min(cfg.num_neighbors, V - 1)

        # All reference views sweep as one batch. One upload of the small
        # gray stack; reference and source planes are device-side gathers.
        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        grays_d = up(grays)
        src_rows = [[id_row[j] for j in neighbors[i][:J]] for i in ref_ids]
        ref_g = grays_d[up([id_row[i] for i in ref_ids], np.int64)]
        src_g = grays_d[up(src_rows, np.int64)]
        R_refs = up(np.stack([poses[i][0] for i in ref_ids]))
        t_refs = up(np.stack([poses[i][1] for i in ref_ids]))
        R_srcs = up(np.stack([np.stack([poses[j][0] for j in neighbors[i][:J]])
                              for i in ref_ids]))
        t_srcs = up(np.stack([np.stack([poses[j][1] for j in neighbors[i][:J]])
                              for i in ref_ids]))
        Kd = up(K)
        if mesh is not None:
            from recon3d_tpu_torch.dense.distributed import distributed_plane_sweep

            src_np = np.asarray(grays)[np.asarray(src_rows, np.int64)]
            depth_np, cnt_np, _ = distributed_plane_sweep(
                grays[[id_row[i] for i in ref_ids]], src_np, K,
                R_refs.cpu().numpy(), t_refs.cpu().numpy(), R_srcs.cpu().numpy(),
                t_srcs.cpu().numpy(), np.asarray(dr, np.float32), mesh=mesh,
                num_depths=cfg.num_depths, patch=cfg.patch_size,
                ncc_threshold=cfg.ncc_threshold,
            )
            depth_b, cnt_b = torch.from_numpy(depth_np).to(dev), torch.from_numpy(cnt_np).to(dev)
        else:
            depth_b, cnt_b, _ = sweep_depth_maps(
                ref_g, src_g, Kd, R_refs, t_refs, R_srcs, t_srcs, up(dr),
                num_depths=cfg.num_depths, patch=cfg.patch_size,
                ncc_threshold=cfg.ncc_threshold,
            )
        # Fusion: back-project every consistent pixel of every reference
        # view in one batched call, compact on the device, download once.
        min_views_r = up([min(cfg.min_views, len(neighbors[i])) for i in ref_ids], np.int64)
        pts_b, mask_b = backproject_depth(depth_b, Kd, R_refs, t_refs,
                                          cnt_b >= min_views_r[:, None, None])
        points, sel_idx = fused_points_compact(pts_b, mask_b)
        if len(points) == 0:
            return (*empty, None) if return_maps else empty
        colors = (
            small[[id_row[i] for i in ref_ids]].reshape(-1, 3)[sel_idx] * 255
        ).astype(np.uint8)

        from recon3d_tpu_torch.dense.filters import radius_outlier_filter, voxel_downsample

        points, colors = radius_outlier_filter(points, colors)
        points, colors = voxel_downsample(points, colors, cfg.voxel_size)
        print(f"[plane-sweep] {len(points)} points from {len(ref_ids)} ref views "
              f"({time.time() - t0:.1f}s)")
        if return_maps:
            maps = {
                "depth": depth_b,
                "conf": cnt_b.to(torch.float32),
                "K": K,
                "Rs": R_refs.cpu().numpy(),
                "ts": t_refs.cpu().numpy(),
                "ids": list(ref_ids),
            }
            return points, colors, maps
        return points, colors


def create_combined_dense_cloud(
    camera: Camera,
    images: np.ndarray,
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    use_stereo: bool = True,
    device="cuda",
):
    """API-parity wrapper (reference dense_stereo.py:495-505): run the
    plane-sweep backend, or return empty arrays when disabled."""
    if use_stereo:
        return PlaneSweepReconstructor(camera, device=device).reconstruct(images, poses)
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
