"""PatchMatch multi-view stereo in PyTorch.

Port of recon3d_tpu/dense/patchmatch.py (see its docstring for the method):
per reference view, a smooth random depth field is refined by rounds of
multi-scale propagation and random refinement scored with windowed NCC
against J source views, coarse-to-fine; then a per-view confidence count,
fusion of the confident pixels of all views into a world cloud, filtering.

What changes against the JAX version:
  - vmap over views and candidates becomes explicit batch dimensions: a
    depth field batch is (B, F, H, W) for B views and F candidate fields;
  - lax.scan over PatchMatch rounds becomes a Python loop;
  - one `keep_best` evaluation warps all J sources of all B views for all
    F fields in ONE K1 launch (kernels/warp.py): planes (B*J, H, W), and the
    F fields' coordinates of a source share that source's plane;
  - jax.random draws cannot be reproduced in torch. Every random field comes
    from `_smooth_field`; the callers take either pre-drawn coarse fields
    (`coarse_fields`, one per `_smooth_field` call in the order the JAX
    code makes them) or one torch.Generator per view.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import PatchMatchConfig
from recon3d_tpu_torch.dense.plane_sweep import (
    backproject_depth,
    depth_range_from_poses,
    depth_range_from_sparse,
    fused_points_compact,
)
from recon3d_tpu_torch.ops.image import resize, sample_planes
from recon3d_tpu_torch.ops.ncc import ncc_windowed
from recon3d_tpu_torch.runtime.device import disable_tf32, resolve_device

_BIG = 1e9  # stand-in for +inf that stays finite under where/argmin


class DepthNormalMap(NamedTuple):
    """Per-view PatchMatch output (batched: a leading view dimension)."""

    depth: torch.Tensor       # (H, W)
    normal: torch.Tensor      # (H, W, 3), unit, camera frame
    confidence: torch.Tensor  # (H, W) number of NCC-consistent source views
    cost: torch.Tensor        # (H, W) final matching cost (1 - NCC, averaged)


def _shift2d(x: torch.Tensor, dy: int, dx: int, dims=(0, 1)) -> torch.Tensor:
    """Shift a map by (dy, dx) along `dims` (default: a (H, W, ...) map),
    replicating edges. Shifts are clamped to the map size: propagation uses
    steps up to 16, more than a 30x40 coarse map may have."""
    hd, wd = dims
    H, W = x.shape[hd], x.shape[wd]
    dy = max(-(H - 1), min(H - 1, dy))
    dx = max(-(W - 1), min(W - 1, dx))
    if dy:
        idx = torch.clamp(torch.arange(H, device=x.device) - dy, 0, H - 1)
        x = x.index_select(hd, idx)
    if dx:
        idx = torch.clamp(torch.arange(W, device=x.device) - dx, 0, W - 1)
        x = x.index_select(wd, idx)
    return x


def _warp_sources(depth, rays, R_ref, t_ref, R_srcs, t_srcs, K, src_grays,
                  z_floor):
    """Reproject every ref pixel at its depth into each source and sample.

    depth (B, F, H, W) fields; rays (H, W, 3) = K^-1 [u v 1]^T; R_ref
    (B, 3, 3), t_ref (B, 3); R_srcs (B, J, 3, 3), t_srcs (B, J, 3); src_grays
    (B, J, H, W); z_floor (B,) minimum source-frame depth of a valid sample.
    Returns sampled (B, J, F, H, W) and validity (B, J, F, H, W).
    """
    B, F, H, W = depth.shape
    J = src_grays.shape[1]
    Xc = rays * depth[..., None]                                  # (B,F,H,W,3)
    # einsum("ji,hwj->hwi", R_ref, Xc - t_ref) == (Xc - t_ref) @ R_ref
    Xw = torch.matmul((Xc - t_ref[:, None, None, None, :]).reshape(B, F * H * W, 3),
                      R_ref)                                       # (B,FHW,3)
    # einsum("ij,hwj->hwi", R, Xw) + t == Xw @ R^T + t, per source
    Xs = torch.matmul(Xw[:, None], R_srcs.transpose(-1, -2)) + t_srcs[:, :, None, :]
    z = Xs[..., 2]                                                 # (B,J,FHW)
    uv = Xs[..., :2] / torch.where(z.abs() < 1e-8, 1e-8, z)[..., None]
    px = torch.stack(
        [K[0, 0] * uv[..., 0] + K[0, 2], K[1, 1] * uv[..., 1] + K[1, 2]], dim=-1,
    )
    samp, ok = sample_planes(
        src_grays.reshape(B * J, H, W), px.reshape(B * J, F * H * W, 2)
    )
    ok = ok.reshape(B, J, F * H * W) & (z > z_floor[:, None, None])
    return samp.reshape(B, J, F, H, W), ok.reshape(B, J, F, H, W)


def _eval_cost(depth, rays, ref_gray, src_grays, K, R_ref, t_ref,
               R_srcs, t_srcs, patch: int, z_floor):
    """Photo-consistency cost of (B, F, H, W) depth hypothesis fields.

    Returns (cost (B,F,H,W), ncc (B,J,F,H,W), valid (B,J,F,H,W)). Cost is
    mean (1 - NCC) over valid views; _BIG where <2 views see the point."""
    warped, ok = _warp_sources(
        depth, rays, R_ref, t_ref, R_srcs, t_srcs, K, src_grays, z_floor,
    )
    ncc = ncc_windowed(ref_gray[:, None, None], warped, ok, patch)
    cnt = ok.sum(dim=1)
    total = torch.where(ok, 1.0 - ncc, 0.0).sum(dim=1)
    cost = total / torch.clamp_min(cnt, 1)
    cost = torch.where(cnt >= 2, cost, _BIG)
    return cost, ncc, ok


def normals_from_depth(depth: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Camera-frame surface normals of depth (..., H, W) -> (..., H, W, 3).

    Central differences of the backprojected surface P = rays * depth give
    the tangents; their cross product is the normal, sign-fixed to face the
    camera (n . P < 0). Border pixels fall back to (0, 0, -1)."""
    P = rays * depth[..., None]
    tu = _shift2d(P, 0, -1, dims=(-3, -2)) - _shift2d(P, 0, 1, dims=(-3, -2))
    tv = _shift2d(P, -1, 0, dims=(-3, -2)) - _shift2d(P, 1, 0, dims=(-3, -2))
    n = torch.linalg.cross(tu, tv, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    back = torch.tensor([0.0, 0.0, -1.0], dtype=depth.dtype, device=depth.device)
    n = torch.where(norm > 1e-12, n / torch.clamp_min(norm, 1e-12), back)
    return torch.where((n * P).sum(dim=-1, keepdim=True) > 0, -n, n)


def _draw(generator: torch.Generator, shape, dist: str, device) -> torch.Tensor:
    if dist == "uniform":
        return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0
    return torch.randn(shape, generator=generator, device=device)


def _smooth_field(shape, block: int = 8, dist: str = "uniform", generator=None,
                  coarse: Optional[torch.Tensor] = None, device=None):
    """Random field that is spatially smooth at window scale: i.i.d. values
    on a (H/block + 2, W/block + 2) grid, bilinearly upsampled to (H, W).

    shape: leading dims are batch, last two are (H, W). `coarse` is the
    pre-drawn grid (shape[:-2] + grid); without it the grid is drawn from
    `generator`, uniform in [-1, 1) or standard normal. A sequence of
    generators draws one grid per index of the first dim, so each batch row
    depends on its own generator only."""
    H, W = shape[-2], shape[-1]
    grid = tuple(shape[:-2]) + (H // block + 2, W // block + 2)
    if coarse is not None:
        if tuple(coarse.shape) != grid:
            raise ValueError(f"coarse field {tuple(coarse.shape)} != {grid}")
        f = coarse.to(device=device, dtype=torch.float32)
    elif isinstance(generator, (list, tuple)):
        f = torch.stack([_draw(g, grid[1:], dist, device) for g in generator])
    else:
        f = _draw(generator, grid, dist, device)
    return resize(f, (H, W))


class _Fields:
    """The coarse grids of one PatchMatch run, handed out in call order:
    pre-drawn (`fields`, each (B,) + grid) or drawn from B generators."""

    def __init__(self, fields, generators, device):
        self._fields = list(fields) if fields is not None else None
        self._gens = generators
        self._device = device

    def smooth(self, shape):
        coarse = None
        if self._fields is not None:
            if not self._fields:
                raise ValueError("coarse_fields ran out before the run ended")
            coarse = self._fields.pop(0)
        return _smooth_field(shape, generator=self._gens, coarse=coarse,
                             device=self._device)

    def check_used(self):
        if self._fields:
            raise ValueError(f"{len(self._fields)} coarse_fields left unused")


def _rays_for(K: torch.Tensor, H: int, W: int, dtype) -> torch.Tensor:
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=K.device),
        torch.arange(W, dtype=dtype, device=K.device),
        indexing="ij",
    )
    pix_h = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    Kinv = torch.linalg.inv(K)
    # einsum("ij,hwj->hwi", Kinv, pix_h) == pix_h @ Kinv^T
    return torch.matmul(pix_h, Kinv.T)


def _scale_K(K: torch.Tensor, factor: int) -> torch.Tensor:
    """Intrinsics at a 1/factor downscale under the pixel-area (half-pixel
    center) convention of jax.image.resize: u' = (u + 0.5)/f - 0.5."""
    f = float(factor)
    off = 0.5 / f - 0.5
    S = torch.tensor(
        [[1.0 / f, 0.0, off], [0.0, 1.0 / f, off], [0.0, 0.0, 1.0]],
        dtype=K.dtype, device=K.device,
    )
    return S @ K


def _run_level(
    ref_gray, src_grays, K, R_ref, t_ref, R_srcs, t_srcs,
    dmin, dmax, fields: _Fields, depth0, iters: int, it_offset: int,
    num_samples: int, patch: int, steps,
):
    """`iters` PatchMatch rounds (propagation + refinement) at the level's
    resolution, starting from depth0 (B, H, W). dmin, dmax: (B,). Returns
    (depth, rays, cost_fn)."""
    B, H, W = ref_gray.shape
    rays = _rays_for(K, H, W, ref_gray.dtype)
    z_floor = dmin * 0.05  # scale-relative near-camera validity floor
    lo = dmin[:, None, None, None]
    hi = dmax[:, None, None, None]

    def cost_fn(fields_d):
        return _eval_cost(fields_d, rays, ref_gray, src_grays, K, R_ref, t_ref,
                          R_srcs, t_srcs, patch, z_floor)

    def keep_best(depth, cand_d):
        """Score the current map and (B, C, H, W) candidates; keep the
        per-pixel argmin (first minimum on ties, like jnp.argmin)."""
        fields_d = torch.cat([depth[:, None], cand_d], dim=1)
        costs = cost_fn(fields_d)[0]
        ci = torch.argmin(costs, dim=1, keepdim=True)
        return torch.gather(fields_d, 1, ci)[:, 0]

    shifts = [
        (dy * s, dx * s)
        for s in steps
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))
    ]
    depth = depth0
    for it in range(it_offset, it_offset + iters):
        depth = keep_best(
            depth,
            torch.stack([_shift2d(depth, dy, dx, dims=(1, 2)) for dy, dx in shifts],
                        dim=1),
        )
        scales = 0.5 ** (
            torch.arange(num_samples, dtype=ref_gray.dtype, device=depth.device) + it
        )
        dd = (
            fields.smooth((B, num_samples, H, W))
            * scales[:, None, None] * (hi - lo)
        )
        depth = keep_best(depth, torch.minimum(torch.maximum(depth[:, None] + dd, lo), hi))
    return depth, rays, cost_fn


def patchmatch_depth_batch(
    ref_grays: torch.Tensor,     # (B, H, W)
    src_grays: torch.Tensor,     # (B, J, H, W)
    K: torch.Tensor,             # (3, 3) shared, at working scale
    R_refs: torch.Tensor,        # (B, 3, 3)
    t_refs: torch.Tensor,        # (B, 3)
    R_srcss: torch.Tensor,       # (B, J, 3, 3)
    t_srcss: torch.Tensor,       # (B, J, 3)
    depth_ranges: torch.Tensor,  # (B, 2) = (dmin, dmax)
    generators: Optional[Sequence[torch.Generator]] = None,
    coarse_fields: Optional[Sequence[torch.Tensor]] = None,
    num_iterations: int = 3,
    num_samples: int = 8,
    patch: int = 11,
    ncc_threshold: float = 0.6,
    coarse_factor: int = 4,
    fine_iterations: int = 1,
) -> DepthNormalMap:
    """A batch of reference views of PatchMatch MVS, each with its own
    randomness: coarse_fields[k] is (B,) + grid of the k-th _smooth_field
    call, or else generators[b] draws view b's grids. With neither, every
    view gets a generator seeded 0 on the inputs' device.

    Coarse-to-fine, as recon3d_tpu/dense/patchmatch.py:296-384: the
    num_iterations exploration rounds run at 1/coarse_factor resolution,
    the upsampled coarse field gets fine_iterations short-radius polish
    rounds at full resolution; coarse_factor=1 is the single-level form."""
    disable_tf32()
    B, H, W = ref_grays.shape
    dev = ref_grays.device
    if coarse_fields is None and generators is None:
        generators = [torch.Generator(device=dev).manual_seed(0) for _ in range(B)]
    fields = _Fields(coarse_fields, generators, dev)
    dmin = depth_ranges[:, 0]
    dmax = depth_ranges[:, 1]

    def log_uniform_init(shape):
        u = 0.5 * (fields.smooth((B,) + shape) + 1.0)
        lmin = torch.log(dmin)[:, None, None]
        lmax = torch.log(dmax)[:, None, None]
        return torch.exp(u * (lmax - lmin) + lmin)

    if coarse_factor > 1 and min(H, W) >= 4 * coarse_factor:
        Hc, Wc = H // coarse_factor, W // coarse_factor
        ref_c = resize(ref_grays, (Hc, Wc))
        src_c = resize(src_grays, (Hc, Wc))
        Kc = _scale_K(K, coarse_factor)
        depth_c, _, _ = _run_level(
            ref_c, src_c, Kc, R_refs, t_refs, R_srcss, t_srcss,
            dmin, dmax, fields, log_uniform_init((Hc, Wc)),
            iters=num_iterations, it_offset=0,
            num_samples=num_samples, patch=patch, steps=(1, 4, 16),
        )
        depth0 = resize(depth_c, (H, W))
        depth, rays, cost_fn = _run_level(
            ref_grays, src_grays, K, R_refs, t_refs, R_srcss, t_srcss,
            dmin, dmax, fields, depth0,
            iters=fine_iterations, it_offset=num_iterations,
            num_samples=max(num_samples // 2, 2), patch=patch,
            steps=(1, max(2, coarse_factor // 2)),
        )
    else:
        depth, rays, cost_fn = _run_level(
            ref_grays, src_grays, K, R_refs, t_refs, R_srcss, t_srcss,
            dmin, dmax, fields, log_uniform_init((H, W)),
            iters=num_iterations, it_offset=0,
            num_samples=num_samples, patch=patch, steps=(1, 4, 16),
        )
    fields.check_used()

    # Final confidence: number of source views with NCC above threshold.
    cost, ncc, ok = cost_fn(depth[:, None])
    confidence = ((ncc > ncc_threshold) & ok).sum(dim=1)[:, 0]
    return DepthNormalMap(
        depth=depth,
        normal=normals_from_depth(depth, rays),
        confidence=confidence,
        cost=cost[:, 0],
    )


def patchmatch_depth(
    ref_gray, src_grays, K, R_ref, t_ref, R_srcs, t_srcs, depth_range,
    generator: Optional[torch.Generator] = None,
    coarse_fields: Optional[Sequence[torch.Tensor]] = None,
    **kw,
) -> DepthNormalMap:
    """One reference view: ref_gray (H, W), src_grays (J, H, W), R_srcs
    (J, 3, 3), t_srcs (J, 3), depth_range (2,). coarse_fields[k] is the grid
    of the k-th _smooth_field call (no batch dim); else `generator` draws
    them. Keywords as patchmatch_depth_batch."""
    out = patchmatch_depth_batch(
        ref_gray[None], src_grays[None], K, R_ref[None], t_ref[None],
        R_srcs[None], t_srcs[None], depth_range[None],
        generators=None if generator is None else [generator],
        coarse_fields=None if coarse_fields is None else [f[None] for f in coarse_fields],
        **kw,
    )
    return DepthNormalMap(*(x[0] for x in out))


def select_source_views(
    ids: List[int],
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    scene_center: np.ndarray,
    k: int = 4,
    min_angle_deg: float = 5.0,
    max_angle_deg: float = 60.0,
) -> Dict[int, List[int]]:
    """Score candidate sources by baseline x triangulation-angle suitability
    (host numpy, copied from the JAX package): prefer large baselines whose
    viewing-ray angle at the scene center lies in [min_angle, max_angle];
    keep the top k per reference view."""
    C = {i: -poses[i][0].T @ poses[i][1] for i in ids}
    out: Dict[int, List[int]] = {}
    for i in ids:
        vi = scene_center - C[i]
        vi = vi / (np.linalg.norm(vi) + 1e-12)
        scored = []
        for j in ids:
            if j == i:
                continue
            vj = scene_center - C[j]
            vj = vj / (np.linalg.norm(vj) + 1e-12)
            ang = np.degrees(np.arccos(np.clip(vi @ vj, -1.0, 1.0)))
            baseline = np.linalg.norm(C[i] - C[j])
            w = 1.0 if min_angle_deg <= ang <= max_angle_deg else 0.1
            scored.append((baseline * w, j))
        scored.sort(reverse=True)
        out[i] = [j for _, j in scored[:k]]
    return out


def view_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator of the view at `position` in a run seeded `seed`: a
    view's map does not depend on which other views share its batch."""
    s = int(np.random.SeedSequence([seed, position]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PatchMatchMVS:
    """Dense reconstruction via PatchMatch MVS.

    reconstruct(images, poses, sparse_points) -> (points (N,3) float32,
    colors (N,3) uint8). `images` is (V, H, W, 3) float32 [0,1] full scale;
    `poses` a dict {idx: (R, t)} of registered cameras (numpy). Runs on
    `device` ("cuda" unless the caller asks for "cpu").

    Ported: the single-device path without checkpoints of
    recon3d_tpu/dense/patchmatch.py:476-614. The mesh, checkpoint and
    return_maps branches are not ported yet.
    """

    def __init__(self, camera: Camera, config: Optional[PatchMatchConfig] = None,
                 device="cuda"):
        self.camera = camera
        self.config = config or PatchMatchConfig()
        self.device = resolve_device(device)
        self.stats: Dict[str, float] = {}

    def reconstruct(
        self,
        images: np.ndarray,
        poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
        sparse_points: Optional[np.ndarray] = None,
        views_per_batch: int = 4,
        host_small: Optional[np.ndarray] = None,
    ):
        """host_small: optional (N, H*scale, W*scale, 3) prescaled color
        stack indexed like `images` (ImageSet.small_color)."""
        cfg = self.config
        dev = self.device
        t0 = time.time()
        ids = sorted(poses.keys())
        V = len(ids)
        J = min(cfg.num_source_views, V - 1)
        if V < 3 or J < 2:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)

        scale = cfg.scale
        Hs = int(images.shape[1] * scale)
        Ws = int(images.shape[2] * scale)
        K = self.camera.scaled(scale).K.cpu().numpy().astype(np.float32)

        # Downscale + gray on the host, as the JAX version does.
        from recon3d_tpu_torch.io.hostimg import resize_batch_np, rgb_to_gray_np

        if host_small is not None and host_small.shape[1:3] == (Hs, Ws):
            small = np.asarray(host_small[ids], np.float32)
        else:
            small = resize_batch_np(images[ids], (Hs, Ws))
        grays = rgb_to_gray_np(small)
        row = {i: r for r, i in enumerate(ids)}

        Rs = np.stack([poses[i][0] for i in ids]).astype(np.float32)
        ts = np.stack([poses[i][1] for i in ids]).astype(np.float32)
        centers = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
        scene_center = (
            np.median(sparse_points, axis=0)
            if sparse_points is not None and len(sparse_points) >= 20
            else centers.mean(0) + np.array([0.0, 0.0, 1.0])
        )
        sources = select_source_views(
            ids, poses, scene_center, k=J,
            min_angle_deg=cfg.min_triangulation_angle_deg,
            max_angle_deg=cfg.max_triangulation_angle_deg,
        )

        ranges = []
        fallback = depth_range_from_poses(Rs, ts)
        for i in ids:
            dr = None
            if sparse_points is not None:
                dr = depth_range_from_sparse(sparse_points, *poses[i])
            ranges.append(dr or fallback)
        ranges = np.asarray(ranges, np.float32)
        t_prep = time.time() - t0

        batch_d: List[torch.Tensor] = []
        batch_c: List[torch.Tensor] = []
        for _, out in self._depth_batches(
            list(range(V)), ids, grays, sources, Rs, ts, ranges, K, row,
            views_per_batch,
        ):
            batch_d.append(out.depth)
            batch_c.append(out.confidence)
        depth_all = torch.cat(batch_d, dim=0)
        conf_all = torch.cat(batch_c, dim=0)
        _sync(dev)
        return self._fuse_and_filter(
            depth_all, conf_all, K, Rs, ts, small, row, ids, t0, t_prep, V
        )

    def _depth_batches(self, positions, ids, grays, sources, Rs, ts, ranges, K,
                       row, views_per_batch):
        """Yield (positions, DepthNormalMap) per batch of views. One upload
        of the small gray stack; a batch's planes are device-side gathers.
        The view at position v draws from view_generator(cfg.seed, v)."""
        cfg = self.config
        dev = self.device
        grays_d = torch.from_numpy(np.ascontiguousarray(grays)).to(dev)
        K_d = torch.from_numpy(K).to(dev)
        Rs_d = torch.from_numpy(Rs).to(dev)
        ts_d = torch.from_numpy(ts).to(dev)
        ranges_d = torch.from_numpy(ranges).to(dev)
        for b0 in range(0, len(positions), views_per_batch):
            pos = positions[b0 : b0 + views_per_batch]
            src_rows = torch.tensor(
                [[row[j] for j in sources[ids[v]]] for v in pos], device=dev
            )
            pos_t = torch.tensor(pos, device=dev)
            out = patchmatch_depth_batch(
                grays_d[pos_t], grays_d[src_rows], K_d,
                Rs_d[pos_t], ts_d[pos_t], Rs_d[src_rows], ts_d[src_rows],
                ranges_d[pos_t],
                generators=[view_generator(cfg.seed, v, dev) for v in pos],
                num_iterations=cfg.num_iterations,
                num_samples=cfg.num_refine_samples,
                patch=cfg.patch_size,
                ncc_threshold=cfg.ncc_confidence_threshold,
                coarse_factor=cfg.coarse_factor,
                fine_iterations=cfg.fine_iterations,
            )
            yield pos, out

    def _fuse_and_filter(
        self, depth_all, conf_all, K, Rs, ts, small, row, ids, t0, t_prep, V
    ):
        """Back-project every confident pixel of every view in one batched
        call, compact on the device, then radius-filter + voxel-downsample
        on the host."""
        cfg = self.config
        dev = self.device
        J = min(cfg.num_source_views, V - 1)
        min_views = min(cfg.min_views, J)
        t_depth = time.time() - t0 - t_prep
        pts_b, mask_b = backproject_depth(
            depth_all, torch.from_numpy(K).to(dev),
            torch.from_numpy(Rs).to(dev), torch.from_numpy(ts).to(dev),
            conf_all >= min_views,
        )
        points, sel_idx = fused_points_compact(pts_b, mask_b)
        colors = (
            small[[row[i] for i in ids]].reshape(-1, 3)[sel_idx] * 255
        ).astype(np.uint8)
        t_fuse = time.time() - t0 - t_prep - t_depth
        if len(points):
            from recon3d_tpu_torch.dense.filters import (
                radius_outlier_filter,
                voxel_downsample,
            )

            points, colors = radius_outlier_filter(points, colors)
            points, colors = voxel_downsample(points, colors, cfg.voxel_size)
        t_filter = time.time() - t0 - t_prep - t_depth - t_fuse
        self.stats = {
            "prep": t_prep, "depth": t_depth, "fuse": t_fuse,
            "filter": t_filter, "total": time.time() - t0,
        }
        print(
            f"[patchmatch] {len(points)} points from {V} views "
            f"({time.time() - t0:.1f}s: prep {t_prep:.1f}, depth {t_depth:.1f}, "
            f"fuse {t_fuse:.1f}, filter {t_filter:.1f})"
        )
        return points.astype(np.float32), colors
