"""Plain reference for the dense cells: what PatchMatch's maps and the
fused cloud of one scene must be, worked out from the benchmark's own
inputs in float64 torch.

It imports nothing of the program. The few rules of the program that say
what its outputs mean are frozen copies here: the working camera
(diag(scale, scale, 1) K), the anti-aliased half-pixel resize and BT.601
gray, the choice of source views and depth ranges, the confidence rule
(source views whose windowed NCC at the map's depth is above the
threshold), and the fusion (confident pixels back-projected, the 95th
percentile radius filter, the first point of each voxel).

Numbers of one scene (`check_scene`):
  depth_err_med    median over the fused pixels of |depth - true depth| /
                   true depth, the truth ray-cast along the program's own
                   pixel rays (the working camera)
  ncc_med          median over the pixels of the mean windowed NCC at the
                   program's depth over the source views that see the point
                   (the photo-consistency PatchMatch maximises)
  fused_share_min  the least share of a view's pixels that is fused
  conf_mismatch    share of pixels whose confidence differs from the
                   float64 recomputation at the program's depth
  cloud_err_max    the largest distance, over the cloud's points, to the
                   back-projection of the fused pixel it lands on,
                   relative to that pixel's depth
  cloud_count_dev  |points / the reference fusion's points - 1|

`control_scene` is the control: this reference put in the program's place
and computed in bfloat16 (the true depth maps, the confidence at them and
the fusion), judged by `check_scene` like the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import scene as bench_scene

F64 = torch.float64
GRAY = (0.299, 0.587, 0.114)


def working_K(K: np.ndarray, scale: float) -> np.ndarray:
    return np.diag([scale, scale, 1.0]) @ np.asarray(K, np.float64)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) anti-aliased triangle weights at half-pixel centres."""
    scale = n_out / n_in
    s = max(1.0, 1.0 / scale)
    x = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    j = np.arange(n_in, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) / s)
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)


def small_gray(images: np.ndarray, out_hw, device) -> torch.Tensor:
    """(V, h, w) float64 gray of (V, H, W, 3) images resized to out_hw."""
    V, H, W = images.shape[:3]
    Wy = torch.from_numpy(_resize_weights(H, out_hw[0])).to(device)
    Wx = torch.from_numpy(_resize_weights(W, out_hw[1])).to(device)
    g = torch.tensor(GRAY, dtype=F64, device=device)
    out = []
    for v in range(V):
        img = torch.tensor(images[v], dtype=F64, device=device)
        out.append(Wy @ (img @ g) @ Wx.T)
    return torch.stack(out)


def source_views(Rs: np.ndarray, ts: np.ndarray, centre: np.ndarray, k: int,
                 min_deg: float, max_deg: float) -> List[List[int]]:
    """For each view, the k others of largest baseline, weighted 0.1 where
    the viewing rays' angle at `centre` lies outside [min_deg, max_deg];
    ties to the larger index."""
    C = [-R.T @ t for R, t in zip(Rs, ts)]
    out = []
    for i in range(len(C)):
        vi = centre - C[i]
        vi = vi / (np.linalg.norm(vi) + 1e-12)
        scored = []
        for j in range(len(C)):
            if j == i:
                continue
            vj = centre - C[j]
            vj = vj / (np.linalg.norm(vj) + 1e-12)
            ang = np.degrees(np.arccos(np.clip(vi @ vj, -1.0, 1.0)))
            w = 1.0 if min_deg <= ang <= max_deg else 0.1
            scored.append((np.linalg.norm(C[i] - C[j]) * w, j))
        scored.sort(reverse=True)
        out.append([j for _, j in scored[:k]])
    return out


def near_depths(sparse: np.ndarray, Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Each view's nearest depth of its search: the 1st percentile of the
    sparse points' depths / 1.5 (at least 1e-3), else half the camera
    centres' spread x 2."""
    out = []
    C = np.stack([-R.T @ t for R, t in zip(Rs, ts)])
    spread = np.linalg.norm(C - C.mean(0), axis=1).max() * 2 + 1e-6
    for R, t in zip(Rs, ts):
        z = (sparse @ R.T + t)[:, 2]
        z = z[z > 1e-6]
        out.append(max(np.percentile(z, 1) / 1.5, 1e-3) if len(sparse) >= 20 and len(z) >= 20
                   else 0.5 * spread)
    return np.asarray(out)


def _box_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over the size x size window, clipped at the borders."""
    H, W = x.shape[-2:]
    r = size // 2
    ii = torch.nn.functional.pad(x, (1, 0, 1, 0)).cumsum(-2).cumsum(-1)
    ys = torch.arange(H, device=x.device)
    xs = torch.arange(W, device=x.device)
    y0, y1 = (ys - r).clamp(0, H)[:, None], (ys + r + 1).clamp(0, H)[:, None]
    x0, x1 = (xs - r).clamp(0, W)[None, :], (xs + r + 1).clamp(0, W)[None, :]
    s = ii[..., y1, x1] - ii[..., y0, x1] - ii[..., y1, x0] + ii[..., y0, x0]
    return s / ((y1 - y0) * (x1 - x0)).to(x.dtype)


def _bilinear(plane: torch.Tensor, px: torch.Tensor):
    """Samples of (H, W) at (..., 2) coordinates (x, y); valid inside
    [0, W-1] x [0, H-1]."""
    H, W = plane.shape
    x, y = px[..., 0], px[..., 1]
    ok = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x = torch.where(ok, x, 0.0)
    y = torch.where(ok, y, 0.0)
    x0, y0 = x.floor(), y.floor()
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long().clamp(0, W - 1), y0.long().clamp(0, H - 1)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    s = (plane[y0, x0] * (1 - fx) * (1 - fy) + plane[y0, x1] * fx * (1 - fy)
         + plane[y1, x0] * (1 - fx) * fy + plane[y1, x1] * fx * fy)
    return torch.where(ok, s, 0.0), ok


def confidence(depth: torch.Tensor, gray: torch.Tensor, K: np.ndarray, Rs, ts,
               sources: List[List[int]], z_floor: np.ndarray, patch: int,
               threshold: float, dtype=F64):
    """At each pixel's depth: (V, h, w) the count of its source views whose
    windowed NCC against the reference view exceeds `threshold`, and the
    matching cost, the mean 1 - NCC over the sources that see the point
    (inf where fewer than two do); computed in `dtype`."""
    V, H, W = depth.shape
    dev = depth.device
    Kt = torch.as_tensor(K, dtype=F64, device=dev)
    R = torch.as_tensor(np.asarray(Rs, np.float64), device=dev).to(dtype)
    t = torch.as_tensor(np.asarray(ts, np.float64), device=dev).to(dtype)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=F64, device=dev),
                            torch.arange(W, dtype=F64, device=dev), indexing="ij")
    rays = (torch.stack([xs, ys, torch.ones_like(xs)], -1) @ torch.linalg.inv(Kt).T).to(dtype)
    Kt = Kt.to(dtype)
    gray = gray.to(dtype)
    out = torch.zeros((V, H, W), dtype=torch.long, device=dev)
    cost = torch.zeros((V, H, W), dtype=F64, device=dev)
    seen = torch.zeros((V, H, W), dtype=torch.long, device=dev)
    for v in range(V):
        Xw = (rays * depth[v].to(dtype)[..., None] - t[v]) @ R[v]
        ref = gray[v]
        for j in sources[v]:
            Xs = Xw @ R[j].T + t[j]
            z = Xs[..., 2]
            uv = Xs[..., :2] / torch.where(z.abs() < 1e-8, 1e-8, z)[..., None]
            px = torch.stack([Kt[0, 0] * uv[..., 0] + Kt[0, 2],
                              Kt[1, 1] * uv[..., 1] + Kt[1, 2]], -1)
            src, ok = _bilinear(gray[j], px)
            ok = ok & (z > float(z_floor[v]))
            w = ok.to(dtype)
            cnt = _box_mean(w, patch) + 1e-6
            mr = _box_mean(ref * w, patch) / cnt
            ms = _box_mean(src * w, patch) / cnt
            cov = _box_mean(ref * src * w, patch) / cnt - mr * ms
            vr = torch.clamp_min(_box_mean(ref * ref * w, patch) / cnt - mr * mr, 1e-8)
            vs = torch.clamp_min(_box_mean(src * src * w, patch) / cnt - ms * ms, 1e-8)
            ncc = torch.clamp(cov / torch.sqrt(vr * vs), -1.0, 1.0)
            out[v] += (ok & (ncc > threshold)).long()
            cost[v] += torch.where(ok, 1.0 - ncc, 0.0)
            seen[v] += ok.long()
    cost = torch.where(seen >= 2, cost / seen.clamp_min(1), float("inf"))
    return out, cost


def backproject(depth: torch.Tensor, K: np.ndarray, Rs, ts, dtype=F64) -> torch.Tensor:
    """World points (V*H*W, 3) in `dtype` of depth maps (V, H, W) whose
    pixel (y, x) sits at (x, y) in K's frame."""
    V, H, W = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=F64, device=dev),
                            torch.arange(W, dtype=F64, device=dev), indexing="ij")
    xn = ((xs - K[0, 2]) / K[0, 0]).to(dtype)
    yn = ((ys - K[1, 2]) / K[1, 1]).to(dtype)
    d = depth.to(dtype)
    Xc = torch.stack([xn * d, yn * d, d], dim=-1)
    R = torch.as_tensor(np.asarray(Rs, np.float64), device=dev).to(dtype)
    t = torch.as_tensor(np.asarray(ts, np.float64), device=dev).to(dtype)
    return torch.einsum("vhwj,vji->vhwi", Xc - t[:, None, None, :], R).reshape(-1, 3)


def fuse_points(depth: torch.Tensor, fused: torch.Tensor, K: np.ndarray, Rs, ts,
                voxel: float, dtype=F64) -> torch.Tensor:
    """The reference fusion in `dtype`: the fused pixels back-projected,
    those beyond the 95th percentile of the distance to their centroid
    dropped, the first point of each occupied voxel kept."""
    pts = backproject(depth, K, Rs, ts, dtype)[fused.reshape(-1)]
    if len(pts) == 0:
        return pts
    r = torch.linalg.norm(pts - pts.mean(0), dim=1).double().cpu().numpy()
    pts = pts[torch.from_numpy(r <= np.percentile(r, 95.0)).to(pts.device)]
    _, inv = torch.unique(torch.floor(pts / voxel).long(), dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), len(pts), dtype=torch.long, device=pts.device)
    first.scatter_reduce_(0, inv, torch.arange(len(pts), device=pts.device), "amin")
    return pts[first]


def cloud_error(points: np.ndarray, depth: torch.Tensor, fused: torch.Tensor,
                K: np.ndarray, Rs, ts, chunk: int = 1 << 20) -> float:
    """The largest, over the points, of the distance to the float64
    back-projection of the fused pixel that the point projects onto,
    relative to that pixel's depth (the nearest such view); inf for a
    point that lands on no fused pixel."""
    if len(points) == 0:
        return 0.0
    V, H, W = depth.shape
    dev = depth.device
    Kt = torch.as_tensor(K, dtype=F64, device=dev)
    R = torch.as_tensor(np.asarray(Rs, np.float64), device=dev)
    t = torch.as_tensor(np.asarray(ts, np.float64), device=dev)
    worst = 0.0
    for c0 in range(0, len(points), chunk):
        p = torch.from_numpy(np.asarray(points[c0:c0 + chunk], np.float64)).to(dev)
        best = torch.full((len(p),), float("inf"), dtype=F64, device=dev)
        for v in range(V):
            Xc = p @ R[v].T + t[v]
            z = Xc[:, 2]
            u = Kt[0, 0] * Xc[:, 0] / z + Kt[0, 2]
            w = Kt[1, 1] * Xc[:, 1] / z + Kt[1, 2]
            xi, yi = torch.round(u), torch.round(w)
            inb = (z > 0) & (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            xi = torch.where(inb, xi, 0.0).long()
            yi = torch.where(inb, yi, 0.0).long()
            ok = inb & fused[v, yi, xi]
            d = depth[v, yi, xi].to(F64)
            Xp = torch.stack([(xi - Kt[0, 2]) / Kt[0, 0] * d, (yi - Kt[1, 2]) / Kt[1, 1] * d, d], -1)
            Xw = (Xp - t[v]) @ R[v]
            err = torch.linalg.norm(Xw - p, dim=1) / torch.clamp_min(d, 1e-12)
            best = torch.where(ok, torch.minimum(best, err), best)
        worst = max(worst, float(best.max()))
    return worst


def true_depth(truth: dict, K: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """(V, h, w) float64 depth of the rendered surface along the rays
    K^-1 [x, y, 1] of the true cameras; 0 where a ray hits nothing."""
    return bench_scene.cast(truth["planes"], K, truth["Rs"], truth["ts"], h, w, device,
                            shade=False)[1]


def _sources_and_floor(inputs: dict, J: int, pm: dict):
    """The source views and near-depth floors from the float32 inputs, as
    the program has them."""
    sparse, R32, t32 = inputs["sparse"], inputs["Rs"], inputs["ts"]
    centre = (np.median(sparse, axis=0) if len(sparse) >= 20
              else np.stack([-R.T @ t for R, t in zip(R32, t32)]).mean(0) + np.array([0, 0, 1.0]))
    sources = source_views(R32, t32, centre, J, pm["min_triangulation_angle_deg"],
                           pm["max_triangulation_angle_deg"])
    return sources, near_depths(sparse, R32, t32) * 0.05


def control_scene(inputs: dict, pm: dict, h: int, w: int, device,
                  dtype=torch.bfloat16) -> dict:
    """The control: the reference's own answer in `dtype` in the
    program's place. The true depth maps rounded to `dtype`, the
    confidence computed at them in `dtype`, and the fusion of the pixels
    it passes, in `dtype`; the same keys as the program's scene."""
    V = len(inputs["Rs"])
    K = working_K(inputs["K"], pm["scale"])
    depth = true_depth(inputs["truth"], K, h, w, device).to(dtype)
    J = min(pm["num_source_views"], V - 1)
    sources, z_floor = _sources_and_floor(inputs, J, pm)
    gray = small_gray(inputs["images"], (h, w), device)
    conf, _ = confidence(depth, gray, K, inputs["Rs"], inputs["ts"], sources, z_floor,
                         pm["patch_size"], pm["ncc_confidence_threshold"], dtype)
    fused = conf >= min(pm["min_views"], J)
    pts = fuse_points(depth, fused, K, inputs["Rs"], inputs["ts"], pm["voxel_size"], dtype)
    keep = torch.promote_types(dtype, torch.float32)     # bfloat16 widened exactly
    return {"depth": depth.to(keep), "conf": conf.to(torch.int32),
            "points": pts.to(keep).cpu().numpy()}


def check_scene(inputs: dict, out: dict, pm: dict) -> Dict[str, float]:
    """The numbers of one scene. inputs: what the program was handed (the
    images, the camera K, the float32 poses, the sparse points) and the
    rendered truth (`truth`: the float64 cameras and the planes); out: the
    program's depth and confidence maps and its cloud; pm: PatchMatch's
    settings (scale, patch_size, num_source_views, min_views,
    ncc_confidence_threshold, min/max_triangulation_angle_deg,
    voxel_size)."""
    depth, conf = out["depth"], out["conf"]
    V, h, w = depth.shape
    dev = depth.device
    K = working_K(inputs["K"], pm["scale"])
    Rs = inputs["Rs"].astype(np.float64)
    ts = inputs["ts"].astype(np.float64)
    J = min(pm["num_source_views"], V - 1)
    fused = conf >= min(pm["min_views"], J)

    nums = {"fused_share_min": float(fused.reshape(V, -1).double().mean(1).min()),
            "fused_share_med": float(fused.reshape(V, -1).double().mean(1).median())}
    truth = true_depth(inputs["truth"], K, h, w, dev)
    on = fused & (truth > 0)
    err = ((depth.to(F64) - truth).abs() / torch.where(truth > 0, truth, 1.0))[on]
    nums["depth_err_med"] = float(err.median()) if len(err) else float("inf")
    nums["depth_err_p90"] = float(torch.quantile(err[:1 << 24], 0.9)) if len(err) else float("inf")

    sources, z_floor = _sources_and_floor(inputs, J, pm)
    gray = small_gray(inputs["images"], (h, w), dev)
    ref_conf, cost = confidence(depth, gray, K, Rs, ts, sources, z_floor, pm["patch_size"],
                                pm["ncc_confidence_threshold"])
    nums["conf_mismatch"] = float((ref_conf != conf.to(ref_conf.dtype)).double().mean())
    seen = torch.isfinite(cost)
    nums["ncc_med"] = float(1.0 - cost[seen].median()) if seen.any() else -1.0

    points = out["points"]
    n_ref = len(fuse_points(depth, fused, K, Rs, ts, pm["voxel_size"]))
    nums["cloud_count_dev"] = abs(len(points) / max(n_ref, 1) - 1.0)
    nums["cloud_err_max"] = cloud_error(points, depth, fused, K, Rs, ts)
    return nums
