"""The benchmark's scenes: a textured box corner ray-cast on the device.

A scene is three textured planes (a back wall, a floor and a side wall)
seen from an arc of cameras that look at the origin. Each plane carries
octaves of smooth value noise, a function of the surface point, so the
texture is the same surface seen from every camera. The arithmetic
follows the repository's numpy renderer (tests/render.py, `render_views`)
step for step, in float64, so the two agree to rounding at any size and
at its texture (`RENDER_VIEWS_TEXTURE`: seven octaves, each 0.55 of the
last); the cast runs in torch on whatever device it is given.

A configuration states its scenes' texture (`texture`: octaves, decay).
At 1600x1200 `render_views`' finest octave is a few pixels wide but 0.03
of the first in amplitude, so its images are smooth where a photograph
of a DTU object has detail down to the pixel; the configurations take
more octaves that fade more slowly.

Two pixel conventions meet here. `render_views` casts the ray of pixel j
through j + 0.5 with cx = W / 2; the benchmark hands the program the same
camera in OpenCV's convention (pixel centres at integers, cx = W / 2 - 0.5),
which casts the same rays. `cast` takes the offset of the pixel centre.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

RENDER_VIEWS_TEXTURE = {"octaves": 7, "decay": 0.55}
VIEWS_A_CAST = 4     # views ray-cast together: float64 temporaries of ~0.2 GB at 1600x1200


@dataclass(frozen=True)
class Plane:
    origin: Tuple[float, float, float]
    u: Tuple[float, float, float]
    v: Tuple[float, float, float]
    half_u: float
    half_v: float
    seed: int


def box_corner(seeds: Sequence[int] = (11, 22, 33)) -> List[Plane]:
    """The back wall (z = 1.5), the floor (y = 1.2) and the side wall
    (x = -2), textured from `seeds` (render_views' default_scene_planes)."""
    e = np.eye(3)
    return [
        Plane((0.0, 0.0, 1.5), tuple(e[0]), tuple(e[1]), 2.5, 2.0, int(seeds[0])),
        Plane((0.0, 1.2, 0.0), tuple(e[0]), tuple(e[2]), 2.5, 2.0, int(seeds[1])),
        Plane((-2.0, 0.0, 0.0), tuple(e[2]), tuple(e[1]), 2.0, 2.0, int(seeds[2])),
    ]


def arc_cameras(n_views: int, arc_step: float, arc_offset: float,
                rng_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(Rs (V, 3, 3), ts (V, 3)) float64, world to camera: an arc of radius
    3.5 around the origin, each centre's height jittered by N(0, 0.1) from
    `rng_seed`, every camera looking at the origin with y down."""
    rng = np.random.default_rng(rng_seed)
    Rs, ts = [], []
    for i in range(n_views):
        theta = (i - (n_views - 1) / 2.0) * arc_step + arc_offset
        C = np.array([3.5 * np.sin(theta), -0.3 + 0.1 * rng.normal(), -3.5 * np.cos(theta)])
        z = -C / np.linalg.norm(C)
        x = np.cross(np.array([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], axis=0)
        Rs.append(R)
        ts.append(-R @ C)
    return np.stack(Rs), np.stack(ts)


def intrinsics(height: int, width: int, focal_factor: float = 0.9,
               centre_offset: float = 0.5) -> np.ndarray:
    """K (3, 3) float64 with f = focal_factor * width. centre_offset 0.5
    gives OpenCV's convention (cx = W / 2 - 0.5), 0 render_views' K."""
    f = focal_factor * width
    return np.array([[f, 0.0, width / 2.0 - centre_offset],
                     [0.0, f, height / 2.0 - centre_offset],
                     [0.0, 0.0, 1.0]])


def noise_grids(seed: int, device, octaves: int) -> List[torch.Tensor]:
    """The value-noise lattices of one plane: octave o is a (4*2^o + 1)^2
    grid of uniforms, drawn in order from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((4 * 2**o + 1,) * 2)).to(device)
            for o in range(octaves)]


def _value_noise(u: torch.Tensor, v: torch.Tensor, grids: List[torch.Tensor],
                 decay: float) -> torch.Tensor:
    """Octaves of smoothstep-interpolated value noise at (u, v) in [-1, 1],
    each `decay` of the last in amplitude, normalised by its largest value
    over the whole array (as render_views does, pixels off the plane
    included)."""
    out = torch.zeros_like(u)
    amp = 1.0
    for grid in grids:
        res = grid.shape[0] - 1
        x = (u * 0.5 + 0.5) * res
        y = (v * 0.5 + 0.5) * res
        x0 = torch.clamp(torch.floor(x), 0, res - 1)
        y0 = torch.clamp(torch.floor(y), 0, res - 1)
        fx = x - x0
        fy = y - y0
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        xi, yi = x0.long(), y0.long()
        val = (grid[yi, xi] * (1 - fx) * (1 - fy) + grid[yi, xi + 1] * fx * (1 - fy)
               + grid[yi + 1, xi] * (1 - fx) * fy + grid[yi + 1, xi + 1] * fx * fy)
        out = out + amp * val
        amp *= decay
    return out / (out.reshape(out.shape[0], -1).amax(dim=1)[:, None, None] + 1e-9)


def cast(planes: List[Plane], K: np.ndarray, Rs: np.ndarray, ts: np.ndarray,
         height: int, width: int, device, pixel_offset: float = 0.0,
         shade: bool = True, texture: dict = RENDER_VIEWS_TEXTURE):
    """Ray-cast views (Rs, ts) at (height, width): pixel (y, x) casts the
    ray through K^-1 [x + pixel_offset, y + pixel_offset, 1], the planes
    textured by `texture` (octaves, decay). Returns
    (shade (V, H, W) float64 or None, depth (V, H, W) float64: the
    camera-frame z of the nearest hit, 0 where the ray hits nothing)."""
    dev = torch.device(device)
    f64 = torch.float64
    Kt = torch.as_tensor(np.asarray(K, np.float64), device=dev)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=f64, device=dev) + pixel_offset,
                            torch.arange(width, dtype=f64, device=dev) + pixel_offset,
                            indexing="ij")
    xn = (xs - Kt[0, 2]) / Kt[0, 0]
    yn = (ys - Kt[1, 2]) / Kt[1, 1]
    dirs_cam = torch.stack([xn, yn, torch.ones_like(xs)], dim=-1)     # (H, W, 3)
    grids = ({p.seed: noise_grids(p.seed, dev, texture["octaves"]) for p in planes}
             if shade else None)
    shades, depths = [], []
    for c0 in range(0, len(Rs), VIEWS_A_CAST):
        R = torch.as_tensor(np.asarray(Rs[c0:c0 + VIEWS_A_CAST], np.float64), device=dev)
        t = torch.as_tensor(np.asarray(ts[c0:c0 + VIEWS_A_CAST], np.float64), device=dev)
        C = -torch.einsum("bji,bj->bi", R, t)                          # centres
        dirs = torch.einsum("hwj,bji->bhwi", dirs_cam, R)              # world rays
        best = torch.full(dirs.shape[:3], float("inf"), dtype=f64, device=dev)
        sh = torch.zeros_like(best) if shade else None
        for p in planes:
            o = torch.tensor(p.origin, dtype=f64, device=dev)
            pu = torch.tensor(p.u, dtype=f64, device=dev)
            pv = torch.tensor(p.v, dtype=f64, device=dev)
            n = torch.linalg.cross(pu, pv)
            n = n / torch.linalg.norm(n)
            denom = dirs @ n
            tt = ((o - C) @ n)[:, None, None] / torch.where(denom.abs() < 1e-9, 1e-9, denom)
            pt = C[:, None, None, :] + tt[..., None] * dirs
            lu = (pt - o) @ pu
            lv = (pt - o) @ pv
            hit = (tt > 0.1) & (lu.abs() <= p.half_u) & (lv.abs() <= p.half_v)
            closer = hit & (tt < best)
            if shade:
                tex = _value_noise(torch.where(closer, lu / p.half_u, 0.0),
                                   torch.where(closer, lv / p.half_v, 0.0), grids[p.seed],
                                   texture["decay"])
                sh = torch.where(closer, 0.15 + 0.8 * tex, sh)
            best = torch.where(closer, tt, best)
        depths.append(torch.where(torch.isfinite(best), best, 0.0))
        if shade:
            shades.append(sh)
    depth = torch.cat(depths)
    return (torch.cat(shades) if shade else None), depth


TINT = (1.0, 0.95, 0.9)


def render(spec: dict, device) -> dict:
    """One capture from a scene spec (`scene_spec`): images (V, H, W, 3)
    float32 on the host, the camera K in OpenCV's convention (float64),
    the true Rs, ts (float64), the planes and the device it was cast on."""
    H, W = spec["height"], spec["width"]
    planes = box_corner(spec["plane_seeds"])
    Rs, ts = arc_cameras(spec["views"], spec["arc_step"], spec["arc_offset"], spec["rng_seed"])
    K = intrinsics(H, W, spec["focal_factor"])
    shade, _ = cast(planes, K, Rs, ts, H, W, device, texture=spec["texture"])
    tint = torch.tensor(TINT, dtype=torch.float32, device=shade.device)
    images = (shade.to(torch.float32)[..., None] * tint).cpu().numpy()
    return {"images": images, "K": K, "Rs": Rs, "ts": ts, "planes": planes, "spec": spec,
            "device": shade.device}


TEXTURES = (11, 22, 33)


def scene_spec(config: dict, seed: int, k: int) -> dict:
    """Scene k of a run seeded `seed` under a configuration: its sizes and
    arc from the configuration, the repository's textures (render_views'
    plane seeds, with the configuration's octaves), and the cameras' height
    jitter from (seed, k). Every seed
    and every k gives the same sizes and surface, seen from slightly other
    cameras, so the work of a scene hardly depends on the seed."""
    state = np.random.SeedSequence([int(seed), int(k)]).generate_state(1)
    views = config["views"]
    return {"views": views, "height": config["height"], "width": config["width"],
            "arc_step": config["arc_span_rad"] / (views - 1),
            "arc_offset": config["arc_span_rad"] / 2.0,
            "focal_factor": config["focal_factor"], "rng_seed": int(state[0]),
            "plane_seeds": list(TEXTURES), "texture": dict(config["texture"])}


def surface_samples(capture: dict, count: int, seed: int, scale: float = 1 / 16) -> np.ndarray:
    """(count, 3) float32 points on the surface that the cameras see, drawn
    from the seed: the stand-in for a COLMAP model's sparse points. Cast at
    `scale` of the image size, hits back-projected to the world."""
    H = max(int(capture["spec"]["height"] * scale), 1)
    W = max(int(capture["spec"]["width"] * scale), 1)
    K = np.diag([scale, scale, 1.0]) @ capture["K"]
    dev = capture["device"]
    _, depth = cast(capture["planes"], K, capture["Rs"], capture["ts"], H, W, dev, shade=False)
    pts = backproject(depth, K, capture["Rs"], capture["ts"])[depth.reshape(-1) > 0]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    pick = rng.choice(len(pts), size=min(count, len(pts)), replace=False)
    return pts[torch.from_numpy(np.sort(pick)).to(dev)].cpu().numpy().astype(np.float32)


def backproject(depth: torch.Tensor, K: np.ndarray, Rs: np.ndarray, ts: np.ndarray) -> torch.Tensor:
    """World points (V*H*W, 3) float64 of depth maps (V, H, W) whose pixel
    (y, x) sits at (x, y) in K's frame."""
    V, H, W = depth.shape
    dev, f64 = depth.device, torch.float64
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev), indexing="ij")
    d = depth.to(f64)
    Xc = torch.stack([(xs - K[0, 2]) / K[0, 0] * d, (ys - K[1, 2]) / K[1, 1] * d, d], dim=-1)
    R = torch.as_tensor(np.asarray(Rs, np.float64), device=dev)
    t = torch.as_tensor(np.asarray(ts, np.float64), device=dev)
    return torch.einsum("vhwj,vji->vhwi", Xc - t[:, None, None, :], R).reshape(-1, 3)
