"""Synthetic geometric-shapes corpus for SuperPoint pretraining.

A copy of recon3d_tpu/neural/synthetic.py (pure numpy), kept in the port so
that it imports nothing of the JAX package: for one numpy seed both render
the same images, labels, homographies, view pairs and batches. It is the
MagicPoint recipe (DeTone et al., "SuperPoint", CVPR-W 2018, section 4.1):
images of simple geometric primitives (segments, polygons, checkerboards,
stars, ellipses) whose corners are known exactly, value-noise textures,
true 3-D view pairs, and random homography warps for descriptor training.
Everything runs on the host; the trainers upload one round of compact
batches at a time (neural/pretrain.py).

Label semantics match the SuperPoint detector head: the (H/8, W/8) coarse
grid gets a 65-way one-hot target per cell, index `8*dy+dx` of the corner
pixel inside the cell, or 64 ("dustbin") when the cell contains no corner.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

CELL = 8
DUSTBIN = 64


# ---------------------------------------------------------------------------
# rasterization helpers (pure numpy)
# ---------------------------------------------------------------------------

def _draw_line(img: np.ndarray, p0, p1, color: float, thickness: int = 1):
    """Bresenham-ish dense line raster by sampling along the segment."""
    H, W = img.shape
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(p0[0] + (p1[0] - p0[0]) * t).astype(int)
    ys = np.round(p0[1] + (p1[1] - p0[1]) * t).astype(int)
    r = thickness // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, W - 1)
            yi = np.clip(ys + dy, 0, H - 1)
            img[yi, xi] = color


def _fill_poly(img: np.ndarray, pts: np.ndarray, color: float):
    """Scanline polygon fill (pts (K, 2) xy)."""
    H, W = img.shape
    ys = pts[:, 1]
    y0, y1 = int(max(0, np.floor(ys.min()))), int(min(H - 1, np.ceil(ys.max())))
    K = len(pts)
    for y in range(y0, y1 + 1):
        xs: List[float] = []
        for i in range(K):
            ax, ay = pts[i]
            bx, by = pts[(i + 1) % K]
            if (ay <= y < by) or (by <= y < ay):
                xs.append(ax + (y - ay) * (bx - ax) / (by - ay))
        xs.sort()
        for i in range(0, len(xs) - 1, 2):
            a = int(max(0, np.ceil(xs[i])))
            b = int(min(W - 1, np.floor(xs[i + 1])))
            if b >= a:
                img[y, a : b + 1] = color


# ---------------------------------------------------------------------------
# primitives — each returns its corner list
# ---------------------------------------------------------------------------

def _add_segments(rng, img, n: int) -> np.ndarray:
    H, W = img.shape
    corners = []
    for _ in range(n):
        p0 = rng.uniform([4, 4], [W - 5, H - 5])
        p1 = rng.uniform([4, 4], [W - 5, H - 5])
        if np.hypot(*(p1 - p0)) < 8:
            continue
        _draw_line(img, p0, p1, float(rng.uniform(0, 1)), int(rng.integers(1, 3)))
        corners += [p0, p1]
    return np.array(corners).reshape(-1, 2)


def _add_polygon(rng, img) -> np.ndarray:
    H, W = img.shape
    k = int(rng.integers(3, 6))
    c = rng.uniform([W * 0.2, H * 0.2], [W * 0.8, H * 0.8])
    radius = rng.uniform(min(H, W) * 0.1, min(H, W) * 0.35)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    if np.min(np.diff(np.concatenate([ang, [ang[0] + 2 * np.pi]]))) < 0.35:
        return np.zeros((0, 2))
    pts = c + radius * np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.6, 1.0, (k, 1))
    pts = np.clip(pts, 2, [W - 3, H - 3])
    _fill_poly(img, pts, float(rng.uniform(0, 1)))
    return pts


def _add_star(rng, img) -> np.ndarray:
    H, W = img.shape
    c = rng.uniform([W * 0.25, H * 0.25], [W * 0.75, H * 0.75])
    k = int(rng.integers(3, 6))
    color = float(rng.uniform(0, 1))
    pts = []
    for _ in range(k):
        p = c + rng.uniform(-0.3, 0.3, 2) * min(H, W)
        p = np.clip(p, 4, [W - 5, H - 5])
        _draw_line(img, c, p, color, int(rng.integers(1, 3)))
        pts.append(p)
    return np.array([c] + pts)


def _add_checkerboard(rng, img) -> np.ndarray:
    H, W = img.shape
    rows, cols = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    cw = int(rng.uniform(8, 20))
    x0 = int(rng.integers(2, max(3, W - cols * cw - 2)))
    y0 = int(rng.integers(2, max(3, H - rows * cw - 2)))
    shade = rng.uniform(0, 1, 2)
    for r in range(rows):
        for cc in range(cols):
            y, x = y0 + r * cw, x0 + cc * cw
            img[y : y + cw, x : x + cw] = shade[(r + cc) % 2]
    corners = [
        (x0 + cc * cw, y0 + r * cw)
        for r in range(rows + 1)
        for cc in range(cols + 1)
    ]
    return np.array(corners, np.float64)


def _add_ellipse(rng, img) -> np.ndarray:
    """Ellipses are corner-free — pure negatives for the detector."""
    H, W = img.shape
    c = rng.uniform([W * 0.2, H * 0.2], [W * 0.8, H * 0.8])
    ab = rng.uniform(4, min(H, W) * 0.2, 2)
    yy, xx = np.mgrid[0:H, 0:W]
    m = ((xx - c[0]) / ab[0]) ** 2 + ((yy - c[1]) / ab[1]) ** 2 <= 1.0
    img[m] = rng.uniform(0, 1)
    return np.zeros((0, 2))


def render_shapes(
    rng: np.random.Generator, hw: Tuple[int, int] = (128, 128)
) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic training image.

    Returns (image (H, W) float32 in [0,1], corners (N, 2) float32 xy).
    """
    H, W = hw
    img = np.full((H, W), rng.uniform(0, 1), np.float64)
    # low-frequency background gradient
    gx, gy = rng.uniform(-0.3, 0.3, 2)
    yy, xx = np.mgrid[0:H, 0:W]
    img += gx * xx / W + gy * yy / H

    corners: List[np.ndarray] = []
    kind = rng.integers(0, 4)
    if kind == 0:
        corners.append(_add_segments(rng, img, int(rng.integers(3, 8))))
    elif kind == 1:
        for _ in range(int(rng.integers(1, 4))):
            corners.append(_add_polygon(rng, img))
    elif kind == 2:
        corners.append(_add_checkerboard(rng, img))
    else:
        corners.append(_add_star(rng, img))
    if rng.uniform() < 0.3:
        _add_ellipse(rng, img)

    img += rng.normal(0, 0.02, img.shape)  # sensor noise
    # cheap 3x3 box blur with probability 1/2 (anti-aliasing variety)
    if rng.uniform() < 0.5:
        k = np.ones(3) / 3.0
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img = np.clip(img, 0, 1).astype(np.float32)

    cs = (
        np.concatenate([c for c in corners if len(c)], 0)
        if any(len(c) for c in corners)
        else np.zeros((0, 2))
    )
    inb = (
        (cs[:, 0] >= 1) & (cs[:, 0] <= W - 2) & (cs[:, 1] >= 1) & (cs[:, 1] <= H - 2)
        if len(cs)
        else np.zeros(0, bool)
    )
    return img, cs[inb].astype(np.float32)


# ---------------------------------------------------------------------------
# labels + homographies
# ---------------------------------------------------------------------------

def render_texture(
    rng: np.random.Generator, hw: Tuple[int, int] = (128, 128),
    octaves: int = 6,
) -> np.ndarray:
    """Multi-octave value-noise texture image (H, W) float32 in [0, 1].

    The photometric-texture half of the training corpus: smooth correlated
    noise like natural surface texture, with no analytic corner labels —
    labels come from homographic-adaptation pseudo-labeling
    (pretrain.pseudo_label_images). Closing the gap between the shapes
    corpus and photographic imagery is what lifts repeatability on real
    textures (docs/neural_quality.md).
    """
    H, W = hw
    out = np.zeros((H, W))
    amp = 1.0
    for octv in range(octaves):
        res = 3 * 2**octv
        grid = rng.random((res + 1, res + 1))
        y = np.linspace(0, res, H, endpoint=False)
        x = np.linspace(0, res, W, endpoint=False)
        y0 = np.floor(y).astype(int)
        x0 = np.floor(x).astype(int)
        fy = (y - y0)[:, None]
        fx = (x - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        val = (
            grid[np.ix_(y0, x0)] * (1 - fx) * (1 - fy)
            + grid[np.ix_(y0, x0 + 1)] * fx * (1 - fy)
            + grid[np.ix_(y0 + 1, x0)] * (1 - fx) * fy
            + grid[np.ix_(y0 + 1, x0 + 1)] * fx * fy
        )
        out += amp * val
        amp *= rng.uniform(0.45, 0.65)
    out = (out - out.min()) / (out.max() - out.min() + 1e-9)
    # random contrast/brightness + sensor noise, like render_shapes
    out = np.clip(
        rng.uniform(0.6, 1.3) * (out - 0.5) + rng.uniform(0.3, 0.7)
        + rng.normal(0, 0.02, out.shape),
        0, 1,
    )
    return out.astype(np.float32)


def cells_from_corners(corners: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Corner pixels -> (H/8, W/8) int32 cell labels in [0, 64]."""
    H, W = hw
    Hc, Wc = H // CELL, W // CELL
    lab = np.full((Hc, Wc), DUSTBIN, np.int32)
    for x, y in corners:
        xi, yi = int(round(x)), int(round(y))
        cy, cx = yi // CELL, xi // CELL
        if 0 <= cy < Hc and 0 <= cx < Wc:
            lab[cy, cx] = (yi % CELL) * CELL + (xi % CELL)
    return lab


def labels65(cells: np.ndarray) -> np.ndarray:
    """(Hc, Wc) int -> (Hc, Wc, 65) one-hot float32."""
    return np.eye(65, dtype=np.float32)[cells]


def random_homography(
    rng: np.random.Generator, hw: Tuple[int, int],
    max_rot: float = 0.35, max_scale: float = 0.25,
    max_shift: float = 0.12, max_persp: float = 3e-4,
) -> np.ndarray:
    """Random similarity + perspective homography mapping view A -> view B."""
    H, W = hw
    cx, cy = W / 2.0, H / 2.0
    ang = rng.uniform(-max_rot, max_rot)
    s = np.exp(rng.uniform(-max_scale, max_scale))
    tx = rng.uniform(-max_shift, max_shift) * W
    ty = rng.uniform(-max_shift, max_shift) * H
    ca, sa = np.cos(ang) * s, np.sin(ang) * s
    # translate-to-center . similarity . translate-back, then perspective row
    A = np.array([[ca, -sa, cx - ca * cx + sa * cy + tx],
                  [sa, ca, cy - sa * cx - ca * cy + ty],
                  [0.0, 0.0, 1.0]])
    A[2, 0] = rng.uniform(-max_persp, max_persp)
    A[2, 1] = rng.uniform(-max_persp, max_persp)
    return A


def warp_points(Hm: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Apply homography to (N, 2) points."""
    if len(xy) == 0:
        return xy
    p = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ Hm.T
    return p[:, :2] / np.maximum(np.abs(p[:, 2:]), 1e-9) * np.sign(p[:, 2:])


def warp_image(img: np.ndarray, Hm: np.ndarray) -> np.ndarray:
    """Inverse-map bilinear warp of (H, W) by homography A->B (output is B)."""
    H, W = img.shape
    Hinv = np.linalg.inv(Hm)
    yy, xx = np.mgrid[0:H, 0:W]
    src = warp_points(Hinv, np.stack([xx.ravel(), yy.ravel()], -1))
    sx, sy = src[:, 0].reshape(H, W), src[:, 1].reshape(H, W)
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    ok = (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    v = (
        img[y0c, x0c] * (1 - fx) * (1 - fy)
        + img[y0c, x0c + 1] * fx * (1 - fy)
        + img[y0c + 1, x0c] * (1 - fx) * fy
        + img[y0c + 1, x0c + 1] * fx * fy
    )
    return np.where(ok, v, 0.0).astype(np.float32)


def cell_correspondence(
    Hm: np.ndarray, hw: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Coarse-grid correspondence A->B under homography.

    Returns (idx (Hc*Wc,) int32 flat index of the B cell each A cell lands
    in, valid (Hc*Wc,) bool in-bounds mask) — the InfoNCE positive targets
    for descriptor training.
    """
    H, W = hw
    Hc, Wc = H // CELL, W // CELL
    yy, xx = np.mgrid[0:Hc, 0:Wc]
    centers = np.stack(
        [xx.ravel() * CELL + CELL / 2 - 0.5, yy.ravel() * CELL + CELL / 2 - 0.5], -1
    )
    w = warp_points(Hm, centers)
    cx = np.floor(w[:, 0] / CELL).astype(np.int64)
    cy = np.floor(w[:, 1] / CELL).astype(np.int64)
    valid = (cx >= 0) & (cx < Wc) & (cy >= 0) & (cy < Hc)
    idx = np.where(valid, cy * Wc + cx, 0).astype(np.int32)
    return idx, valid


# ---------------------------------------------------------------------------
# true 3D view pairs (parallax + occlusion, beyond what a homography shows)
# ---------------------------------------------------------------------------

def _surface_noise(u: np.ndarray, v: np.ndarray, seed: int,
                   octaves: int = 5) -> np.ndarray:
    """Multi-octave value noise as a function of SURFACE coordinates
    (u, v) in [-1, 1] — consistent across viewpoints, so two renders of
    the same plane photograph the same texture."""
    rng = np.random.default_rng(seed)
    out = np.zeros_like(u)
    amp = 1.0
    for octv in range(octaves):
        res = 4 * 2 ** octv
        grid = rng.random((res + 2, res + 2))
        gu = np.clip((u + 1.0) * 0.5 * res, 0, res - 1e-6)
        gv = np.clip((v + 1.0) * 0.5 * res, 0, res - 1e-6)
        u0 = np.floor(gu).astype(int)
        v0 = np.floor(gv).astype(int)
        fu = gu - u0
        fv = gv - v0
        fu = fu * fu * (3 - 2 * fu)
        fv = fv * fv * (3 - 2 * fv)
        out += amp * (
            grid[v0, u0] * (1 - fu) * (1 - fv)
            + grid[v0, u0 + 1] * fu * (1 - fv)
            + grid[v0 + 1, u0] * (1 - fu) * fv
            + grid[v0 + 1, u0 + 1] * fu * fv
        )
        amp *= 0.55
    out -= out.min()
    return out / (out.max() + 1e-9)


def render_view_pair(
    rng: np.random.Generator, hw: Tuple[int, int] = (128, 128),
):
    """Render ONE random textured multi-plane scene from TWO cameras with
    true parallax and occlusion — the appearance/geometry change an SfM
    matcher actually faces, which a homography warp of a single image can
    never produce (no depth discontinuities, no view-dependent occlusion).

    Scene: a fronto-leaning backdrop plane + a ground plane + 1-2 floating
    occluder panels at intermediate depth, each textured with value noise
    over its surface coords. Camera A looks +z from the origin; camera B is
    displaced by a random baseline and re-aimed at the scene center.

    Returns dict: img_a, img_b (H, W) float32; depth_a, depth_b (H, W)
    float32 (0 = no hit); K (3, 3); Ra, ta, Rb, tb (world->cam).
    """
    H, W = hw
    f = 0.9 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]], np.float32)

    # planes: (origin, u_axis, v_axis, half_u, half_v, seed)
    planes = []
    seed0 = int(rng.integers(1 << 30))

    def _unit(a):
        return a / (np.linalg.norm(a) + 1e-12)

    # backdrop ~4 away, tilted up to ~35 deg
    n = _unit(np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.6, 0.6), -1.0]))
    u = _unit(np.cross(np.array([0.0, 1.0, 0.0]), n))
    v = np.cross(n, u)
    planes.append((np.array([0.0, 0.0, rng.uniform(3.2, 4.5)]),
                   u, v, 4.0, 4.0, seed0))
    # ground plane below, visible in the lower image half
    planes.append((np.array([0.0, rng.uniform(0.9, 1.4), 2.5]),
                   np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
                   4.0, 4.0, seed0 + 1))
    # floating occluders at intermediate depth
    for k in range(int(rng.integers(1, 3))):
        n = _unit(np.array(
            [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), -1.0]
        ))
        u = _unit(np.cross(np.array([0.0, 1.0, 0.0]), n))
        v = np.cross(n, u)
        planes.append((
            np.array([rng.uniform(-0.9, 0.9), rng.uniform(-0.7, 0.7),
                      rng.uniform(1.6, 2.6)]),
            u, v, rng.uniform(0.25, 0.6), rng.uniform(0.25, 0.6),
            seed0 + 2 + k,
        ))

    target = np.array([0.0, 0.0, 2.8])

    def _look_at(C):
        z = _unit(target - C)
        x = _unit(np.cross(np.array([0.0, -1.0, 0.0]), z))
        y = np.cross(z, x)
        R = np.stack([x, y, z], 0)
        return R.astype(np.float32), (-R @ C).astype(np.float32)

    Ra, ta = _look_at(np.zeros(3))
    # baseline up to ~0.9 with a little depth/height variation: median
    # triangulation parallax 5-20 deg, like adjacent SfM views
    Cb = np.array([
        rng.uniform(-0.9, 0.9), rng.uniform(-0.25, 0.25),
        rng.uniform(-0.3, 0.3),
    ])
    Rb, tb = _look_at(Cb)

    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    dirs_cam = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
         np.ones_like(xs)], -1,
    )

    out = {}
    for tag, (R, t) in (("a", (Ra, ta)), ("b", (Rb, tb))):
        C = -R.T @ t
        dirs = dirs_cam @ R
        best_t = np.full((H, W), np.inf)
        shade = np.zeros((H, W))
        for (o, pu, pv, hu, hv, seed) in planes:
            pn = np.cross(pu, pv)
            denom = dirs @ pn
            tt = ((o - C) @ pn) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            pt = C + tt[..., None] * dirs
            lu = (pt - o) @ pu
            lv = (pt - o) @ pv
            closer = (
                (tt > 0.1) & (np.abs(lu) <= hu) & (np.abs(lv) <= hv)
                & (tt < best_t)
            )
            if not closer.any():
                continue
            tex = _surface_noise(
                np.where(closer, lu / hu, 0.0),
                np.where(closer, lv / hv, 0.0), seed,
            )
            shade = np.where(closer, 0.12 + 0.82 * tex, shade)
            best_t = np.where(closer, tt, best_t)
        out[f"img_{tag}"] = shade.astype(np.float32)
        out[f"depth_{tag}"] = np.where(
            np.isfinite(best_t), best_t, 0.0
        ).astype(np.float32)
    out.update(K=K, Ra=Ra, ta=ta, Rb=Rb, tb=tb)
    return out


def project_view_points(xy: np.ndarray, depth_a: np.ndarray,
                        depth_b: np.ndarray, K, Ra, ta, Rb, tb,
                        occl_tol: float = 0.03):
    """Project view-A pixels into view B via A's GT depth.

    Returns (uv_b (N, 2) float32, covisible (N,) bool) — covisible means
    the point has depth in A, lands in B's bounds with positive depth, and
    is not occluded there (|depth_b - z| < occl_tol * depth_b)."""
    if len(xy) == 0:
        return np.zeros((0, 2), np.float32), np.zeros(0, bool)
    Hb, Wb = depth_b.shape
    xi = np.clip(np.round(xy[:, 0]).astype(int), 0, depth_a.shape[1] - 1)
    yi = np.clip(np.round(xy[:, 1]).astype(int), 0, depth_a.shape[0] - 1)
    d = depth_a[yi, xi]
    has = d > 0
    rays = np.stack(
        [(xy[:, 0] - K[0, 2]) / K[0, 0], (xy[:, 1] - K[1, 2]) / K[1, 1],
         np.ones(len(xy))], -1,
    )
    Xw = (rays * d[:, None] - ta) @ Ra  # R^T (Xc - t)
    Xb = Xw @ Rb.T + tb
    z = Xb[:, 2]
    uv = np.stack(
        [K[0, 0] * Xb[:, 0] / np.maximum(z, 1e-9) + K[0, 2],
         K[1, 1] * Xb[:, 1] / np.maximum(z, 1e-9) + K[1, 2]], -1,
    ).astype(np.float32)
    inb = (
        has & (z > 1e-6)
        & (uv[:, 0] >= 0) & (uv[:, 0] <= Wb - 1)
        & (uv[:, 1] >= 0) & (uv[:, 1] <= Hb - 1)
    )
    xb = np.clip(np.round(uv[:, 0]).astype(int), 0, Wb - 1)
    yb = np.clip(np.round(uv[:, 1]).astype(int), 0, Hb - 1)
    db = depth_b[yb, xb]
    vis = inb & (db > 0) & (np.abs(db - z) < occl_tol * np.maximum(db, 1e-6))
    return uv, vis


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def make_detector_batch(rng, batch: int, hw=(128, 128)):
    """-> images (B, H, W, 1) f32, labels (B, Hc, Wc, 65) f32."""
    imgs, labs = [], []
    for _ in range(batch):
        im, cs = render_shapes(rng, hw)
        imgs.append(im[..., None])
        labs.append(labels65(cells_from_corners(cs, hw)))
    return np.stack(imgs), np.stack(labs)


def make_pair_batch_compact(rng, batch: int, hw=(128, 128), sampler=None):
    """Transfer-minimal pair batch: uint8 images + int8 cell labels.

    ~5x fewer bytes over the host->device link than make_pair_batch
    (float32 images + one-hot labels); the train step decodes on device.
    Keys: img_a, img_b (B, H, W, 1) uint8; cells_a, cells_b (B, Hc, Wc)
    int8 in [0, 64]; corr_idx (B, Hc*Wc) int32; corr_valid (B, Hc*Wc) bool.

    `sampler(rng) -> (image, corners)` overrides the shapes corpus (e.g.
    pseudo-labeled textures in the homographic-adaptation phase).
    """
    ia, ib, la, lb, ci, cv = [], [], [], [], [], []
    H, W = hw
    for _ in range(batch):
        im, cs = sampler(rng) if sampler else render_shapes(rng, hw)
        Hm = random_homography(rng, hw)
        imb = warp_image(im, Hm)
        csb = warp_points(Hm, cs)
        if len(csb):
            inb = (
                (csb[:, 0] >= 1) & (csb[:, 0] <= W - 2)
                & (csb[:, 1] >= 1) & (csb[:, 1] <= H - 2)
            )
            csb = csb[inb]
        idx, val = cell_correspondence(Hm, hw)
        ia.append((im * 255).astype(np.uint8)[..., None])
        ib.append((np.clip(imb, 0, 1) * 255).astype(np.uint8)[..., None])
        la.append(cells_from_corners(cs, hw).astype(np.int8))
        lb.append(cells_from_corners(csb, hw).astype(np.int8))
        ci.append(idx)
        cv.append(val)
    return dict(
        img_a=np.stack(ia), img_b=np.stack(ib),
        cells_a=np.stack(la), cells_b=np.stack(lb),
        corr_idx=np.stack(ci), corr_valid=np.stack(cv),
    )


def make_pair_batch(rng, batch: int, hw=(128, 128)):
    """Homography pairs for joint detector + descriptor training.

    -> dict with img_a, img_b (B, H, W, 1), lab_a, lab_b (B, Hc, Wc, 65),
       corr_idx (B, Hc*Wc) int32, corr_valid (B, Hc*Wc) bool.
    """
    ia, ib, la, lb, ci, cv = [], [], [], [], [], []
    for _ in range(batch):
        im, cs = render_shapes(rng, hw)
        Hm = random_homography(rng, hw)
        imb = warp_image(im, Hm)
        csb = warp_points(Hm, cs)
        H, W = hw
        if len(csb):
            inb = (
                (csb[:, 0] >= 1) & (csb[:, 0] <= W - 2)
                & (csb[:, 1] >= 1) & (csb[:, 1] <= H - 2)
            )
            csb = csb[inb]
        idx, val = cell_correspondence(Hm, hw)
        ia.append(im[..., None])
        ib.append(imb[..., None])
        la.append(labels65(cells_from_corners(cs, hw)))
        lb.append(labels65(cells_from_corners(csb, hw)))
        ci.append(idx)
        cv.append(val)
    return dict(
        img_a=np.stack(ia), img_b=np.stack(ib),
        lab_a=np.stack(la), lab_b=np.stack(lb),
        corr_idx=np.stack(ci), corr_valid=np.stack(cv),
    )
