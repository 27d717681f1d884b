"""Chessboard corner detection (PyTorch port of recon3d_tpu/calib/corners.py).

Replaces cv.findChessboardCorners + cv.cornerSubPix: the dense response,
non-max suppression, top-k selection and subpixel fit run on the device for
all corners at once; only the O(corners) grid-ordering step runs on the
host.

Detector: chessboard X-corners are saddle points of the intensity surface,
so the response is the negated Hessian determinant  Ixy^2 - Ixx*Iyy  of a
Gaussian-smoothed image (large and positive exactly at saddles, ~0 on edges
and blobs). Refinement samples the gradient images at every corner's
window through K1 (ops/image.py::sample_planes): one launch an iteration
for all corners and both gradient planes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import central_gradients, gaussian_blur, sample_planes
from recon3d_tpu_torch.runtime.device import resolve_device
from recon3d_tpu_torch.runtime.profiling import StageTimer


class CornerCandidates(NamedTuple):
    xy: torch.Tensor        # (K, 2) subpixel positions (x, y)
    response: torch.Tensor  # (K,)
    valid: torch.Tensor     # (K,) bool


def saddle_response(gray: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Negated Hessian determinant of the smoothed image: positive at
    X-corners (saddles), ~0 elsewhere. torch.gradient takes the central
    differences and first-order edges of jnp.gradient."""
    g = gaussian_blur(gray, sigma)
    gy, gx = torch.gradient(g)
    gxy, gxx = torch.gradient(gx)
    gyy, _ = torch.gradient(gy)
    return gxy * gxy - gxx * gyy


def _nms(resp: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep only local maxima within a (2r+1)^2 window (wrapping rolls, as
    jnp.roll)."""
    r = radius
    m = resp
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            m = torch.maximum(m, torch.roll(resp, (dy, dx), dims=(0, 1)))
    return resp >= m


def detect_corners(
    gray: torch.Tensor,
    max_corners: int = 128,
    nms_radius: int = 5,
    sigma: float = 1.5,
    rel_threshold: float = 0.15,
) -> CornerCandidates:
    """Detect up to max_corners saddle points with subpixel refinement, on
    gray's device.

    Returns padded CornerCandidates; `valid` marks entries above
    rel_threshold * max_response.
    """
    H, W = gray.shape
    resp = saddle_response(gray, sigma)
    # suppress the border (gradient edge effects)
    yy = torch.arange(H, device=gray.device)[:, None]
    xx = torch.arange(W, device=gray.device)[None, :]
    inside = (yy >= 4) & (yy < H - 4) & (xx >= 4) & (xx < W - 4)
    resp = torch.where(inside & _nms(resp, nms_radius), resp, 0.0)

    # lax.top_k's order: equal values lower index first (NMS keeps both
    # pixels of a flat peak, and the grid ordering depends on their order)
    vals, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    iy = (idx // W).to(torch.float32)
    ix = (idx % W).to(torch.float32)
    valid = vals > rel_threshold * vals[0]

    # Subpixel: quadratic fit of the response around each peak, every
    # corner at once.
    resp_s = gaussian_blur(resp, 1.0)
    yi = iy.to(torch.int64)
    xi = ix.to(torch.int64)

    def at(dy, dx):
        return resp_s[(yi + dy).clamp(0, H - 1), (xi + dx).clamp(0, W - 1)]

    dxx = at(0, 1) + at(0, -1) - 2 * at(0, 0)
    dyy = at(1, 0) + at(-1, 0) - 2 * at(0, 0)
    dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    det = dxx * dyy - dxy * dxy
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    ox = (-(dyy * gx - dxy * gy) / det).clamp(-1.0, 1.0)
    oy = (-(dxx * gy - dxy * gx) / det).clamp(-1.0, 1.0)
    xy = torch.stack([ix + ox, iy + oy], dim=-1)
    return CornerCandidates(xy=xy, response=vals, valid=valid)


def order_chessboard_corners(
    xy: np.ndarray,
    pattern: Tuple[int, int] = (9, 6),
    response: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Organize detected corner candidates into a (rows*cols, 2) grid in
    row-major board order (host-side, O(corners) — the analogue of the
    ordering cv.findChessboardCorners performs internally).

    Approach: greedy lattice growth. Seed at the candidate nearest the
    centroid, take its two most orthogonal nearest-neighbor directions as the
    initial basis, then BFS over integer lattice cells, predicting each new
    cell by local parallelogram extrapolation from already-placed neighbors
    and snapping to the nearest unused candidate. Local prediction tolerates
    the perspective foreshortening that breaks a single global basis fit.
    Returns None if no full cols x rows window is found.
    """
    cols, rows = pattern
    need = cols * rows
    n = len(xy)
    if n < need:
        return None

    d2 = ((xy[None, :, :] - xy[:, None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)

    # seed: candidate nearest the cloud centroid
    seed = int(np.argmin(((xy - xy.mean(0)) ** 2).sum(-1)))
    order = np.argsort(d2[seed])
    v1 = xy[order[0]] - xy[seed]
    v2 = None
    for cand in order[1:6]:
        v = xy[cand] - xy[seed]
        cosang = abs(v @ v1) / (np.linalg.norm(v) * np.linalg.norm(v1) + 1e-12)
        if cosang < 0.5:  # roughly orthogonal in the image
            v2 = v
            break
    if v2 is None:
        return None

    # BFS lattice growth
    placed = {(0, 0): seed, (1, 0): int(order[0])}
    v2_idx = int(np.argmin(((xy - (xy[seed] + v2)) ** 2).sum(-1)))
    placed[(0, 1)] = v2_idx
    used = set(placed.values())
    frontier = list(placed.keys())

    def predict(cell):
        """Parallelogram/linear extrapolation from placed neighbors."""
        i, j = cell
        # parallelogram: p(i,j) = p(i-di,j) + p(i,j-dj) - p(i-di,j-dj)
        for di, dj in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            a, b, c = (i - di, j), (i, j - dj), (i - di, j - dj)
            if a in placed and b in placed and c in placed:
                return xy[placed[a]] + xy[placed[b]] - xy[placed[c]]
        # linear: p(i,j) = 2 p(i-di,j-dj) - p(i-2di,j-2dj) along an axis
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            a, b = (i - di, j - dj), (i - 2 * di, j - 2 * dj)
            if a in placed and b in placed:
                return 2 * xy[placed[a]] - xy[placed[b]]
        return None

    step = min(np.linalg.norm(v1), np.linalg.norm(v2))
    while frontier:
        cell = frontier.pop()
        i, j = cell
        for nb in ((i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)):
            if nb in placed:
                continue
            pred = predict(nb)
            if pred is None:
                continue
            k = int(np.argmin(((xy - pred) ** 2).sum(-1)))
            if k in used:
                continue
            if np.linalg.norm(xy[k] - pred) > 0.35 * step:
                continue
            placed[nb] = k
            used.add(k)
            frontier.append(nb)

    if len(placed) < need:
        return None

    # Find the best fully-populated cols x rows (or transposed) window.
    # The lattice usually extends past the inner corners (the board's outer
    # boundary also produces saddles), so several windows can be fully
    # populated; score each by total detector response — inner X-corners
    # (black/white on both diagonals) respond far stronger than boundary
    # corners against the background.
    if response is None:
        response = np.ones(len(xy))
    best = None
    best_score = -np.inf
    keys = np.array(list(placed.keys()))
    for (w, h) in ((cols, rows), (rows, cols)):
        for i0 in range(keys[:, 0].min(), keys[:, 0].max() - w + 2):
            for j0 in range(keys[:, 1].min(), keys[:, 1].max() - h + 2):
                want = [
                    (i0 + di, j0 + dj) for dj in range(h) for di in range(w)
                ]
                if not all(c in placed for c in want):
                    continue
                idx = [placed[c] for c in want]
                score = float(response[idx].sum())
                if score > best_score:
                    best_score = score
                    grid = xy[idx].reshape(h, w, 2)
                    if (w, h) != (cols, rows):
                        grid = np.transpose(grid, (1, 0, 2))[::-1]
                    best = _canonical_order(grid.reshape(rows, cols, 2))
    return best


def _canonical_order(grid: np.ndarray) -> np.ndarray:
    """Flip the (rows, cols, 2) grid so it reads left-to-right, top-to-bottom
    in image coordinates (deterministic output order, like OpenCV)."""
    rows, cols = grid.shape[:2]
    if grid[0, 0, 0] > grid[0, -1, 0]:
        grid = grid[:, ::-1]
    if grid[0, 0, 1] > grid[-1, 0, 1]:
        grid = grid[::-1]
    return grid.reshape(rows * cols, 2).astype(np.float32)


def refine_corners_gradient(
    gray: torch.Tensor,
    xy: torch.Tensor,
    half_window: int = 5,
    iterations: int = 4,
) -> torch.Tensor:
    """Gradient-orthogonality subpixel refinement (cv.cornerSubPix's scheme):
    at a true corner q, every window gradient is orthogonal to (p - q), so q
    solves  (sum w g g^T) q = sum w g g^T p.  Bilinear-sampled gradients,
    Gaussian window, fixed iteration count, all corners at once: each
    iteration samples gx and gy at the (N * (2r+1)^2) window points in one
    K1 launch (the two planes share the points)."""
    g = gaussian_blur(gray, 1.0)
    planes = torch.stack(central_gradients(g))          # (2, H, W): gx, gy

    r = half_window
    ar = torch.arange(-r, r + 1, dtype=gray.dtype, device=gray.device)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    w = torch.exp(-(ox * ox + oy * oy) / (2.0 * (0.6 * r) ** 2)).reshape(-1)
    offsets = torch.stack([ox, oy], dim=-1).reshape(-1, 2)  # (M, 2) (x, y)

    q = xy
    for _ in range(iterations):
        p = q[:, None, :] + offsets                     # (N, M, 2)
        s, ok = sample_planes(planes, p[None])          # (2, N, M)
        sx, sy = s[0], s[1]
        wm = w * ok[0].to(gray.dtype)
        px, py = p[..., 0], p[..., 1]
        a11 = torch.sum(wm * sx * sx, dim=-1)
        a12 = torch.sum(wm * sx * sy, dim=-1)
        a22 = torch.sum(wm * sy * sy, dim=-1)
        b1 = torch.sum(wm * (sx * sx * px + sx * sy * py), dim=-1)
        b2 = torch.sum(wm * (sx * sy * px + sy * sy * py), dim=-1)
        det = a11 * a22 - a12 * a12
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        qn = torch.stack([(a22 * b1 - a12 * b2) / det, (a11 * b2 - a12 * b1) / det], dim=-1)
        # reject divergent steps
        q = torch.where((torch.linalg.norm(qn - q, dim=-1) < r)[:, None], qn, q)
    return q


def find_chessboard(
    gray: np.ndarray,
    pattern: Tuple[int, int] = (9, 6),
    sigma: float = 1.5,
    device="cuda",
    timer: Optional[StageTimer] = None,
) -> Optional[np.ndarray]:
    """Full detection: response + NMS + subpixel on the device, ordering on
    the host, gradient-orthogonality refinement of the ordered grid on the
    device.

    timer: a StageTimer that gets each step's seconds as "detect", "order"
    and "refine"; each step ends in a copy to the host, so the times are
    the device's too.

    Returns (rows*cols, 2) float32 corners in row-major board order, or None.
    """
    dev = resolve_device(device)
    timer = timer or StageTimer()
    cols, rows = pattern
    with timer.stage("detect"):
        gray_t = torch.tensor(np.asarray(gray, np.float32), device=dev)
        cand = detect_corners(
            gray_t,
            max_corners=max(2 * cols * rows, 128),
            sigma=sigma,
        )
        ok = cand.valid.cpu().numpy()
        xy = cand.xy.cpu().numpy()[ok]
        resp = cand.response.cpu().numpy()[ok]
    if len(xy) < cols * rows:
        return None
    with timer.stage("order"):
        grid = order_chessboard_corners(xy, pattern, response=resp)
    if grid is None:
        return None
    with timer.stage("refine"):
        return refine_corners_gradient(
            gray_t, torch.from_numpy(grid).to(dev)
        ).cpu().numpy().astype(np.float32)
