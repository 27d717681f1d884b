"""SIFT feature detection and description.

PyTorch port of recon3d_tpu/ops/sift.py on its CPU branch (exact top-k):

  - Gaussian / DoG pyramid: separable convolutions, every blur level of an
    octave from the octave's base in one pair of convolutions.
  - Extremum detection: one 3x3x3 window max / min over the whole DoG
    volume, every pixel tested in parallel.
  - Candidate selection: masked top-k per octave at a static capacity, so
    all downstream work has a fixed shape.
  - Subpixel refinement: batched 3x3 solves on gathered 27-neighbourhoods.
  - Orientation and descriptor: per-keypoint patches sampled with one flat
    nearest-neighbour gather, histograms as one-hot sums and an einsum over
    a precomputed soft-assignment tensor.

Where the JAX package maps a function over images with vmap, the functions
here take a leading batch: an image is (H, W) or (B, H, W), and every
per-keypoint tensor then is (K, ...) or (B, K, ...). Keypoint order is part
of the result (every index downstream refers to it): selections break
ties by the lower index on every device (ops/select.py).

Known deviations from OpenCV, as in the JAX package: no initial 2x
upsampling by default (`upsample`), one dominant orientation per keypoint
unless `multi_orientation`, one refinement step instead of a loop. The
upsampled octave keeps the JAX package's coordinate convention
(xy = 0.5 * octave coordinate).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops.image import (
    downsample2,
    gaussian_blur,
    gaussian_kernel1d,
    resize,
)
from recon3d_tpu_torch.ops.select import argmax_first, topk_nonneg_first

N_ORI_BINS = 36
N_DESC_BINS = 8
DESC_GRID = 4          # 4x4 spatial cells
PATCH = 12             # descriptor sampling grid (12x12 samples, 3x3 per cell)
ORI_PATCH = 10         # orientation sampling grid (10x10)
LAMBDA_ORI = 1.5       # orientation Gaussian window = lambda_ori * sigma
LAMBDA_DESC = 3.0      # descriptor cell size = lambda_desc * sigma


@dataclass(frozen=True)
class SiftFeatures:
    """Padded keypoint set of one image (capacity K), or of a batch of
    images when every field has a leading view dimension.

    xy:       (K, 2) pixel coordinates in the original image.
    scale:    (K,) sigma in original-image pixels.
    angle:    (K,) dominant orientation, radians.
    response: (K,) refined |DoG| response.
    desc:     (K, 128) L2-normalized descriptors.
    valid:    (K,) bool.
    """

    xy: torch.Tensor
    scale: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    def map(self, fn: Callable, *others: "SiftFeatures") -> "SiftFeatures":
        """fn applied field by field (to this set's field and the same
        field of each of `others`): the port's jax.tree.map."""
        return SiftFeatures(**{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)
        })

    def index(self, i) -> "SiftFeatures":
        """Field-wise `a[i]`: one image's view of a stacked batch."""
        return self.map(lambda a: a[i])

    def take(self, order: torch.Tensor) -> "SiftFeatures":
        """Reorder (or select) the keypoint axis by `order` (..., K')."""
        return self.map(lambda a: _take(a, order))

    @staticmethod
    def cat(parts: Sequence["SiftFeatures"], dim: int) -> "SiftFeatures":
        return parts[0].map(lambda *xs: torch.cat(xs, dim=dim), *parts[1:])


def _take(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Gather along the keypoint axis (the one after order's leading batch):
    a (..., K[, C]), order (..., K') -> (..., K'[, C])."""
    if a.dim() == order.dim():
        return torch.gather(a, -1, order)
    idx = order[..., None].expand(order.shape + (a.shape[-1],))
    return torch.gather(a, -2, idx)


# ---------------------------------------------------------------------------
# Pyramid


def _blur_stack(base: torch.Tensor, deltas: List[float]) -> torch.Tensor:
    """All blur levels of one octave in one separable pair of convolutions.

    base (B, H, W). Every level blurs directly from the octave base
    (Gaussian variances add), so the level axis is the output-channel axis
    of one horizontal convolution and one depthwise vertical convolution.
    The kernels are zero-padded to the widest radius, which reproduces each
    level's own edge-replicated padding. Returns (B, len(deltas) + 1, H, W)
    with the base first."""
    ks = [gaussian_kernel1d(d) for d in deltas]
    R = max(kk.shape[0] // 2 for kk in ks)
    Wk = 2 * R + 1
    C = len(ks)
    K = np.zeros((C, Wk), np.float32)
    for i, kk in enumerate(ks):
        r = kk.shape[0] // 2
        K[i, R - r: R + r + 1] = kk
    Kt = torch.from_numpy(K).to(base.device, base.dtype)

    pad = torch.nn.functional.pad
    xp = pad(base[:, None], (R, R, 0, 0), mode="replicate")
    h = torch.nn.functional.conv2d(xp, Kt.reshape(C, 1, 1, Wk))          # (B, C, H, W)
    hp = pad(h, (0, 0, R, R), mode="replicate")
    v = torch.nn.functional.conv2d(hp, Kt.reshape(C, 1, Wk, 1), groups=C)
    return torch.cat([base[:, None], v], dim=1)


def _as_batch(img: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if img.dim() == 2:
        return img[None], True
    if img.dim() != 3:
        raise ValueError(f"image must be (H, W) or (B, H, W), got {tuple(img.shape)}")
    return img, False


def build_pyramid(
    img: torch.Tensor, num_octaves: int, scales: int, sigma0: float
) -> List[torch.Tensor]:
    """Gaussian pyramid: per octave an (S+3, H_o, W_o) stack (with the
    image's leading batch, if any, in front).

    Level i has absolute scale sigma0 * 2^(i/S) relative to the octave
    base; the next octave seeds from level S (scale 2*sigma0)."""
    x, single = _as_batch(img)
    k = 2.0 ** (1.0 / scales)
    sigma_init = 0.5   # assumed blur of the input image (OpenCV convention)
    base = gaussian_blur(x, math.sqrt(max(sigma0**2 - sigma_init**2, 0.01)))
    deltas = [
        math.sqrt(max((sigma0 * k**i) ** 2 - sigma0**2, 1e-6))
        for i in range(1, scales + 3)
    ]
    octaves = []
    current = base
    for _ in range(num_octaves):
        stack = _blur_stack(current, deltas)
        octaves.append(stack)
        current = downsample2(stack[:, scales])
    return [o[0] for o in octaves] if single else octaves


# ---------------------------------------------------------------------------
# Detection


def _detect_octave(
    gauss: torch.Tensor,
    octave_idx: int,
    k_cap: int,
    scales: int,
    sigma0: float,
    contrast_threshold: float,
    edge_threshold: float,
    upsample: bool,
) -> dict:
    """Detect up to k_cap keypoints per image in one octave.

    gauss (B, S+3, H, W). Returns a dict of per-keypoint (B, k_cap[, 2])
    tensors: xy_full, x_oct, y_oct, level, sigma_oct, sigma_full, response,
    valid."""
    S = scales
    dog = gauss[:, 1:] - gauss[:, :-1]  # (B, S+2, H, W)
    B, L, H, W = dog.shape
    dev = dog.device

    # 3-D extrema: a pixel is a candidate if it equals the 3x3x3 max (or
    # min) and clears the pre-threshold. The pooling pads with -inf, so the
    # volume's faces compare only with what exists.
    pool = torch.nn.functional.max_pool3d
    mx = pool(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -pool(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    pre_thr = 0.5 * contrast_threshold / S
    absdog = dog.abs()
    is_ext = ((dog >= mx) | (dog <= mn)) & (absdog > pre_thr)
    del mx, mn

    # Edge rejection via the 2x2 spatial Hessian ratio.
    p = torch.nn.functional.pad(dog, (1, 1, 1, 1), mode="replicate")
    dxx = p[:, :, 1:-1, 2:] + p[:, :, 1:-1, :-2] - 2 * dog
    dyy = p[:, :, 2:, 1:-1] + p[:, :, :-2, 1:-1] - 2 * dog
    dxy = 0.25 * (p[:, :, 2:, 2:] + p[:, :, :-2, :-2] - p[:, :, 2:, :-2] - p[:, :, :-2, 2:])
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    del p, dxx, dyy, dxy, tr, det

    # Valid only in interior levels and pixels.
    lvl = torch.arange(L, device=dev)[:, None, None]
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    border = 5
    interior = (
        (lvl >= 1) & (lvl <= S)
        & (ys >= border) & (ys < H - border)
        & (xs >= border) & (xs < W - border)
    )
    cand = is_ext & edge_ok & interior

    # Candidates score |DoG| > 0, everything else 0: the k_cap largest, in
    # descending order, ties and the filler by ascending index.
    score = torch.where(cand, absdog, 0.0).reshape(B, -1)
    vals, idx = topk_nonneg_first(score, k_cap)
    valid = vals > 0
    del score, cand, is_ext, edge_ok, absdog

    li = idx // (H * W)
    yi = (idx % (H * W)) // W
    xi = idx % W

    # --- subpixel refinement on gathered 3x3x3 neighbourhoods
    flat = dog.reshape(B, -1)

    def gather(dl, dy, dx):
        ii = (
            (li + dl).clamp(0, L - 1) * (H * W)
            + (yi + dy).clamp(0, H - 1) * W
            + (xi + dx).clamp(0, W - 1)
        )
        return torch.gather(flat, 1, ii)

    c = gather(0, 0, 0)
    gx = 0.5 * (gather(0, 0, 1) - gather(0, 0, -1))
    gy = 0.5 * (gather(0, 1, 0) - gather(0, -1, 0))
    gs = 0.5 * (gather(1, 0, 0) - gather(-1, 0, 0))
    hxx = gather(0, 0, 1) + gather(0, 0, -1) - 2 * c
    hyy = gather(0, 1, 0) + gather(0, -1, 0) - 2 * c
    hss = gather(1, 0, 0) + gather(-1, 0, 0) - 2 * c
    hxy = 0.25 * (gather(0, 1, 1) + gather(0, -1, -1) - gather(0, 1, -1) - gather(0, -1, 1))
    hxs = 0.25 * (gather(1, 0, 1) + gather(-1, 0, -1) - gather(1, 0, -1) - gather(-1, 0, 1))
    hys = 0.25 * (gather(1, 1, 0) + gather(-1, -1, 0) - gather(1, -1, 0) - gather(-1, 1, 0))

    Hm = torch.stack(
        [
            torch.stack([hxx, hxy, hxs], -1),
            torch.stack([hxy, hyy, hys], -1),
            torch.stack([hxs, hys, hss], -1),
        ],
        -2,
    )  # (B, K, 3, 3)
    g = torch.stack([gx, gy, gs], -1)  # (B, K, 3)
    # damped solve for robustness on near-singular Hessians; solve_ex does
    # not stop for a singular system (the slot then fails the offset test)
    Hd = Hm + 1e-6 * torch.eye(3, dtype=dog.dtype, device=dev)
    off = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
    off = off.clamp(-1.0, 1.0)
    d_hat = c + 0.5 * (g * off).sum(dim=-1)

    contrast_ok = d_hat.abs() >= contrast_threshold / S
    off_ok = off.abs().amax(dim=-1) <= 1.0
    valid = valid & contrast_ok & off_ok

    x_o = xi.to(torch.float32) + off[..., 0]
    y_o = yi.to(torch.float32) + off[..., 1]
    l_o = li.to(torch.float32) + off[..., 2]

    oct_scale = 2.0**octave_idx * (0.5 if upsample else 1.0)
    xy_full = torch.stack([x_o, y_o], -1) * oct_scale
    sigma_oct = sigma0 * torch.pow(2.0, l_o / S)  # in pixels of this octave
    sigma_full = sigma_oct * oct_scale

    return dict(
        xy_full=xy_full,
        x_oct=x_o,
        y_oct=y_o,
        level=li,
        sigma_oct=sigma_oct,
        sigma_full=sigma_full,
        response=d_hat.abs(),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Orientation + descriptor (patch-based, einsum binning)


@functools.lru_cache(maxsize=None)
def _ring_grid(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(gy, gx) of the (n+2)x(n+2) sampling grid: [-1, 1] stretched by
    1 + 2/n, so that the inner n x n samples have a ring around them for
    central differences. float32, spaced as `start*(1-t) + stop*t`."""
    m = n + 2
    t = np.arange(m - 1, dtype=np.float32) / np.float32(m - 1)
    lin = np.concatenate([np.float32(-1.0) * (1 - t) + np.float32(1.0) * t,
                          np.ones(1, np.float32)])
    lin = lin * np.float32(1.0 + 2.0 / n)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    return gy, gx


def _sample_patches(
    gauss: torch.Tensor,
    level: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    radius: torch.Tensor,
    angle: torch.Tensor,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample (B, K, n+2, n+2) patches (an extra ring for central
    differences) from gauss (B, L, H, W) at per-keypoint (B, K) level,
    centre, radius and angle.

    The grid spans [-radius, radius] in octave pixels, rotated by `angle`;
    each sample is the nearest pixel of the keypoint's own pyramid level,
    read with one flat gather. Returns (values, inside-the-image mask)."""
    B, L, H, W = gauss.shape
    gy, gx = (torch.from_numpy(a).to(gauss.device) for a in _ring_grid(n))
    ca = torch.cos(angle)[..., None, None]
    sa = torch.sin(angle)[..., None, None]
    rad = radius[..., None, None]
    px = (gx * ca - gy * sa) * rad
    py = (gx * sa + gy * ca) * rad
    sxc = cx[..., None, None] + px
    syc = cy[..., None, None] + py
    ok = (sxc >= 0) & (sxc <= W - 1) & (syc >= 0) & (syc <= H - 1)

    xi = torch.round(sxc).clamp(0.0, W - 1.0).to(torch.int64)
    yi = torch.round(syc).clamp(0.0, H - 1.0).to(torch.int64)
    flat_idx = (level[..., None, None] * H + yi) * W + xi
    vals = torch.gather(gauss.reshape(B, -1), 1, flat_idx.reshape(B, -1))
    return vals.reshape(flat_idx.shape), ok


def _patch_gradients(patch: torch.Tensor, ok: torch.Tensor):
    """Central-difference gradients of (..., m, m) patches -> (..., n, n)
    magnitude (zero where a tap left the image) and orientation."""
    gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy + 1e-16)
    ori = torch.atan2(gy, gx)  # [-pi, pi]
    valid = (ok[..., 1:-1, 1:-1] & ok[..., 1:-1, 2:] & ok[..., 1:-1, :-2]
             & ok[..., 2:, 1:-1] & ok[..., :-2, 1:-1])
    return mag * valid, ori


@functools.lru_cache(maxsize=None)
def _gauss_window(n: int, sigma_frac: float) -> np.ndarray:
    lin = np.linspace(-1.0, 1.0, n)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    return np.exp(-(gx**2 + gy**2) / (2 * sigma_frac**2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _spatial_assignment(n: int, d: int) -> np.ndarray:
    """(n, n, d, d) bilinear soft-assignment of samples to descriptor cells."""
    lin = (np.arange(n) + 0.5) / n * d - 0.5  # cell-space coordinate
    w = np.zeros((n, d), np.float32)
    for i, c in enumerate(lin):
        c0 = int(np.floor(c))
        f = c - c0
        if 0 <= c0 < d:
            w[i, c0] += 1 - f
        if 0 <= c0 + 1 < d:
            w[i, c0 + 1] += f
    return np.einsum("ya,xb->yxab", w, w).astype(np.float32)


def _soft_histogram(ori: torch.Tensor, wm: torch.Tensor, bins: int) -> torch.Tensor:
    """Each sample's weight `wm` split linearly between the two circular
    orientation bins around it: (..., n, n) -> (..., n, n, bins), as the
    weighted sum of two one-hot rows (a comparison, not a scatter: the sum
    that follows then adds in one fixed order)."""
    b = (ori + math.pi) / (2 * math.pi) * bins
    b0 = torch.floor(b)
    f = b - b0
    b0i = b0.to(torch.int64) % bins
    b1i = (b0i + 1) % bins
    cols = torch.arange(bins, device=ori.device)
    oh0 = (b0i[..., None] == cols).to(wm.dtype) * ((1 - f) * wm)[..., None]
    oh1 = (b1i[..., None] == cols).to(wm.dtype) * (f * wm)[..., None]
    return oh0 + oh1


def _interp_peak_angle(hist: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """Parabolic-interpolated angle (radians) of histogram bin `peak`."""
    def at(i):
        return torch.gather(hist, -1, (i % N_ORI_BINS)[..., None])[..., 0]

    hp, hl, hr = at(peak), at(peak - 1), at(peak + 1)
    denom = hl - 2 * hp + hr
    interp = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    bin_f = peak.to(hist.dtype) + interp.clamp(-0.5, 0.5)
    return bin_f / N_ORI_BINS * 2 * math.pi - math.pi


def _orientation(mag: torch.Tensor, ori: torch.Tensor):
    """Gradient orientations per keypoint from (..., n, n) gradients.

    Returns (angle, angle2, has2): the dominant orientation plus the
    strongest secondary local peak >= 0.8x the dominant one (OpenCV emits
    an extra keypoint at such peaks; extract_sift(multi_orientation=True))."""
    n = mag.shape[-1]
    w = torch.from_numpy(_gauss_window(n, 2.0 / 3.0)).to(mag.device)
    hist = _soft_histogram(ori, mag * w, N_ORI_BINS).sum(dim=(-3, -2))  # (..., 36)

    # two passes of circular [1,4,6,4,1]/16 smoothing
    for _ in range(2):
        h = hist
        hist = (
            6 * h
            + 4 * (torch.roll(h, 1, -1) + torch.roll(h, -1, -1))
            + (torch.roll(h, 2, -1) + torch.roll(h, -2, -1))
        ) / 16.0

    peak = argmax_first(hist, -1)
    angle = _interp_peak_angle(hist, peak)

    # Secondary peak: strongest circular local max that is not the primary
    # bin and clears OpenCV's 0.8 * primary threshold.
    hp = hist.amax(dim=-1)
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    cols = torch.arange(N_ORI_BINS, device=mag.device)
    is_local_max = (hist > left) & (hist >= right)
    eligible = is_local_max & (cols != peak[..., None]) & (hist >= 0.8 * hp[..., None])
    sec_val = torch.where(eligible, hist, -math.inf)
    peak2 = argmax_first(sec_val, -1)
    has2 = torch.isfinite(sec_val.amax(dim=-1))
    angle2 = _interp_peak_angle(hist, peak2)
    return angle, angle2, has2


def _descriptor(mag: torch.Tensor, ori: torch.Tensor, max_value: float) -> torch.Tensor:
    """SIFT 4x4x8 descriptor from rotated-patch gradients (..., n, n)."""
    n = mag.shape[-1]
    w = torch.from_numpy(_gauss_window(n, 0.5)).to(mag.device)
    ohist = _soft_histogram(ori, mag * w, N_DESC_BINS)            # (..., n, n, 8)
    spatial = torch.from_numpy(_spatial_assignment(n, DESC_GRID)).to(mag.device)
    desc = torch.einsum("...yxb,yxcd->...cdb", ohist, spatial)
    desc = desc.reshape(mag.shape[:-2] + (DESC_GRID * DESC_GRID * N_DESC_BINS,))

    def unit(d):
        return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)

    return unit(unit(desc).clamp_max(max_value))


# ---------------------------------------------------------------------------
# Full extractor


def _octave_capacities(max_features: int, num_octaves: int) -> List[int]:
    """Static per-octave candidate capacities, proportional to pixel count."""
    weights = [4.0**-o for o in range(num_octaves)]
    total = sum(weights)
    return [max(128, int(round(max_features * w / total))) for w in weights]


def _describe_octave(
    gauss: torch.Tensor,
    det: dict,
    scales: int,
    descriptor_max_value: float,
    multi_orientation: bool,
    cap_sel: int | None = None,
) -> List[SiftFeatures]:
    """Orientation + descriptor for one octave's detected candidates
    (gauss (B, S+3, H, W), det of (B, K) tensors).

    cap_sel: when given, only the top-cap_sel candidates by (valid,
    response) are described: the two-phase path (detect_sift /
    describe_sift). Detection capacity is a worst-case budget while typical
    images yield far fewer keypoints, and orientation and descriptor cost
    grows with slots, not keypoints. Returns a list of SiftFeatures parts
    (primary + optional secondary-orientation block)."""
    cap_det = det["valid"].shape[-1]
    if cap_sel is not None and cap_sel < cap_det:
        order = torch.argsort(
            torch.where(det["valid"], -det["response"], math.inf), stable=True
        )[..., :cap_sel]
        det = {k: _take(v, order) for k, v in det.items()}
    S = scales
    lvl = det["level"].clamp(0, S + 2)

    # Orientation from an unrotated patch (radius = 3 * lambda_ori * sigma).
    rad_ori = 3.0 * LAMBDA_ORI * det["sigma_oct"]
    patch, ok = _sample_patches(
        gauss, lvl, det["x_oct"], det["y_oct"], rad_ori,
        torch.zeros_like(det["x_oct"]), ORI_PATCH,
    )
    angle, angle2, has2 = _orientation(*_patch_gradients(patch, ok))

    # Descriptor from a patch rotated by the dominant orientation.
    rad_desc = (
        LAMBDA_DESC * det["sigma_oct"] * (DESC_GRID + 1) * 0.5 * math.sqrt(2.0)
    )
    dpatch, dok = _sample_patches(
        gauss, lvl, det["x_oct"], det["y_oct"], rad_desc, angle, PATCH,
    )
    desc = _descriptor(*_patch_gradients(dpatch, dok), descriptor_max_value)

    parts = [
        SiftFeatures(
            xy=det["xy_full"],
            scale=det["sigma_full"],
            angle=angle,
            response=det["response"],
            desc=desc,
            valid=det["valid"],
        )
    ]
    if multi_orientation:
        # Secondary-orientation keypoints: static 1/4-capacity slots, filled
        # by the strongest-response candidates with a qualifying second
        # peak; the rest carry valid=False. k2 derives from the detection
        # capacity (clamped to the selection capacity), so the two-phase
        # path emits the same secondary set as extract_sift.
        k2 = max(32, min(cap_det // 4, det["valid"].shape[-1]))
        sec_ok = det["valid"] & has2
        sec_score = torch.where(sec_ok, det["response"], -math.inf)
        idx2 = torch.argsort(-sec_score, stable=True)[..., :k2]
        dpatch2, dok2 = _sample_patches(
            gauss, _take(lvl, idx2), _take(det["x_oct"], idx2),
            _take(det["y_oct"], idx2), _take(rad_desc, idx2),
            _take(angle2, idx2), PATCH,
        )
        desc2 = _descriptor(*_patch_gradients(dpatch2, dok2), descriptor_max_value)
        parts.append(
            SiftFeatures(
                xy=_take(det["xy_full"], idx2),
                scale=_take(det["sigma_full"], idx2),
                angle=_take(angle2, idx2),
                response=_take(det["response"], idx2),
                desc=desc2,
                valid=_take(sec_ok, idx2),
            )
        )
    return parts


def _finalize_features(parts: List[SiftFeatures], single: bool) -> SiftFeatures:
    feats = SiftFeatures.cat(parts, dim=1)
    order = torch.argsort(torch.where(feats.valid, -feats.response, math.inf), stable=True)
    feats = feats.take(order)
    return feats.index(0) if single else feats


def _detect(img, max_features, num_octaves, scales, sigma0, contrast_threshold,
            edge_threshold, upsample):
    """detect_sift on a (B, H, W) batch."""
    if upsample:
        img = resize(img, (img.shape[-2] * 2, img.shape[-1] * 2))
    min_side = min(img.shape[-2], img.shape[-1])
    num_octaves = min(num_octaves, max(1, int(math.log2(min_side / 16))))
    pyramid = build_pyramid(img, num_octaves, scales, sigma0)
    caps = _octave_capacities(max_features, num_octaves)
    dets = [
        _detect_octave(gauss, o, caps[o], scales, sigma0, contrast_threshold,
                       edge_threshold, upsample)
        for o, gauss in enumerate(pyramid)
    ]
    counts = torch.stack([d["valid"].sum(dim=-1) for d in dets], dim=-1)
    return pyramid, dets, counts


def detect_sift(
    img: torch.Tensor,
    max_features: int = 8000,
    num_octaves: int = 4,
    scales: int = 3,
    sigma0: float = 1.6,
    contrast_threshold: float = 0.03,
    edge_threshold: float = 15.0,
    upsample: bool = False,
):
    """Detection phase of the two-phase SIFT path: Gaussian pyramid +
    per-octave extrema and refinement at full (worst-case) candidate
    capacities. img is (H, W) or a batch (B, H, W). Returns (pyramid, dets,
    counts) where counts (O,) or (B, O) is the per-octave count of valid
    candidates: the only value the host needs to fetch to pick the describe
    phase's slot buckets."""
    x, single = _as_batch(img)
    pyramid, dets, counts = _detect(
        x, max_features, num_octaves, scales, sigma0, contrast_threshold,
        edge_threshold, upsample)
    if single:
        pyramid = [g[0] for g in pyramid]
        dets = [{k: v[0] for k, v in d.items()} for d in dets]
        counts = counts[0]
    return tuple(pyramid), tuple(dets), counts


def describe_sift(
    pyramid,
    dets,
    caps_sel,
    scales: int = 3,
    descriptor_max_value: float = 0.2,
    multi_orientation: bool = False,
) -> SiftFeatures:
    """Describe phase of the two-phase SIFT path: per octave, the top
    caps_sel[o] candidates by (valid, response) get orientation and
    descriptors. Takes detect_sift's output, batched or not."""
    single = pyramid[0].dim() == 3
    parts = []
    for o, (gauss, det) in enumerate(zip(pyramid, dets)):
        if single:
            gauss, det = gauss[None], {k: v[None] for k, v in det.items()}
        parts.extend(
            _describe_octave(
                gauss, det, scales, descriptor_max_value,
                multi_orientation, cap_sel=int(caps_sel[o]),
            )
        )
    return _finalize_features(parts, single)


def extract_sift(
    img: torch.Tensor,
    max_features: int = 8000,
    num_octaves: int = 4,
    scales: int = 3,
    sigma0: float = 1.6,
    contrast_threshold: float = 0.03,
    edge_threshold: float = 15.0,
    upsample: bool = False,
    descriptor_max_value: float = 0.2,
    multi_orientation: bool = False,
) -> SiftFeatures:
    """Detect + describe SIFT features of a grayscale image (H, W) in
    [0, 1], or of a batch (B, H, W).

    Returns a SiftFeatures with capacity = sum of the per-octave capacities
    (>= max_features), sorted by validity, then response.

    multi_orientation: emit an extra keypoint at each secondary orientation
    peak >= 0.8x the dominant one, as OpenCV does; the secondary slots are
    capped at 1/4 of each octave's capacity, strongest responses first."""
    x, single = _as_batch(img)
    pyramid, dets, _ = _detect(
        x, max_features, num_octaves, scales, sigma0, contrast_threshold,
        edge_threshold, upsample)
    parts = []
    for gauss, det in zip(pyramid, dets):
        parts.extend(
            _describe_octave(gauss, det, scales, descriptor_max_value, multi_orientation)
        )
    return _finalize_features(parts, single)
