"""Image-space ops: gray, resize, warping, undistortion, box filter (the
dense path), and blur, decimation and gradients (the SIFT front end).

PyTorch port of recon3d_tpu/ops/image.py, each function on its JAX CPU
branch. The TPU-only branches (the MXU tent matmul at :216-224 and the
banded box filter at :324) are not ported: on the card, bilinear sampling
of 2-D planes goes through K1 (kernels/warp.py) whatever the plane size.

Layouts: `bilinear_sample`, `bilinear_sample_auto`, `undistort_image` and
`remap` keep the JAX layout, (H, W) or (H, W, C) images with (..., 2)
coordinates as (x, y). `resize` and `box_filter` act on the last two
dimensions of (..., H, W): a leading batch takes the place of vmap.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from recon3d_tpu_torch.io.hostimg import _resize_weights
from recon3d_tpu_torch.kernels.warp import tent_warp, tent_warp_reference
from recon3d_tpu_torch.ops.linalg import sum_batch_invariant

_GRAY_W = (0.299, 0.587, 0.114)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) luma (ITU-R BT.601 weights on RGB order)."""
    w = torch.tensor(_GRAY_W, dtype=img.dtype, device=img.device)
    return img @ w


def resize(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two dims of (..., H, W) to `shape` with
    jax.image.resize 'linear' semantics: half-pixel centres, triangle
    kernel, antialiased (kernel stretched) when downscaling, weights
    normalised per output sample. Two float32 weight-matrix products, the
    formulation of io/hostimg.resize_batch_np."""
    H, W = img.shape[-2], img.shape[-1]
    h, w = shape
    out = img
    if h != H:
        Wy = torch.from_numpy(_resize_weights(H, h)).to(img.device, img.dtype)
        out = torch.matmul(Wy, out)
    if w != W:
        Wx = torch.from_numpy(_resize_weights(W, w)).to(img.device, img.dtype)
        out = torch.matmul(out, Wx.T)
    return out


def resize_batch_invariant(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """`resize` whose result for a plane does not depend on how many planes
    share its batch: each output sample adds its few non-zero taps in a
    fixed order, rows first. On CUDA a matrix product's kernel, and so its
    order of summation, changes with the batch's size
    (scripts/batch_invariance_probe.py), and a mesh's shard of the dense
    stages is a smaller batch. It rounds otherwise than `resize` (within
    float32 rounding), so the stages that do not shard keep `resize`."""
    H, W = img.shape[-2], img.shape[-1]
    h, w = shape
    out = img
    if h != H:
        out = _resample_last(out.transpose(-1, -2), h).transpose(-1, -2)
    if w != W:
        out = _resample_last(out, w)
    return out


@functools.lru_cache(maxsize=None)
def _resize_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(index, weight), each (n_out, T): the non-zero entries of each row of
    _resize_weights(n_in, n_out), padded with zero weights to T."""
    wm = _resize_weights(n_in, n_out)
    nz = wm != 0
    T = max(int(nz.sum(1).max()), 1)
    idx = np.zeros((n_out, T), np.int64)
    wt = np.zeros((n_out, T), np.float32)
    for o in range(n_out):
        cols = np.flatnonzero(nz[o])
        idx[o, :len(cols)] = cols
        wt[o, :len(cols)] = wm[o, cols]
    return idx, wt


def _resample_last(x: torch.Tensor, n_out: int) -> torch.Tensor:
    idx, wt = _resize_taps(x.shape[-1], n_out)
    taps = x[..., torch.from_numpy(idx).to(x.device)]                 # (..., n_out, T)
    return sum_batch_invariant(taps * torch.from_numpy(wt).to(x.device, x.dtype), -1)


def _flat_coords(coords: torch.Tensor) -> torch.Tensor:
    return coords.reshape(1, -1, 2).contiguous()


def bilinear_sample(
    img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sampling with validity mask: the gather formula of
    recon3d_tpu/ops/image.py:98-144, always in plain PyTorch (K1's plain
    version, kernels/warp.tent_warp_reference).

    img (H, W) or (H, W, C); coords (..., 2) as (x, y) pixel coordinates.
    Returns (samples (...,[C]), valid (...,)); valid marks finite coords
    inside [0, W-1] x [0, H-1]; invalid samples are `fill`."""
    return _sample(img, coords, fill, tent_warp_reference)


def bilinear_sample_auto(
    img: torch.Tensor, coords: torch.Tensor, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """bilinear_sample that runs K1 on a CUDA tensor: every 2-D plane of
    any size, and an (H, W, C) image as C planes sharing the coordinates.
    On a CPU tensor it is the plain version."""
    return _sample(img, coords, fill, tent_warp)


def _sample(img, coords, fill, warp):
    lead = coords.shape[:-1]
    if img.dim() == 2:
        out, valid = warp(img[None].contiguous(), _flat_coords(coords), fill)
        return out[0].reshape(lead), valid[0].reshape(lead)
    if img.dim() != 3:
        raise ValueError(f"image must be (H, W) or (H, W, C), got {tuple(img.shape)}")
    planes = img.permute(2, 0, 1).contiguous()
    out, valid = warp(planes, _flat_coords(coords), fill)
    return out.T.reshape(lead + (img.shape[2],)), valid[0].reshape(lead)


def sample_planes(
    planes: torch.Tensor, coords: torch.Tensor, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched bilinear_sample_auto: planes (N, H, W), coords (N or 1, ...,
    2), one K1 launch on CUDA. Returns samples and valid of coords' leading
    shape with N in front."""
    N = planes.shape[0]
    lead = coords.shape[1:-1]
    out, valid = tent_warp(
        planes.contiguous(),
        coords.reshape(coords.shape[0], -1, 2).contiguous(),
        fill,
    )
    return out.reshape((N,) + lead), valid.reshape((N,) + lead)


def distort_points(norm_xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply OpenCV 5-parameter distortion [k1,k2,p1,p2,k3] to normalized
    coordinates (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = norm_xy[..., 0], norm_xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(
    norm_xy_dist: torch.Tensor, dist: torch.Tensor, iterations: int = 8
) -> torch.Tensor:
    """Invert the distortion model by fixed-point iteration (cv.undistortPoints
    uses the same scheme)."""
    xy = norm_xy_dist
    for _ in range(iterations):
        xy = xy + (norm_xy_dist - distort_points(xy, dist))
    return xy


def undistort_image(img: torch.Tensor, K: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Undistort so the pinhole model holds exactly afterwards (cv.undistort
    with an identical camera matrix): each target pixel samples the source
    at its forward-distorted position.

    img (H, W), (H, W, C), or a batch (V, H, W, C) that shares K and dist.
    On CUDA every channel plane goes through K1 in one launch."""
    batched = img.dim() == 4
    H, W = img.shape[-3:-1] if (batched or img.dim() == 3) else img.shape
    dev, dt = img.device, img.dtype
    K = K.to(dev, dt)
    dist = dist.to(dev, dt)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=dt, device=dev),
        torch.arange(W, dtype=dt, device=dev),
        indexing="ij",
    )
    nx = (xs - K[0, 2]) / K[0, 0]
    ny = (ys - K[1, 2]) / K[1, 1]
    d = distort_points(torch.stack([nx, ny], dim=-1), dist)
    sx = d[..., 0] * K[0, 0] + K[0, 2]
    sy = d[..., 1] * K[1, 1] + K[1, 2]
    coords = torch.stack([sx, sy], dim=-1)
    if not batched:
        return bilinear_sample_auto(img, coords)[0]
    V, _, _, C = img.shape
    planes = img.permute(0, 3, 1, 2).reshape(V * C, H, W)
    out, _ = sample_planes(planes, coords[None])
    return out.reshape(V, C, H, W).permute(0, 2, 3, 1)


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """cv.remap equivalent: sample img at (map_x, map_y) per target pixel."""
    out, _ = bilinear_sample_auto(img, torch.stack([map_x, map_y], dim=-1))
    return out


_SCAN_BASE = 16


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum along `dim`, added in the order XLA's
    CPU backend uses for jnp.cumsum (reduce-window rewritten as a blocked
    scan of base 16: sequential sums inside blocks of 16, the block totals
    scanned recursively, then added back).

    Why not torch.cumsum: box_filter's window sums are differences of
    integral-image entries as large as the whole image's sum, and windowed
    NCC subtracts squared means from them, so in smooth windows the NCC
    amplifies the summation order's rounding (up to 0.17 NCC on the test
    scene). Matching the reference's order keeps the port's PatchMatch on
    the reference's trajectory; the order is the same on CPU and CUDA."""
    x = x.movedim(dim, -1)
    N = x.shape[-1]
    if N <= _SCAN_BASE:
        out = x.clone()
        for k in range(1, N):
            out[..., k] += out[..., k - 1]
        return out.movedim(-1, dim)
    nb = -(-N // _SCAN_BASE)
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BASE - N))
    blocks = _prefix_sum(blocks.reshape(x.shape[:-1] + (nb, _SCAN_BASE)), -1)
    before = torch.nn.functional.pad(_prefix_sum(blocks[..., -1], -1)[..., :-1], (1, 0))
    out = (blocks + before[..., None]).reshape(x.shape[:-1] + (nb * _SCAN_BASE,))
    return out[..., :N].movedim(-1, dim)


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over a size x size window of the last two dims of (..., H, W),
    by padded cumulative sums (the CPU branch of recon3d_tpu/ops/image.py
    :326-344): zero padding, normalised by the true per-pixel overlap
    count, O(1) per pixel whatever the window."""
    H, W = img.shape[-2], img.shape[-1]
    r = size // 2
    ii = _prefix_sum(_prefix_sum(torch.nn.functional.pad(img, (1, 0, 1, 0)), -2), -1)
    dev = img.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    y0 = torch.clamp(ys - r, 0, H)[:, None]
    y1 = torch.clamp(ys + r + 1, 0, H)[:, None]
    x0 = torch.clamp(xs - r, 0, W)[None, :]
    x1 = torch.clamp(xs + r + 1, 0, W)[None, :]
    s = ii[..., y1, x1] - ii[..., y0, x1] - ii[..., y1, x0] + ii[..., y0, x0]
    cnt = ((y1 - y0) * (x1 - x0)).to(img.dtype)
    return s / cnt


# ---------------------------------------------------------------------------
# Blur, decimation and gradients of the SIFT front end
# (recon3d_tpu/ops/image.py:29-95). Every function acts on the last two
# dimensions of (..., H, W); leading dimensions are a batch.


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """Host-side 1-D Gaussian kernel of odd length 2*radius+1, float32,
    computed in float64 and normalised there."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _as_kernel(k, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(k, np.float32)).to(like.device, like.dtype)


def _conv_sep_1d(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """Cross-correlation of (..., H, W) with the 1-D kernel `k` along
    `axis` (0: rows / H, 1: columns / W): the edge is replicated by the
    kernel's radius, then the convolution is VALID."""
    k = _as_kernel(k, img)
    r = k.shape[0] // 2
    x = img.reshape((-1, 1) + img.shape[-2:])
    if axis == 0:
        x = torch.nn.functional.pad(x, (0, 0, r, r), mode="replicate")
        out = torch.nn.functional.conv2d(x, k.reshape(1, 1, -1, 1))
    else:
        x = torch.nn.functional.pad(x, (r, r, 0, 0), mode="replicate")
        out = torch.nn.functional.conv2d(x, k.reshape(1, 1, 1, -1))
    return out.reshape(img.shape)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W): rows, then columns."""
    if sigma <= 0:
        return img
    k = gaussian_kernel1d(sigma, radius)
    return _conv_sep_1d(_conv_sep_1d(img, k, 0), k, 1)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Decimate (..., H, W) by 2 (every other pixel): the pyramid's octave step."""
    return img[..., ::2, ::2]


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (gx, gy) of (..., H, W), the convention of cv.Sobel
    with ksize=3 (kernels applied as cross-correlations)."""
    kd = [-1.0, 0.0, 1.0]
    ks = [1.0, 2.0, 1.0]
    gx = _conv_sep_1d(_conv_sep_1d(img, ks, 0), kd, 1)
    gy = _conv_sep_1d(_conv_sep_1d(img, kd, 0), ks, 1)
    return gx, gy


def central_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy) of (..., H, W), edge-replicated."""
    x = img.reshape((-1, 1) + img.shape[-2:])
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate")
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx.reshape(img.shape), gy.reshape(img.shape)
