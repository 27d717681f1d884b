"""CLAHE: contrast-limited adaptive histogram equalization.

PyTorch port of recon3d_tpu/ops/clahe.py: per-tile 256-bin histograms,
clip and uniform redistribution, CDF lookup tables, and a bilinear blend
of the four neighbouring tile mappings per pixel. The histogram is a
scatter-add of ones (the counts are integers, so it is exact and equals
the JAX package's one-hot sum); leading dimensions are a batch.
"""

from __future__ import annotations

import torch

from recon3d_tpu_torch.ops.image import _prefix_sum

_BINS = 256


def clahe(img: torch.Tensor, clip_limit: float = 2.0, grid: int = 8) -> torch.Tensor:
    """img: (..., H, W) float32 in [0, 1]; returns the equalized image in
    [0, 1]. H and W must be divisible by `grid`."""
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    x = img.reshape((-1, H, W))
    B = x.shape[0]
    dev = img.device
    th, tw = H // grid, W // grid
    n_px = th * tw
    T = grid * grid

    q = (x * (_BINS - 1)).to(torch.int64).clamp_(0, _BINS - 1)   # truncates
    tiles = q.reshape(B, grid, th, grid, tw).permute(0, 1, 3, 2, 4).reshape(B, T, n_px)
    hist = torch.zeros((B, T, _BINS), dtype=torch.float32, device=dev)
    hist.scatter_add_(2, tiles, torch.ones_like(tiles, dtype=torch.float32))

    # Clip and redistribute the excess uniformly (cv.CLAHE semantics).
    limit = max(clip_limit * n_px / _BINS, 1.0)
    excess = (hist - limit).clamp_min(0.0).sum(dim=2, keepdim=True)
    hist = hist.clamp_max(limit) + excess / _BINS

    # The blocked scan adds in the reference's order (ops/image._prefix_sum).
    cdf = _prefix_sum(hist, 2)
    cdf_min = cdf[..., :1]
    denom = (cdf[..., -1:] - cdf_min).clamp_min(1.0)
    lut = ((cdf - cdf_min) / denom).reshape(B, grid, grid, _BINS)

    # Bilinear blend of the 4 surrounding tile LUTs per pixel.
    if grid > 1:
        gy = (torch.arange(H, dtype=torch.float32, device=dev) / th - 0.5).clamp(0.0, grid - 1.0)
        gx = (torch.arange(W, dtype=torch.float32, device=dev) / tw - 0.5).clamp(0.0, grid - 1.0)
        y0 = torch.floor(gy).to(torch.int64).clamp_(0, grid - 2)
        x0 = torch.floor(gx).to(torch.int64).clamp_(0, grid - 2)
        fy = gy - y0
        fx = gx - x0
    else:
        y0 = torch.zeros(H, dtype=torch.int64, device=dev)
        x0 = torch.zeros(W, dtype=torch.int64, device=dev)
        fy = torch.zeros(H, dtype=torch.float32, device=dev)
        fx = torch.zeros(W, dtype=torch.float32, device=dev)
    y1 = (y0 + 1).clamp_max(grid - 1)
    x1 = (x0 + 1).clamp_max(grid - 1)

    b = torch.arange(B, device=dev)[:, None, None]
    Y0, Y1 = y0[None, :, None], y1[None, :, None]
    X0, X1 = x0[None, None, :], x1[None, None, :]
    FY, FX = fy[None, :, None], fx[None, None, :]
    out = (
        lut[b, Y0, X0, q] * (1 - FY) * (1 - FX)
        + lut[b, Y0, X1, q] * (1 - FY) * FX
        + lut[b, Y1, X0, q] * FY * (1 - FX)
        + lut[b, Y1, X1, q] * FY * FX
    )
    return out.reshape(lead + (H, W))
