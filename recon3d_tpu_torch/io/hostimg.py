"""Host-side (numpy) image helpers for transfer-minimal device choreography.

PyTorch port: a verbatim copy of recon3d_tpu/io/hostimg.py (numpy only).

Over a high-latency, low-bandwidth host<->device link the bytes shipped to
the chip dominate wall-clock for the image-prep stages (loading, dense-stage
downscaling). Gray conversion and downscale cost microseconds per frame on
the host CPU but shipping full-resolution float32 RGB costs seconds per
frame over the link — so these preprocessing steps run here, in numpy, and
only the small working-scale tensors ever reach the device.

Semantics match the device kernels they mirror:
  rgb_to_gray_np  == ops.image.rgb_to_gray  (ITU-R BT.601 luma)
  resize_batch_np == ops.image.resize       (jax.image.resize 'linear':
                                             half-pixel-center bilinear)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)


def rgb_to_gray_np(img: np.ndarray) -> np.ndarray:
    """(..., 3) RGB -> (...) luma, float32 (cv.COLOR_BGR2GRAY weights on
    RGB order, matching ops.image.rgb_to_gray)."""
    return np.asarray(img, np.float32) @ _GRAY_W


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) triangle-kernel resampling weights, half-pixel centers,
    anti-aliased on downscale — the same scheme jax.image.resize('linear',
    antialias=True) uses, so host and device resizes agree numerically."""
    scale = n_out / n_in
    s = max(1.0, 1.0 / scale)  # kernel is stretched by 1/scale on downscale
    x = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5  # src coords
    j = np.arange(n_in, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) / s)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def resize_batch_np(imgs: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a batch: (V, H, W) or (V, H, W, C) -> (V, h, w[, C]).

    Numerically matches jax.image.resize(method='linear') (anti-aliased
    triangle kernel, half-pixel centers) to float32 rounding.
    """
    imgs = np.asarray(imgs, np.float32)
    has_c = imgs.ndim == 4
    H, W = imgs.shape[1], imgs.shape[2]
    h, w = out_hw
    Wy = _resize_weights(H, h)  # (h, H)
    Wx = _resize_weights(W, w)  # (w, W)
    if not has_c:
        imgs = imgs[..., None]
    # Two BLAS tensordots instead of one einsum: einsum's path inserts
    # non-contiguous reshape copies that cost more than the GEMMs
    # (measured 3.5 s vs 0.33 s for 50 frames of 480x640x3 on this host).
    t = np.tensordot(imgs, Wx.T, axes=([2], [0]))   # (V, H, C, w)
    o = np.tensordot(t, Wy.T, axes=([1], [0]))      # (V, C, w, h)
    out = np.ascontiguousarray(o.transpose(0, 3, 2, 1))
    return (out if has_c else out[..., 0]).astype(np.float32)
