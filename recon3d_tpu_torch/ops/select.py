"""Selections whose ties break the same way on every device.

jax.lax.top_k, jnp.argsort, jnp.argmin and jnp.argmax all put the lower
index first among equal keys, and the order of keypoints decides every
index downstream of the SIFT front end. These helpers give that order on
the CPU and on CUDA alike, whatever the backend's own reduction does with
ties. (For jnp.argsort, torch.argsort(..., stable=True) already does.)
"""

from __future__ import annotations

from typing import Tuple

import torch


def _first_where_equal(x: torch.Tensor, extreme: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    idx = torch.where(x == extreme, pos, n).amin(dim=dim)
    return idx.clamp_(max=n - 1)


def argmin_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the minimum along `dim`; of several equal minima, the first."""
    return _first_where_equal(x, x.amin(dim=dim, keepdim=True), dim)


def argmax_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the maximum along `dim`; of several equal maxima, the first."""
    return _first_where_equal(x, x.amax(dim=dim, keepdim=True), dim)


def topk_nonneg_first(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of a non-negative float32 (..., N)
    tensor, in descending order, equal values by ascending index: the
    order of jax.lax.top_k.

    The bit pattern of a non-negative float32 grows with its value, so the
    value's bits and the reversed index pack into one int64 key without
    ties, and torch.topk of the keys has only one answer on any device.
    Returns (values (..., k), indices (..., k))."""
    n = score.shape[-1]
    if n >= 1 << 31:
        raise ValueError("topk_nonneg_first: rows of at most 2^31 - 1 entries")
    bits = score.contiguous().view(torch.int32).to(torch.int64)
    last = (1 << 31) - 1
    key = (bits << 31) | (last - torch.arange(n, device=score.device))
    idx = last - (torch.topk(key, k, dim=-1).values & last)
    return torch.gather(score, -1, idx), idx
