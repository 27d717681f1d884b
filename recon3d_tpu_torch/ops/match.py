"""Brute-force descriptor matching with ratio test + mutual cross-check.

PyTorch port of recon3d_tpu/ops/match.py: one (N, M) squared-distance
matrix from a descriptor matrix product, the two nearest columns per row
for Lowe's ratio test, and a mutual-argmin mask for the cross-check.
Leading dimensions of the descriptors are a batch of pairs (the JAX
package maps these functions over pairs with vmap). Of equal distances
the lower index wins, rows and columns alike (ops/select.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from recon3d_tpu_torch.ops.select import argmin_first


class MatchResult(NamedTuple):
    """Padded pairwise matches.

    idx1, idx2: (..., N) int64: for each keypoint in image 1, the matched keypoint
                in image 2 (or -1). `mask` marks surviving matches;
                `distance` is the L2 descriptor distance.
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    distance: torch.Tensor
    mask: torch.Tensor

    @property
    def num_matches(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)


def _sq_distances(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """||a||^2 + ||b||^2 - 2ab, clamped at 0: (..., N, D), (..., M, D) ->
    (..., N, M)."""
    n1 = (d1 * d1).sum(dim=-1)
    n2 = (d2 * d2).sum(dim=-1)
    cross = torch.matmul(d1, d2.transpose(-1, -2))
    return (n1[..., :, None] + n2[..., None, :] - 2.0 * cross).clamp_min_(0.0)


def _two_nearest(dd: torch.Tensor, big: float):
    """Per row of (..., N, M): the smallest value, its first column, and
    the smallest value of the other columns."""
    i1 = argmin_first(dd, -1)
    b1 = dd.amin(dim=-1)
    cols = torch.arange(dd.shape[-1], device=dd.device)
    b2 = torch.where(cols == i1[..., None], big, dd).amin(dim=-1)
    return b1, i1, b2


def _result(best, second, nn, back, valid1, ratio, cross_check, big):
    N = best.shape[-1]
    rows = torch.arange(N, device=best.device)
    # Lowe ratio on true (non-squared) distances: d1 < ratio * d2
    ok = (best < (ratio * ratio) * second) & (valid1 > 0) & (best < big)
    if cross_check:
        ok = ok & (torch.gather(back, -1, nn) == rows)
    return MatchResult(
        idx1=rows.expand(best.shape),
        idx2=torch.where(ok, nn, -1),
        distance=torch.sqrt(torch.where(best < big, best, 0.0)),
        mask=ok,
    )


def match_descriptors(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.75,
    cross_check: bool = True,
) -> MatchResult:
    """d1: (..., N, D), d2: (..., M, D) with validity masks (..., N) and
    (..., M). Invalid rows and columns are pushed to +inf."""
    big = math.inf
    d2sq = _sq_distances(d1, d2)
    d2sq = torch.where(valid2[..., None, :] > 0, d2sq, big)
    d2sq = torch.where(valid1[..., :, None] > 0, d2sq, big)
    best, nn, second = _two_nearest(d2sq, big)
    # mutual nearest: argmin over rows for each column
    back = argmin_first(d2sq, -2) if cross_check else None
    return _result(best, second, nn, back, valid1, ratio, cross_check, big)


def gather_matched_points(xy1: torch.Tensor, xy2: torch.Tensor, match: MatchResult):
    """Matched coordinate arrays (..., N, 2), (..., N, 2) with invalid rows
    zeroed. Keeps the padded shape: RANSAC downstream consumes the mask."""
    m = match.mask[..., None]
    idx = match.idx2.clamp_min(0)[..., None].expand(match.idx2.shape + (2,))
    x1 = torch.where(m, xy1, 0.0)
    x2 = torch.where(m, torch.gather(xy2, -2, idx), 0.0)
    return x1, x2


def match_descriptors_streaming(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.75,
    cross_check: bool = True,
    block: int = 1024,
) -> MatchResult:
    """match_descriptors without materializing the (N, M) distance matrix.

    Walks over column blocks of d2, keeping a running top-2 per row (for
    the ratio test) and a per-column row-argmin (for the cross-check). Peak
    memory is O(N * block) instead of O(N * M) per pair, which is what lets
    a whole chunk of pairs go through as one batch."""
    N = d1.shape[-2]
    M = d2.shape[-2]
    lead = d1.shape[:-2]
    dev = d1.device
    big = 1e30

    best = torch.full(lead + (N,), big, dtype=d1.dtype, device=dev)
    second = best.clone()
    nn = torch.zeros(lead + (N,), dtype=torch.int64, device=dev)
    col_args = []
    for base in range(0, M, block):
        db = d2[..., base: base + block, :]
        vb = valid2[..., base: base + block]
        dd = torch.where(vb[..., None, :] > 0, _sq_distances(d1, db), big)
        b1, i1loc, b2 = _two_nearest(dd, big)

        # merge (best, second) with (b1, b2): best and second of the union
        nsecond = torch.minimum(torch.maximum(best, b1), torch.minimum(second, b2))
        nn = torch.where(b1 < best, base + i1loc, nn)
        best = torch.minimum(best, b1)
        second = nsecond

        if cross_check:  # per-column row-argmin of this block
            col_args.append(argmin_first(
                torch.where(valid1[..., :, None] > 0, dd, big), -2))
    back = torch.cat(col_args, dim=-1) if cross_check else None
    return _result(best, second, nn.clamp(0, M - 1), back, valid1, ratio,
                   cross_check, big)
