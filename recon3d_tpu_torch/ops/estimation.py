"""High-level robust estimators built on the RANSAC harness.

PyTorch port of the two-view part of recon3d_tpu/ops/estimation.py:
`estimate_fundamental_ransac` and `estimate_homography_ransac`. Both take
padded correspondences with any leading batch of pairs, a torch.Generator
(or pre-drawn `sample_indices`) and a fixed hypothesis budget. The
essential-matrix and PnP estimators of the JAX module are not ported yet
(ROADMAP.md, section 1, item 5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from recon3d_tpu_torch.ops.epipolar import (
    fundamental_8point,
    homography_dlt,
    homography_transfer_distance,
    sampson_distance,
    sampson_distance_batch,
)
from recon3d_tpu_torch.ops import ransac as _ransac
from recon3d_tpu_torch.ops.select import argmax_first


class FundamentalResult(NamedTuple):
    F: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, 2)[idx (..., H, k)] -> (..., H, k, 2)."""
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1,))[..., None].expand(lead + (idx.shape[-2] * idx.shape[-1], 2))
    return torch.gather(x, -2, flat).reshape(idx.shape + (2,))


def estimate_fundamental_ransac(
    generator: Optional[torch.Generator],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 2.0,
    num_hypotheses: int = 1024,
    sample_indices: Optional[torch.Tensor] = None,
) -> FundamentalResult:
    """RANSAC fundamental matrix on padded correspondences.

    x1, x2: (..., N, 2) pixels, valid: (..., N). 8-point samples; the final
    model is least-squares refit on all inliers (2 rounds).
    sample_indices: pre-drawn (..., num_hypotheses, 8) samples."""

    def solver(mask):
        if mask.dim() == valid.dim():          # one weight row per pair
            return fundamental_8point(x1, x2, mask)
        return fundamental_8point(x1[..., None, :, :], x2[..., None, :, :], mask)

    def sample_solver(idx):
        # gathered 8-point samples: (8, 2) systems instead of masked (N, 9)
        ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
        return fundamental_8point(_gather_points(x1, idx), _gather_points(x2, idx), ones)

    def residual_fn(F):
        return sampson_distance(F, x1, x2)

    def batch_residual_fn(Fs):
        return sampson_distance_batch(Fs, x1, x2)

    res = _ransac.ransac_with_refit(
        generator, solver, residual_fn, valid, 8, num_hypotheses, threshold_px,
        batch_residual_fn=batch_residual_fn, sample_solver=sample_solver,
        sample_indices=sample_indices,
    )
    return FundamentalResult(F=res.model, inliers=res.inliers, num_inliers=res.num_inliers)


class HomographyResult(NamedTuple):
    H: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def estimate_homography_ransac(
    generator: Optional[torch.Generator],
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 3.0,
    num_hypotheses: int = 512,
    sample_indices: Optional[torch.Tensor] = None,
) -> HomographyResult:
    """RANSAC homography on padded correspondences (N, 2): 4-point DLT
    samples, symmetric transfer distance, one least-squares refit on the
    winner's inliers. The consumer is the two-view degeneracy gate: if a
    single H explains (almost) all of a pair's F-inliers, the pair carries
    no parallax signal (pure rotation, a single plane, or self-similar
    texture producing a false wide-baseline match)."""
    idx = sample_indices
    if idx is None:
        idx = _ransac.sample_indices(generator, valid, num_hypotheses, 4)
    ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    Hs = homography_dlt(_gather_points(x1, idx), _gather_points(x2, idx), ones)
    res = homography_transfer_distance(Hs, x1, x2)  # (Hyp, N)
    valid_b = valid > 0
    inl = (res < threshold_px) & valid_b
    counts = inl.sum(dim=-1)
    r2 = torch.square(res).clamp_max(threshold_px * threshold_px)
    score = torch.where(valid_b, r2, 0.0).sum(dim=-1)
    norm_score = score / (score.amax() + 1e-12)
    best = argmax_first(counts.to(torch.float32) - 0.5 * norm_score, -1)
    # one LS refit on the winner's inliers
    w = inl[best].to(x1.dtype)
    H = torch.where(w.sum() >= 4, homography_dlt(x1, x2, w), Hs[best])
    r = homography_transfer_distance(H, x1, x2)
    inliers = (r < threshold_px) & valid_b
    return HomographyResult(H=H, inliers=inliers, num_inliers=inliers.sum())
