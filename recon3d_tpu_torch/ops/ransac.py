"""Batched-hypothesis RANSAC harness.

PyTorch port of recon3d_tpu/ops/ransac.py: all H minimal samples are drawn
at once, the minimal solver runs over the hypothesis axis, residuals are
one (H, N) batched evaluation, and the winner is an argmax over masked
inlier counts. No data-dependent control flow: a fixed hypothesis budget
replaces adaptive termination.

Where the JAX package maps the solver over hypotheses (and the whole
estimator over pairs) with vmap, the callables here are batched
themselves: `valid` is (..., N) with any leading batch (of pairs), samples
are (..., H, k), and

    sample_solver(idx (..., H, k))      -> models (..., H, *model_shape)
    solver(weights (..., N) or (..., H, N)) -> models with the same lead
    residual_fn(models (..., *model_shape)) -> (..., N)
    batch_residual_fn(models (..., H, *model_shape)) -> (..., H, N)

A model is one tensor; its dimensions behind the hypothesis axis are its
own (3, 3 for F and H).
Random draws come from a torch.Generator on the target device, or are
handed in as `sample_indices` (tests pass the JAX package's draws).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from recon3d_tpu_torch.ops.select import argmax_first


class RansacResult(NamedTuple):
    model: torch.Tensor        # best model parameters (solver-defined shape)
    inliers: torch.Tensor      # (..., N) bool inlier mask of the best model
    num_inliers: torch.Tensor  # (...) int
    best_score: torch.Tensor   # (...) float (MSAC score of the winner)


def sample_indices(
    generator: torch.Generator,
    valid: torch.Tensor,
    num_hypotheses: int,
    sample_size: int,
) -> torch.Tensor:
    """Draw `num_hypotheses` minimal samples (without replacement) from the
    valid entries of a padded (..., N) array; returns indices (..., H, k).

    The k largest of one uniform draw per slot, invalid slots pushed below
    every valid one: each k-subset of the valid slots is equally likely.
    When fewer than k points are valid, the surplus picks land on arbitrary
    (padded) slots: the hypothesis is garbage and simply loses the vote, so
    callers must not rely on every returned index being valid."""
    n = valid.shape[-1]
    shape = valid.shape[:-1] + (num_hypotheses, n)
    g = torch.rand(shape, generator=generator, device=valid.device)
    return indices_from_uniform(g, valid, sample_size)


def indices_from_uniform(g: torch.Tensor, valid: torch.Tensor, sample_size: int) -> torch.Tensor:
    """sample_indices given its uniform draw g (..., H, N): a shard of a
    batch takes its rows of the whole batch's draw and gets the samples the
    whole batch gives those rows."""
    g = torch.where(valid[..., None, :] > 0, g, -1.0)
    return torch.topk(g, sample_size, dim=-1).indices


_draw_indices = sample_indices  # `sample_indices` is also a parameter name below


def sample_masks(
    generator: torch.Generator,
    valid: torch.Tensor,
    num_hypotheses: int,
    sample_size: int,
    indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mask form of sample_indices: float (..., H, N) with ones at the
    sample. Rows with fewer than sample_size valid points keep only the
    valid ones."""
    idx = indices if indices is not None else sample_indices(
        generator, valid, num_hypotheses, sample_size)
    masks = torch.zeros(idx.shape[:-1] + (valid.shape[-1],), dtype=torch.float32,
                        device=valid.device)
    masks.scatter_(-1, idx, 1.0)
    return masks * (valid[..., None, :] > 0)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The sampled rows of padded data: x (..., N, D)[idx (..., H, k)] ->
    (..., H, k, D)."""
    lead = idx.shape[:-2]
    d = x.shape[-1]
    flat = idx.reshape(lead + (-1,))[..., None].expand(lead + (idx.shape[-2] * idx.shape[-1], d))
    return torch.gather(x, -2, flat).reshape(idx.shape + (d,))


def select_best(x: torch.Tensor, best: torch.Tensor, tail: int) -> torch.Tensor:
    """x (..., H, *tail dims)[best (...)] -> (..., *tail dims)."""
    idx = best.reshape(best.shape + (1,) * (tail + 1))
    idx = idx.expand(best.shape + (1,) + x.shape[x.dim() - tail:])
    return torch.gather(x, best.dim(), idx).squeeze(best.dim())


def ransac(
    generator: Optional[torch.Generator],
    solver: Callable[[torch.Tensor], torch.Tensor],
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    valid: torch.Tensor,
    sample_size: int,
    num_hypotheses: int,
    threshold: float,
    batch_residual_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    sample_solver: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    sample_indices: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Generic batched RANSAC; see the module docstring for the callables.

    valid: (..., N) validity of padded data points. sample_indices:
    pre-drawn (..., H, sample_size) samples in place of the generator's.
    Scoring is MSAC (truncated quadratic) as the tie-break of the inlier
    count."""
    idx = sample_indices
    if idx is None:
        idx = _draw_indices(generator, valid, num_hypotheses, sample_size)
    if sample_solver is not None:
        # minimal solver on the gathered k-point sample, not on (H, N)
        # design matrices of which only k rows are non-zero
        models = sample_solver(idx)
    else:
        models = solver(sample_masks(None, valid, num_hypotheses, sample_size, indices=idx))
    if batch_residual_fn is not None:
        residuals = batch_residual_fn(models)  # (..., H, N)
    else:
        residuals = residual_fn(models)

    valid_b = (valid > 0)[..., None, :]
    inl = (residuals < threshold) & valid_b
    # MSAC score: sum of min(r^2, thr^2) over valid points (lower is better).
    r2 = torch.square(residuals).clamp_max(threshold * threshold)
    score = torch.where(valid_b, r2, 0.0).sum(dim=-1)
    counts = inl.sum(dim=-1)
    # Primary: maximize inliers; tie-break: minimize MSAC score.
    norm_score = score / (score.amax(dim=-1, keepdim=True) + 1e-12)
    best = argmax_first(counts.to(torch.float32) - 0.5 * norm_score, -1)

    return RansacResult(
        model=select_best(models, best, models.dim() - valid.dim()),
        inliers=select_best(inl, best, 1),
        num_inliers=select_best(counts, best, 0),
        best_score=select_best(score, best, 0),
    )


def ransac_with_refit(
    generator: Optional[torch.Generator],
    solver: Callable[[torch.Tensor], torch.Tensor],
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    valid: torch.Tensor,
    sample_size: int,
    num_hypotheses: int,
    threshold: float,
    refit_rounds: int = 2,
    batch_residual_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    sample_solver: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    sample_indices: Optional[torch.Tensor] = None,
) -> RansacResult:
    """RANSAC + iterative least-squares refit on the inlier set: after the
    vote, the solver is re-run with the full inlier mask as weights, then
    the inliers are re-evaluated, `refit_rounds` times."""
    res = ransac(generator, solver, residual_fn, valid, sample_size,
                 num_hypotheses, threshold, batch_residual_fn=batch_residual_fn,
                 sample_solver=sample_solver, sample_indices=sample_indices)
    model, inliers = res.model, res.inliers
    valid_b = valid > 0

    for _ in range(refit_rounds):
        w = inliers.to(torch.float32) * valid_b
        # Guard: keep the previous model if the inlier set collapsed.
        enough = w.sum(dim=-1) >= sample_size
        enough = enough.reshape(enough.shape + (1,) * (model.dim() - enough.dim()))
        model = torch.where(enough, solver(w), model)
        inliers = (residual_fn(model) < threshold) & valid_b

    return RansacResult(
        model=model,
        inliers=inliers,
        num_inliers=inliers.sum(dim=-1),
        best_score=res.best_score,
    )
