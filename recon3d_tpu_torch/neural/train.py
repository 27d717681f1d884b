"""Training of the neural front end: SuperPoint's and LightGlue's losses,
their train steps, and the optimizer.

PyTorch port of recon3d_tpu/neural/train.py. A self-supervised SuperPoint
step (detector cross-entropy against corner labels on both views of a
homography pair, and an InfoNCE loss between corresponding descriptor
cells) and LightGlue's supervised assignment loss over features of the
frozen SuperPoint. Where the JAX trainers run `lax.scan` over a round of
device-resident batches in one dispatch, the port runs one Python loop of
optimizer steps over the same device-resident round; the round is
uploaded once, as in the JAX package.

optax, written for torch as optax computes it:
- `Adam(lr)` is optax.adam(lr): torch.optim.Adam with betas (0.9, 0.999)
  and eps 1e-8; its learning rate is a number or a schedule of the step
  count, whose value at count 0 drives the first update;
- `Adam(lr, clip_norm=c)` is optax.chain(optax.clip_by_global_norm(c),
  optax.adam(lr)): the gradients become g * c / ||g|| only where the global
  norm ||g|| >= c (torch.nn.utils.clip_grad_norm_ divides by ||g|| + 1e-6
  every time, which differs);
- `warmup_cosine_decay_schedule` is optax's, a function of the count.

The JAX trainers shard the batch over a ('data', 'model') mesh; here
`mesh` must be None, and sharded training (make_sharded_train_step) is
ROADMAP.md section 1 item 12.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from recon3d_tpu_torch.neural.weights import flax_init_

Schedule = Callable[[int], float]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training over a device mesh is not ported yet (ROADMAP.md, "
            "section 1, item 12); pass mesh=None")


# -- optax in torch ---------------------------------------------------------------


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine decay to end_value at
    decay_steps (counted from 0, warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return schedule


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on a list of gradients, in place: each
    g -> (g / ||g||) * max_norm where the global norm ||g|| >= max_norm,
    unchanged below it. No host synchronisation. Returns ||g||."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    # g / 1 * 1 is g exactly; else (g / ||g||) * max_norm, in optax's order
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, torch.full_like(norm, max_norm)))
    return norm


class Adam:
    """optax.adam(learning_rate), after optax.clip_by_global_norm(clip_norm)
    when clip_norm is given. `init(params)` gives the optimizer state (a
    torch.optim.Adam), `update(opt, count)` applies the gradients held in
    the parameters' .grad at step `count`."""

    def __init__(self, learning_rate: Union[float, Schedule], clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm

    def init(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(list(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    def update(self, opt: torch.optim.Adam, count: int) -> None:
        if self.clip_norm is not None:
            grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_norm)
        lr = self.learning_rate
        for group in opt.param_groups:
            group["lr"] = float(lr(count) if callable(lr) else lr)
        opt.step()


@dataclass
class TrainState:
    """The network (its parameters), the optimizer state and the number of
    steps taken, which is the schedule's count. The train steps update it in
    place and return it, as the JAX steps return a new one."""

    module: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int = 0


def create_train_state(generator: torch.Generator, image_shape: Tuple[int, int],
                       lr: float = 1e-3, device="cuda"):
    """(model, tx, state) of a SuperPointNet drawn from `generator` (Flax's
    initialisation, weights.flax_init_) on `device`, with Adam(lr).
    image_shape is kept for the JAX signature: the network's parameters do
    not depend on it."""
    del image_shape
    model = flax_init_(SuperPointNet(), generator).to(device)
    tx = Adam(lr)
    return model, tx, TrainState(model, tx.init(model.parameters()), 0)


# -- losses -------------------------------------------------------------------------


def _detector_loss(logits: torch.Tensor, labels65: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the 65-way cell distribution (cells + dustbin)."""
    return -torch.mean(torch.sum(labels65 * F.log_softmax(logits, dim=-1), dim=-1))


def _descriptor_loss(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """InfoNCE between the same cells of two (B, Hc, Wc, D) descriptor maps
    (identity correspondence, the JAX package's sharded dry-run loss)."""
    B, Hc, Wc, D = desc_a.shape
    a = desc_a.reshape(B, Hc * Wc, D)
    b = desc_b.reshape(B, Hc * Wc, D)
    logp = F.log_softmax(torch.matmul(a, b.transpose(1, 2)) / 0.1, dim=-1)
    return -torch.mean(torch.diagonal(logp, dim1=1, dim2=2))


def _descriptor_loss_corr(desc_a: torch.Tensor, desc_b: torch.Tensor, corr_idx: torch.Tensor,
                          corr_valid: torch.Tensor) -> torch.Tensor:
    """InfoNCE with the homography's cell correspondence: corr_idx (B, N)
    the B-view cell each A-view cell maps to, corr_valid its in-bounds
    mask; the other cells of the same pair are the negatives."""
    B, Hc, Wc, D = desc_a.shape
    a = desc_a.reshape(B, Hc * Wc, D)
    b = desc_b.reshape(B, Hc * Wc, D)
    # rsqrt(sum^2 + eps), NOT x / max(||x||, eps): a ReLU stack can emit an
    # exactly-zero descriptor cell, where the norm's gradient is 0/0 = NaN.
    a = a * torch.rsqrt((a * a).sum(-1, keepdim=True) + 1e-8)
    b = b * torch.rsqrt((b * b).sum(-1, keepdim=True) + 1e-8)
    logp = F.log_softmax(torch.matmul(a, b.transpose(1, 2)) / 0.1, dim=-1)
    pos = torch.gather(logp, 2, corr_idx.long()[:, :, None])[..., 0]
    w = corr_valid.to(torch.float32)
    return -torch.sum(pos * w) / torch.clamp(torch.sum(w), min=1.0)


def _lightglue_loss(log_assign, m0, m1, gt_idx, valid0, valid1, ignore1=None):
    """LightGlue's supervision (Lindenberger et al. 2023, eq. 9) with three
    classes, for a batch of pairs: log_assign (B, N0, N1), matchability
    m0 (B, N0) and m1 (B, N1), gt_idx (B, N0) >= 0 the partner in set 1,
    -1 unmatchable, -2 ignored (no loss); ignore1 (B, N1) set-1 keypoints
    left out of the unmatchable term. Returns (loss, loss_pos, loss_un),
    each (B,)."""
    matched = (gt_idx >= 0) & valid0
    gi = gt_idx.clamp_min(0).long()
    pos = torch.gather(log_assign, 2, gi[..., None])[..., 0]
    n_pos = matched.sum(-1).clamp_min(1).to(log_assign.dtype)
    loss_pos = -torch.where(matched, pos, 0.0).sum(-1) / n_pos

    un0 = valid0 & (gt_idx == -1)
    # the set-1 keypoints someone matches: a scatter-ADD at the clipped
    # index (a scatter-set of False there would clobber a real hit at 0)
    hit1 = torch.zeros(m1.shape, dtype=torch.int32, device=m1.device).scatter_add_(
        1, gi, matched.to(torch.int32)) > 0
    un1 = valid1 & ~hit1
    if ignore1 is not None:
        un1 = un1 & ~ignore1
    eps = 1e-6

    def unmatchable(un, m):
        return (torch.where(un, torch.log(1.0 - m + eps), 0.0).sum(-1)
                / un.sum(-1).clamp_min(1).to(m.dtype))

    loss_un = (-unmatchable(un0, m0) - unmatchable(un1, m1)) * 0.5
    return loss_pos + loss_un, loss_pos, loss_un


# -- trainers -------------------------------------------------------------------------


def _step(state: TrainState, tx: Adam, loss_fn) -> torch.Tensor:
    """One optimizer step on loss_fn() -> (loss, *aux); returns the stacked
    losses, detached. The gradients stay in the parameters' .grad."""
    state.optimizer.zero_grad(set_to_none=True)
    losses = loss_fn()
    losses[0].backward()
    tx.update(state.optimizer, state.step)
    state.step += 1
    return torch.stack(losses).detach()


def _pair_loss(model, batch: Dict[str, torch.Tensor], desc_weight: float):
    logits_a, desc_a = model(batch["img_a"])
    logits_b, desc_b = model(batch["img_b"])
    det = _detector_loss(logits_a, batch["lab_a"]) + _detector_loss(logits_b, batch["lab_b"])
    dsc = _descriptor_loss_corr(desc_a, desc_b, batch["corr_idx"], batch["corr_valid"])
    return det + desc_weight * dsc, det, dsc


def make_pair_train_step(model: SuperPointNet, tx: Adam, mesh=None, desc_weight: float = 1.0):
    """The homography-pair step: detector cross-entropy on both views plus
    desc_weight x the correspondence InfoNCE. train_step(state, batch) ->
    (state, losses [loss, det, desc]); batch is make_pair_batch's dict as
    tensors on the model's device (state.module is `model`)."""
    _no_mesh(mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return state, _step(state, tx, lambda: _pair_loss(model, batch, desc_weight))

    return train_step


def _decode(cb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A compact batch (uint8 images, int8 cell labels) decoded on its
    device: images / 255, labels one-hot over 65."""
    return dict(
        img_a=cb["img_a"].to(torch.float32) / 255.0,
        img_b=cb["img_b"].to(torch.float32) / 255.0,
        lab_a=F.one_hot(cb["cells_a"].long(), 65).to(torch.float32),
        lab_b=F.one_hot(cb["cells_b"].long(), 65).to(torch.float32),
        corr_idx=cb["corr_idx"],
        corr_valid=cb["corr_valid"],
    )


def make_epoch_train_fn(model: SuperPointNet, tx: Adam, mesh=None, epochs: int = 4,
                        desc_weight: float = 1.0):
    """`epochs` passes over a round of compact batches already on the
    device: run(state, data) with data's leaves (D, B, ...) stacked
    make_pair_batch_compact batches; step i takes batch i % D. Returns
    (state, losses (D * epochs, 3)) on the device."""
    _no_mesh(mesh)

    def run(state: TrainState, data: Dict[str, torch.Tensor]):
        D = data["img_a"].shape[0]
        losses = []
        for i in range(D * epochs):
            batch = _decode({k: v[i % D] for k, v in data.items()})
            losses.append(_step(state, tx, lambda: _pair_loss(model, batch, desc_weight)))
        return state, torch.stack(losses)

    return run


def make_lightglue_train_fn(lg_model, tx: Adam, mesh=None, epochs: int = 4):
    """`epochs` passes over a round of SuperPoint feature pairs on the
    device (only LightGlue's parameters train): data's leaves (D, B, ...)
    are desc0/desc1 (D, B, K, dim), xy0n/xy1n (D, B, K, 2) normalised
    positions, valid0/valid1 (D, B, K) bool, gt_idx (D, B, K) (>= 0
    partner, -1 unmatchable, -2 ignore), ignore1 (D, B, K) bool. The pairs
    of a batch run as one batch of the network; the loss is the mean of
    the pairs'. Returns (state, losses (D * epochs, 3) [loss, pos, unmatch])."""
    _no_mesh(mesh)

    def pair_loss(cb):
        log_assign, m0, m1 = lg_model(cb["desc0"], cb["desc1"], cb["xy0n"], cb["xy1n"],
                                      cb["valid0"], cb["valid1"])
        loss, lp, lu = _lightglue_loss(log_assign, m0, m1, cb["gt_idx"], cb["valid0"],
                                       cb["valid1"], ignore1=cb["ignore1"])
        return loss.mean(), lp.mean(), lu.mean()

    def run(state: TrainState, data: Dict[str, torch.Tensor]):
        D = data["desc0"].shape[0]
        losses = []
        for i in range(D * epochs):
            cb = {k: v[i % D] for k, v in data.items()}
            losses.append(_step(state, tx, lambda: pair_loss(cb)))
        return state, torch.stack(losses)

    return run
