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

With a mesh (parallel/mesh.py) the trainers split each batch over its
'data' axis: every rank holds a replica of the network and the optimizer,
computes its share of the global batch's loss (the loss's terms scaled so
that the shares add up to the one-device loss), and the gradients are
summed with one all_reduce before the same Adam step on every rank.
make_sharded_train_step also splits the output channels of SuperPoint's
wide heads over 'model' (recon3d_tpu/neural/train.py:307-354).
"""

from __future__ import annotations

import copy
import itertools
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from recon3d_tpu_torch.neural.weights import flax_init_

Schedule = Callable[[int], float]


# -- optax in torch ---------------------------------------------------------------


@dataclass(frozen=True)
class warmup_cosine_decay_schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine decay to end_value at
    decay_steps (counted from 0, warmup included). A value, so that a
    mesh's ranks receive it with their optimizer."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0

    def __post_init__(self):
        if self.decay_steps - self.warmup_steps <= 0:
            raise ValueError(f"decay_steps {self.decay_steps} must exceed warmup_steps "
                             f"{self.warmup_steps}")

    def __call__(self, count: int) -> float:
        peak, warmup = self.peak_value, self.warmup_steps
        alpha = 0.0 if peak == 0.0 else self.end_value / peak
        cosine_steps = self.decay_steps - warmup
        if count < warmup:
            frac = 1.0 - min(max(count, 0), warmup) / warmup
            return (self.init_value - peak) * frac + peak
        t = min(count - warmup, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak * ((1.0 - alpha) * decay + alpha)


def clip_by_global_norm_(grads, max_norm: float, norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm on a list of gradients, in place: each
    g -> (g / ||g||) * max_norm where the global norm ||g|| >= max_norm,
    unchanged below it. No host synchronisation. Returns ||g||. `norm`
    gives ||g|| where the gradients are slices of larger ones."""
    if norm is None:
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

    def update(self, opt: torch.optim.Adam, count: int,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """grad_norm: the global norm of the gradients when they are slices
        of the network's (model-sharded parameters)."""
        if self.clip_norm is not None:
            grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_norm, grad_norm)
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
    # with a mesh: (train function, step) at which the ranks' replicas
    # last matched this state
    mesh_sync: Optional[Tuple[str, int]] = None


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
                          corr_valid: torch.Tensor, n_valid=None) -> torch.Tensor:
    """InfoNCE with the homography's cell correspondence: corr_idx (B, N)
    the B-view cell each A-view cell maps to, corr_valid its in-bounds
    mask; the other cells of the same pair are the negatives. n_valid:
    the valid cells of the whole batch when this is a shard of it (the
    shards' losses then add up to the batch's)."""
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
    total = torch.sum(w) if n_valid is None else n_valid
    return -torch.sum(pos * w) / torch.clamp(total, min=1.0)


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


def _pair_loss(model, batch: Dict[str, torch.Tensor], desc_weight: float,
               frac: float = 1.0, n_valid=None):
    """[loss, det, desc] of a pair batch; a shard of a batch passes its
    fraction of the batch's rows and the batch's valid cells, and its
    terms add up over the shards to the batch's."""
    logits_a, desc_a = model(batch["img_a"])
    logits_b, desc_b = model(batch["img_b"])
    det = _detector_loss(logits_a, batch["lab_a"]) + _detector_loss(logits_b, batch["lab_b"])
    if frac != 1.0:
        det = det * frac
    dsc = _descriptor_loss_corr(desc_a, desc_b, batch["corr_idx"], batch["corr_valid"],
                                n_valid)
    return det + desc_weight * dsc, det, dsc


def make_pair_train_step(model: SuperPointNet, tx: Adam, mesh=None, desc_weight: float = 1.0):
    """The homography-pair step: detector cross-entropy on both views plus
    desc_weight x the correspondence InfoNCE. train_step(state, batch) ->
    (state, losses [loss, det, desc]); batch is make_pair_batch's dict as
    tensors on the model's device (state.module is `model`). With a mesh
    the batch rows split over its 'data' axis (module docstring)."""
    key = _train_key("pair")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if mesh is not None:
            return state, _dp_call(mesh, "pair", key, state, tx, batch, 0,
                                   dict(desc_weight=desc_weight))[0]
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
    (state, losses (D * epochs, 3)) on the device. With a mesh each
    batch's B rows split over its 'data' axis and the round runs as one
    call on every rank."""
    key = _train_key("epoch")

    def run(state: TrainState, data: Dict[str, torch.Tensor]):
        if mesh is not None:
            return state, _dp_call(mesh, "epoch", key, state, tx, data, 1,
                                   dict(desc_weight=desc_weight, epochs=epochs))
        D = data["img_a"].shape[0]
        losses = []
        for i in range(D * epochs):
            batch = _decode({k: v[i % D] for k, v in data.items()})
            losses.append(_step(state, tx, lambda: _pair_loss(model, batch, desc_weight)))
        return state, torch.stack(losses)

    return run


def _lightglue_pair_loss(lg_model, cb, n_pairs: Optional[int] = None):
    """Mean over the batch's pairs of [loss, pos, unmatch]; n_pairs: the
    whole batch's pairs when cb is a shard of it (sums / n_pairs)."""
    log_assign, m0, m1 = lg_model(cb["desc0"], cb["desc1"], cb["xy0n"], cb["xy1n"],
                                  cb["valid0"], cb["valid1"])
    loss, lp, lu = _lightglue_loss(log_assign, m0, m1, cb["gt_idx"], cb["valid0"],
                                   cb["valid1"], ignore1=cb["ignore1"])
    if n_pairs is None:
        return loss.mean(), lp.mean(), lu.mean()
    return loss.sum() / n_pairs, lp.sum() / n_pairs, lu.sum() / n_pairs


def make_lightglue_train_fn(lg_model, tx: Adam, mesh=None, epochs: int = 4):
    """`epochs` passes over a round of SuperPoint feature pairs on the
    device (only LightGlue's parameters train): data's leaves (D, B, ...)
    are desc0/desc1 (D, B, K, dim), xy0n/xy1n (D, B, K, 2) normalised
    positions, valid0/valid1 (D, B, K) bool, gt_idx (D, B, K) (>= 0
    partner, -1 unmatchable, -2 ignore), ignore1 (D, B, K) bool. The pairs
    of a batch run as one batch of the network; the loss is the mean of
    the pairs'. Returns (state, losses (D * epochs, 3) [loss, pos, unmatch]).
    With a mesh the B pairs of a batch split over its 'data' axis."""
    key = _train_key("lightglue")

    def run(state: TrainState, data: Dict[str, torch.Tensor]):
        if mesh is not None:
            return state, _dp_call(mesh, "lightglue", key, state, tx, data, 1,
                                   dict(epochs=epochs))
        D = data["desc0"].shape[0]
        losses = []
        for i in range(D * epochs):
            cb = {k: v[i % D] for k, v in data.items()}
            losses.append(_step(state, tx, lambda: _lightglue_pair_loss(lg_model, cb)))
        return state, torch.stack(losses)

    return run


# -- data-parallel training over a mesh ---------------------------------------------

_KEYS = itertools.count()


def _train_key(kind: str) -> str:
    """A name for a train function's replicas on the mesh's ranks."""
    return f"train/{kind}/{os.getpid()}/{next(_KEYS)}"


def _dp_call(mesh, kind: str, key: str, state: TrainState, tx: Adam,
             data: Dict[str, torch.Tensor], batch_axis: int, extra: dict) -> torch.Tensor:
    """Rank 0's side of a data-parallel train function: every rank gets its
    rows of data along batch_axis (and, when its replica may be stale, a
    copy of the network, the optimizer state and the step count). Returns
    the steps' losses (n_steps, 3), summed over the ranks' shares."""
    from recon3d_tpu_torch.parallel.mesh import data_rows, to_host

    B = next(iter(data.values())).shape[batch_axis]
    init = None
    if state.mesh_sync != (key, state.step):
        init = dict(module=copy.deepcopy(state.module).cpu(), step=state.step, tx=tx,
                    optimizer=to_host(state.optimizer.state_dict()))
    payloads = []
    for r, (lo, hi) in enumerate(data_rows(mesh, B)):
        rows = {k: v.narrow(batch_axis, lo, hi - lo) for k, v in data.items()}
        payloads.append(dict(kind=kind, key=key, B=B, extra=extra, data=rows,
                             init=None if r == 0 else init))
    payloads[0].update(state=state, tx=tx)
    losses = mesh.call(_dp_train, payloads)[0]
    state.mesh_sync = (key, state.step)
    return losses


def _replica(mesh, p: dict) -> Tuple[TrainState, Adam]:
    """This rank's (state, tx): rank 0's own, a worker's cached replica
    (made anew from p['init'] when rank 0 sends one)."""
    if mesh.rank == 0:
        return p["state"], p["tx"]
    if p["init"] is not None:
        init = p["init"]
        module = init["module"].to(mesh.device)
        tx = init["tx"]
        opt = tx.init(module.parameters())
        opt.load_state_dict(init["optimizer"])
        mesh.cache[p["key"]] = (TrainState(module, opt, init["step"]), tx)
    return mesh.cache[p["key"]]


def _dp_step(mesh, state: TrainState, tx: Adam, loss_fn, grad_norm_fn=None) -> torch.Tensor:
    """One optimizer step of a shard: this rank's loss share (loss_fn()
    -> (loss, *aux), or None for an empty shard), its gradients summed
    over the mesh's 'data' axis in one all_reduce, then the step. A
    parameter keeps no gradient when no rank gave it one, as on one
    device. Returns the shares, detached."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    losses = loss_fn()
    if losses is not None:
        losses[0].backward()
    params = [q for g in opt.param_groups for q in g["params"]]
    dev = params[0].device
    flat = torch.cat([(q.grad if q.grad is not None else torch.zeros_like(q)).reshape(-1)
                      for q in params] +
                     [torch.tensor([float(q.grad is not None) for q in params], device=dev)])
    mesh.all_reduce_(flat)
    off = 0
    for q in params:
        q.grad = flat[off: off + q.numel()].view_as(q).clone()
        off += q.numel()
    for q, has in zip(params, flat[off:].tolist()):
        if not has:
            q.grad = None
    tx.update(opt, state.step, grad_norm_fn() if grad_norm_fn else None)
    state.step += 1
    if losses is None:
        return torch.zeros(3, device=dev)
    return torch.stack(losses).detach()


def _dp_train(mesh, p: dict) -> Optional[torch.Tensor]:
    """A rank's part of a data-parallel train function (see _dp_call)."""
    state, tx = _replica(mesh, p)
    module = state.module
    dev = mesh.device
    data = {k: torch.as_tensor(v).to(dev) for k, v in p["data"].items()}
    kind, B, extra = p["kind"], p["B"], p["extra"]
    if kind == "pair":
        batches = [data]
    else:
        D = next(iter(data.values())).shape[0]
        batches = [{k: v[i % D] for k, v in data.items()} for i in range(D * extra["epochs"])]
    losses = []
    for cb in batches:
        if kind == "lightglue":
            b = cb["desc0"].shape[0]
            fn = (lambda cb=cb: _lightglue_pair_loss(module, cb, B)) if b else (lambda: None)
        else:
            batch = cb if kind == "pair" else _decode(cb)
            n_valid = mesh.all_reduce_(batch["corr_valid"].to(torch.float32).sum().reshape(1))[0]
            b = batch["img_a"].shape[0]
            fn = ((lambda batch=batch, n_valid=n_valid: _pair_loss(
                module, batch, extra["desc_weight"], b / B, n_valid)) if b else (lambda: None))
        losses.append(_dp_step(mesh, state, tx, fn))
    out = mesh.all_reduce_(torch.stack(losses))
    return out if mesh.rank == 0 else None


# -- the 'model' axis: SuperPoint's wide heads sharded by output channel -----------

_WIDE = ("convPa", "convDa", "convDb")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the 'model' group (each
    model rank's head slices see only their part of the input's uses)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce_(g, axis="model")
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The model group's channel slices of an NCHW tensor, concatenated.
    Backward takes this rank's slice of the gradient: summed over the
    group first when the consumers are sharded too (`partial`), as it is
    when they run replicated (every rank holds the same gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, partial: bool):
        ctx.mesh, ctx.partial, ctx.c = mesh, partial, x.shape[1]
        return mesh.all_gather(x, dim=1, axis="model")

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = g.contiguous().clone()
            ctx.mesh.all_reduce_(g, axis="model")
        m = ctx.mesh.model_index
        return g[:, m * ctx.c:(m + 1) * ctx.c].contiguous(), None, None


class _ModelShardedSuperPoint(nn.Module):
    """SuperPointNet with convPa, convDa and convDb holding this rank's
    slice of their output channels (the JAX kernels' last axis, the torch
    weights' first). forward gathers each head over 'model' before the
    layer that needs all of its channels, and the descriptor before its L2
    normalisation, which spans every channel."""

    def __init__(self, descriptor_dim: int, mp: int):
        super().__init__()
        from recon3d_tpu_torch.neural.superpoint import _CONVS

        for name, cin, cout, k in _CONVS:
            self.add_module(name, nn.Conv2d(cin, cout // mp if name in _WIDE else cout, k,
                                            padding=k // 2))
        self.convDb = nn.Conv2d(256, descriptor_dim // mp, 1)

    def forward(self, x, mesh):
        x = x.permute(0, 3, 1, 2)
        for block in ("1", "2", "3"):
            x = F.relu(getattr(self, f"conv{block}a")(x))
            x = F.relu(getattr(self, f"conv{block}b")(x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4a(x))
        x = _CopyToModel.apply(F.relu(self.conv4b(x)), mesh)
        pa = _GatherChannels.apply(F.relu(self.convPa(x)), mesh, False)
        logits = self.convPb(pa)
        da = _GatherChannels.apply(F.relu(self.convDa(x)), mesh, True)
        desc = _GatherChannels.apply(self.convDb(da), mesh, False)
        desc = desc * torch.rsqrt((desc * desc).sum(dim=1, keepdim=True) + 1e-8)
        return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def _head_slice(name: str, v: torch.Tensor, m: int, mp: int) -> torch.Tensor:
    if name.split(".")[0] in _WIDE:
        n = v.shape[0] // mp
        return v[m * n:(m + 1) * n].clone()
    return v


def _mp_init(mesh, p: dict) -> Optional[TrainState]:
    """Build this rank's sharded network and optimizer from the full
    state dict (shard_params)."""
    mp, m = mesh.shape["model"], mesh.model_index
    sd = p["state_dict"]
    net = _ModelShardedSuperPoint(sd["convDb.weight"].shape[0], mp)
    net.load_state_dict({k: _head_slice(k, v, m, mp) for k, v in sd.items()})
    net = net.to(mesh.device)
    tx = p["tx"]
    mesh.cache[p["key"]] = (TrainState(net, tx.init(net.parameters()), 0), tx)
    return None if mesh.rank else mesh.cache[p["key"]][0]


def _mp_step(mesh, p: dict):
    """One step of make_sharded_train_step on this rank: its rows of the
    batch, its head slices."""
    state, tx = mesh.cache[p["key"]]
    dev = mesh.device
    images = torch.as_tensor(p["images"]).to(dev)
    labels = torch.as_tensor(p["labels65"]).to(dev)
    b, B = images.shape[0], p["B"]
    net = state.module

    def loss_fn():
        logits, desc = net(images, mesh)
        return ((_detector_loss(logits, labels) + 0.1 * _descriptor_loss(desc, desc)) * (b / B),)

    def grad_norm():
        wide = [q.grad for n, q in net.named_parameters()
                if n.split(".")[0] in _WIDE and q.grad is not None]
        rest = [q.grad for n, q in net.named_parameters()
                if n.split(".")[0] not in _WIDE and q.grad is not None]
        sq_wide = torch.stack([g.square().sum() for g in wide]).sum().reshape(1)
        mesh.all_reduce_(sq_wide, axis="model")
        return torch.sqrt(torch.stack([g.square().sum() for g in rest]).sum() + sq_wide[0])

    if b == 0:
        raise ValueError("make_sharded_train_step: every data index needs batch rows")
    loss = _dp_step(mesh, state, tx, loss_fn,
                    grad_norm if tx.clip_norm is not None else None)[0].reshape(1)
    mesh.all_reduce_(loss)
    return loss[0] if mesh.rank == 0 else None


def _mp_gather(mesh, p: dict):
    """The full state dict: this rank's head slices gathered over 'model'."""
    net = mesh.cache[p["key"]][0].module
    out = {}
    for k, v in net.state_dict().items():
        if k.split(".")[0] in _WIDE:
            v = mesh.all_gather(v, dim=0, axis="model")
        out[k] = v.cpu()
    return out if mesh.rank == 0 else None


def make_sharded_train_step(model: SuperPointNet, tx: Adam, mesh):
    """SuperPoint's train step over a ('data', 'model') mesh
    (recon3d_tpu/neural/train.py:307-354): the batch rows split over
    'data', the output channels of convPa, convDa and convDb over 'model'
    (every other parameter replicated), loss = detector cross-entropy +
    0.1 x the identity InfoNCE.

    Returns (train_step, shard_params). shard_params(state_dict) takes the
    full network's state dict (for the JAX parameters,
    convert.flax_to_state_dict) and returns the TrainState of rank 0's
    shard; train_step(state, images (B, H, W, 1), labels65 (B, Hc, Wc, 65))
    -> (state, loss). Replicated parameters and head slices alike have
    their gradients summed over 'data'; the heads' gathers carry the
    gradients across 'model'. train_step.full_state_dict(state) gathers
    the network's parameters back."""
    key = _train_key("sharded")
    descriptor_dim = model.convDb.out_channels
    mp = mesh.shape["model"]
    if 256 % mp or descriptor_dim % mp:
        raise ValueError(f"model axis {mp} must divide the heads' channels")

    def shard_params(state_dict) -> TrainState:
        sd = {k: v.detach().cpu() for k, v in state_dict.items()}
        return mesh.call(_mp_init, [dict(key=key, state_dict=sd, tx=tx)] * mesh.world)[0]

    def train_step(state: TrainState, images: torch.Tensor, labels65: torch.Tensor):
        from recon3d_tpu_torch.parallel.mesh import data_rows

        B = images.shape[0]
        payloads = [dict(key=key, B=B, images=images[lo:hi], labels65=labels65[lo:hi])
                    for lo, hi in data_rows(mesh, B)]
        loss = mesh.call(_mp_step, payloads)[0]
        return state, loss

    def full_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
        return mesh.call(_mp_gather, [dict(key=key)] * mesh.world)[0]

    train_step.full_state_dict = full_state_dict
    return train_step, shard_params
