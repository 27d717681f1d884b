"""One train step of SuperPoint and of LightGlue from the same parameters
and batch on two devices, for tests/test_torch_train_cuda.py and
chip_smoke.py (torch and numpy only: no jax).

Tolerances, card against CPU (TF32 off): the losses within LOSS_RTOL and
each gradient tensor within GRAD_TOL by grad_errors. cuDNN's and the CPU's
convolutions, and cuBLAS's and the CPU's products, sum in other orders,
and a few ReLU inputs near zero can flip; tests/test_torch_train.py holds
the port to the JAX package's gradients at the same GRAD_TOL.
"""

import numpy as np
import torch

from recon3d_tpu_torch.neural import synthetic
from recon3d_tpu_torch.neural.lightglue import LightGlueNet
from recon3d_tpu_torch.neural.superpoint import SuperPointNet
from recon3d_tpu_torch.neural.train import (
    Adam,
    TrainState,
    make_lightglue_train_fn,
    make_pair_train_step,
    warmup_cosine_decay_schedule,
)
from recon3d_tpu_torch.neural.weights import flax_init_

LOSS_RTOL = 1e-4
GRAD_TOL = 2e-3


def grad_errors(got: dict, ref: dict) -> dict:
    """Relative L2 error of each gradient tensor, against at least 1e-4 of
    the global norm: a gradient that is zero in exact arithmetic (the key
    bias of cross-attention, which shifts a softmax row by a constant) is
    rounding noise on both sides."""
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    floor = 1e-4 * np.sqrt(sum(np.sum(r * r) for r in ref.values()))
    return {k: float(np.linalg.norm(np.asarray(got[k], np.float64) - r)
                     / max(np.linalg.norm(r), floor)) for k, r in ref.items()}


def lightglue_batch(rng, D: int, B: int, K: int, dim: int) -> dict:
    """D batches of B pairs of K random unit descriptors and positions,
    with validity masks, three-class ground truth (60% matched through a
    permutation, 20% unmatchable, 20% ignored) and set-1 near misses."""
    desc = rng.normal(size=(2, D, B, K, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    gt = np.full((D, B, K), -1, np.int32)
    for d in range(D):
        for b in range(B):
            cls = rng.random(K)
            gt[d, b] = np.where(cls < 0.6, rng.permutation(K), np.where(cls < 0.8, -1, -2))
    return dict(desc0=desc[0], desc1=desc[1],
                xy0n=rng.uniform(-1, 1, (D, B, K, 2)).astype(np.float32),
                xy1n=rng.uniform(-1, 1, (D, B, K, 2)).astype(np.float32),
                valid0=rng.random((D, B, K)) > 0.1, valid1=rng.random((D, B, K)) > 0.1,
                gt_idx=gt, ignore1=rng.random((D, B, K)) > 0.8)


def _grads(net) -> dict:
    return {n: p.grad.detach().cpu().numpy() for n, p in net.named_parameters()}


def superpoint_step(device, seed: int = 0, batch: int = 2, hw=(128, 128)):
    """make_pair_train_step once, Adam 1e-3, on `batch` homography pairs of
    make_pair_batch from Flax's initialisation drawn with `seed`: (losses
    [loss, det, desc], gradients by parameter name)."""
    net = flax_init_(SuperPointNet(), torch.Generator().manual_seed(seed)).to(device)
    tx = Adam(1e-3)
    b = synthetic.make_pair_batch(np.random.default_rng(seed), batch, hw)
    _, losses = make_pair_train_step(net, tx)(
        TrainState(net, tx.init(net.parameters())),
        {k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return losses.cpu().numpy(), _grads(net)


def lightglue_step(device, seed: int = 0, pairs: int = 2, keypoints: int = 256,
                   layers: int = 9, dim: int = 256):
    """make_lightglue_train_fn for one step (clip, then Adam under
    train_lightglue's schedule) on `pairs` pairs of lightglue_batch, from
    Flax's initialisation drawn with `seed`: (losses [loss, pos, unmatch],
    the clipped gradients by parameter name)."""
    net = flax_init_(LightGlueNet(dim=dim, num_layers=layers),
                     torch.Generator().manual_seed(seed)).to(device)
    tx = Adam(warmup_cosine_decay_schedule(0.0, 2e-4, 1, 64, 2e-5), clip_norm=1.0)
    data = lightglue_batch(np.random.default_rng(seed), 1, pairs, keypoints, dim)
    _, losses = make_lightglue_train_fn(net, tx, epochs=1)(
        TrainState(net, tx.init(net.parameters())),
        {k: torch.from_numpy(v).to(device) for k, v in data.items()})
    return losses.cpu().numpy()[0], _grads(net)


def card_against_cpu(step, device="cuda", **kw) -> dict:
    """`step` (superpoint_step or lightglue_step) on `device` and on the
    CPU: the losses' largest relative difference, the gradients' largest
    grad_errors and where it falls."""
    lc, gc = step("cpu", **kw)
    ld, gd = step(device, **kw)
    errs = grad_errors(gd, gc)
    worst = max(errs, key=errs.get)
    return {"losses_cpu": lc.tolist(), "losses_card": ld.tolist(),
            "loss_rel_err": float(np.max(np.abs(ld - lc) / np.abs(lc))),
            "grad_rel_err": errs[worst], "grad_worst": worst,
            "finite": bool(np.isfinite(ld).all()
                           and all(np.isfinite(g).all() for g in gd.values()))}
