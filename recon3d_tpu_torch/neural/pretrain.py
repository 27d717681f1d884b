"""Synthetic pretraining of SuperPoint and LightGlue (the MagicPoint
recipe).

PyTorch port of recon3d_tpu/neural/pretrain.py, the trainer that made the
JAX package's bundled checkpoints (docs/neural_quality.md:88-100). Data is
rendered on the host (numpy, neural/synthetic.py) in rounds: each round's
compact batches are uploaded once and `batches_per_round *
epochs_per_round` optimizer steps run over them on the device
(neural/train.py). `train_lightglue` extracts its features with the frozen
SuperPoint in one batched forward a round, and detect_keypoints samples
each image's descriptors through K1 (kernels/warp.py) on the card.

Run:
    python -m recon3d_tpu_torch.neural.pretrain --steps 3000 [--device cpu]
    python -m recon3d_tpu_torch.neural.pretrain --model lightglue --steps 4096

--devices N trains data-parallel over N devices (parallel/mesh.py; 0 takes
every visible GPU, capped as the CLI caps it): each batch splits over the
ranks and the gradients are summed before every step.

The default --out is recon3d_tpu_torch/neural/pretrained/{superpoint,
lightglue}_synthetic.npz (git-ignored). The JAX package's bundled files
under recon3d_tpu/neural/pretrained/ are never written: the matcher keeps
reading them unless NeuralConfig names other weights.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from recon3d_tpu_torch.neural import synthetic
from recon3d_tpu_torch.runtime.device import resolve_device

DEFAULT_OUT = Path(__file__).resolve().parent / "pretrained" / "superpoint_synthetic.npz"
# The JAX package's bundled checkpoints, which this trainer must not replace.
JAX_PRETRAINED = Path(__file__).resolve().parents[2] / "recon3d_tpu" / "neural" / "pretrained"


def _check_out(out) -> None:
    if out and Path(out).resolve().parent == JAX_PRETRAINED.resolve():
        raise ValueError(f"--out {out}: the JAX package's bundled checkpoints are not written "
                         "by the port; choose another path")


def pseudo_label_images(score_fn, params, images, rng, hw, n_homo: int = 6,
                        max_corners: int = 60, threshold: float = 0.01):
    """Homographic-adaptation corner labels for unlabelled images
    (recon3d_tpu/neural/pretrain.py:29): each image under `n_homo` random
    homographies (the first the identity) scored in one batched call
    score_fn(params, (B * n_homo, H, W, 1) CPU float32 tensor) -> (B *
    n_homo, H, W) score maps; the maps unwarped to the image's frame,
    averaged, and the stable local maxima above `threshold` kept, at most
    `max_corners`, strongest first. Unwarping, averaging and the maximum
    filter run on the host, as in the JAX package.

    Returns a list of (N_i, 2) float32 (x, y) corner arrays, one an image."""
    from scipy.ndimage import maximum_filter

    stack, homos = [], []
    for im in images:
        stack.append(im)
        homos.append(None)
        for _ in range(n_homo - 1):
            Hm = synthetic.random_homography(rng, hw)
            stack.append(synthetic.warp_image(im, Hm))
            homos.append(Hm)
    with torch.no_grad():
        smaps = score_fn(params, torch.from_numpy(np.stack(stack))[..., None])
    smaps = smaps.cpu().numpy() if torch.is_tensor(smaps) else np.asarray(smaps)
    labels = []
    for b in range(len(images)):
        acc = smaps[b * n_homo].astype(np.float64).copy()
        cnt = np.ones(hw)
        for k in range(1, n_homo):
            Hinv = np.linalg.inv(homos[b * n_homo + k])
            acc += synthetic.warp_image(smaps[b * n_homo + k], Hinv)
            cnt += synthetic.warp_image(np.ones(hw, np.float32), Hinv)
        avg = acc / np.maximum(cnt, 1e-6)
        cand = (avg >= maximum_filter(avg, size=5)) & (avg > threshold)
        ys, xs = np.nonzero(cand)
        order = np.argsort(-avg[ys, xs])[:max_corners]
        labels.append(np.stack([xs[order], ys[order]], -1).astype(np.float32))
    return labels


def _upload(batches, device) -> Dict[str, torch.Tensor]:
    """A round of compact batches stacked (D, B, ...) and copied to the
    device once."""
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(device)
            for k in batches[0]}


def _init_module(module, seed: int, init_params, device):
    """The module's starting parameters: Flax's initialisation drawn from
    a generator seeded with `seed`, or `init_params` (flat '/'-keyed Flax
    parameters, e.g. the JAX package's initialisation), on `device`."""
    from recon3d_tpu_torch.convert import flax_to_state_dict
    from recon3d_tpu_torch.neural.weights import flax_init_

    if init_params is not None:
        module.load_state_dict(flax_to_state_dict(init_params, module), strict=True)
    else:
        flax_init_(module, torch.Generator().manual_seed(seed))
    return module.to(device)


def train(steps: int = 3000, batch: int = 32, hw=(128, 128), lr: float = 1e-3, seed: int = 0,
          out: Optional[str] = None, desc_weight: float = 1.0, batches_per_round: int = 12,
          epochs_per_round: int = 16, adapt_steps: int = 0, texture_frac: float = 0.5,
          scene_frac: float = 0.0, init_weights: Optional[str] = None, device="cuda",
          init_params: Optional[Dict[str, np.ndarray]] = None, stats: Optional[dict] = None,
          mesh=None):
    """SuperPoint from synthetic shapes, round by round: each round renders
    `batches_per_round` compact batches on the host (rng seeded with
    `seed`), uploads them once and runs `batches_per_round *
    epochs_per_round` steps (train.make_epoch_train_fn), until `steps`;
    then `adapt_steps` of homographic adaptation, where each batch is, by
    one uniform draw, pseudo-labelled scene renders (scene_frac),
    pseudo-labelled textures (texture_frac) or shapes. Adam under a linear
    warmup and cosine decay to 5% of lr. init_weights (an .npz or .pth)
    warm-starts; init_params replaces the initial draw (see _init_module).
    `stats`, if given, receives each round's host and device seconds and
    all the losses. mesh: a parallel.mesh.Mesh whose 'data' axis splits
    each batch (recon3d_tpu/neural/pretrain.py:115-153). Returns the
    TrainState."""
    from recon3d_tpu_torch.neural.superpoint import SuperPointNet, scores_from_logits
    from recon3d_tpu_torch.neural.train import (
        Adam, TrainState, make_epoch_train_fn, warmup_cosine_decay_schedule)
    from recon3d_tpu_torch.neural.weights import save_params_npz

    _check_out(out)
    device = resolve_device(device)
    model = _init_module(SuperPointNet(), seed, init_params, device)
    if init_weights:
        from recon3d_tpu_torch.neural.weights import load_params_npz

        load_params_npz(init_weights, model)
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(100, steps // 10 + 1),
        decay_steps=max(steps + adapt_steps, 2), end_value=lr * 0.05)
    tx = Adam(sched)
    state = TrainState(model, tx.init(model.parameters()), 0)
    steps_per_round = batches_per_round * epochs_per_round
    run = make_epoch_train_fn(model, tx, mesh=mesh, epochs=epochs_per_round,
                              desc_weight=desc_weight)
    stats = {} if stats is None else stats
    stats.setdefault("rounds", [])

    def train_round(phase: str, data, render_s: float, label_s: float = 0.0):
        t0 = time.perf_counter()
        stacked = _upload(data, device)
        _, losses = run(state, stacked)
        losses = losses.cpu().numpy()   # waits for the round's last step
        stats["rounds"].append({"phase": phase, "steps": steps_per_round, "render_s": render_s,
                                "label_s": label_s, "train_s": time.perf_counter() - t0,
                                "losses": losses.tolist()})
        return losses[-1]

    rng = np.random.default_rng(seed)
    t_start = time.time()
    done = 0
    while done < steps:
        t0 = time.perf_counter()
        data = [synthetic.make_pair_batch_compact(rng, batch, hw)
                for _ in range(batches_per_round)]
        l, det, dsc = train_round("shapes", data, time.perf_counter() - t0)
        done += steps_per_round
        print(f"[pretrain] step {done}/{steps} loss {l:.4f} (det {det:.4f} desc {dsc:.4f}) "
              f"{done / (time.time() - t_start):.2f} steps/s", flush=True)

    if adapt_steps:
        def score_fn(m, x):
            return scores_from_logits(m(x.to(device))[0])

        def scene_image(r):
            sc = synthetic.render_view_pair(r, hw)
            return sc["img_a"] if r.uniform() < 0.5 else sc["img_b"]

        done_a = 0
        while done_a < adapt_steps:
            data, render_s, label_s = [], 0.0, 0.0
            for _ in range(batches_per_round):
                t0 = time.perf_counter()
                u = rng.uniform()
                if u < scene_frac:
                    imgs = [scene_image(rng) for _ in range(batch)]
                elif u < scene_frac + texture_frac:
                    imgs = [synthetic.render_texture(rng, hw) for _ in range(batch)]
                else:
                    imgs = None
                if imgs is not None:
                    t1 = time.perf_counter()
                    corners = pseudo_label_images(score_fn, model, imgs, rng, hw)
                    label_s += time.perf_counter() - t1
                    queue = list(zip(imgs, corners))
                    data.append(synthetic.make_pair_batch_compact(
                        rng, batch, hw, sampler=lambda r: queue.pop()))
                else:
                    data.append(synthetic.make_pair_batch_compact(rng, batch, hw))
                render_s += time.perf_counter() - t0
            l, det, dsc = train_round("adapt", data, render_s - label_s, label_s)
            done_a += steps_per_round
            print(f"[pretrain-adapt] step {done_a}/{adapt_steps} loss {l:.4f} "
                  f"(det {det:.4f} desc {dsc:.4f})", flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        save_params_npz(model, out)
        print(f"[pretrain] saved checkpoint -> {out}")
    return state


def _photometric_jitter(im: np.ndarray, rng) -> np.ndarray:
    """Independent per-view photometric augmentation on the host: gamma,
    gain and bias, additive Gaussian noise, an occasional 3x3 box blur
    (recon3d_tpu/neural/pretrain.py:237)."""
    out = im.astype(np.float32)
    out = np.clip(out, 1e-4, 1.0) ** rng.uniform(0.7, 1.4)
    out = out * rng.uniform(0.6, 1.3) + rng.uniform(-0.15, 0.15)
    if rng.uniform() < 0.5:
        out = out + rng.normal(scale=rng.uniform(0.01, 0.05), size=out.shape).astype(np.float32)
    if rng.uniform() < 0.25:
        k = np.ones(3, np.float32) / 3.0
        out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, out)
        out = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, out)
    return np.clip(out, 0.0, 1.0)


def _ground_truth(xy, valid, geos, n_pairs: int, K: int, gt_radius_px: float):
    """The three-class assignment of each pair on the host (>= 0 partner,
    -1 unmatchable, -2 ignored) and set 1's near misses
    (recon3d_tpu/neural/pretrain.py:388-450): mutual nearest neighbours of
    the reprojected set-0 keypoints within gt_radius_px match; a keypoint
    with a detection within the ignore radius that is not its mutual
    nearest is ignored, on either side."""
    ignore_radius = max(2.5 * gt_radius_px, 8.0)
    gt = np.full((n_pairs, K), -1, np.int32)
    ign1 = np.zeros((n_pairs, K), bool)
    for p in range(n_pairs):
        xa, xb = xy[p], xy[n_pairs + p]
        va, vb = valid[p], valid[n_pairs + p]
        kind, geo = geos[p]
        if kind == "view":
            proj, covis = synthetic.project_view_points(
                xa, geo["depth_a"], geo["depth_b"], geo["K"], geo["Ra"], geo["ta"],
                geo["Rb"], geo["tb"])
            va = va & covis
        else:
            proj = synthetic.warp_points(geo, xa)
        d = np.hypot(proj[:, None, 0] - xb[None, :, 0], proj[:, None, 1] - xb[None, :, 1])
        d[~va] = np.inf
        d[:, ~vb] = np.inf
        j = np.argmin(d, 1)
        dj = d[np.arange(K), j]
        back = np.argmin(d, 0)
        ok = (dj < gt_radius_px) & (back[j] == np.arange(K))
        gt[p, ok] = j[ok]
        gt[p, ~ok & (dj < ignore_radius)] = -2
        ign1[p] = d.min(axis=0) < ignore_radius
    return gt, ign1


@torch.no_grad()
def extract_features(sp, cfg, imgs: torch.Tensor, max_keypoints: int):
    """SuperPoint features of a stack of (H, W) images: one batched forward
    of `sp`, then detect_keypoints an image at cfg's threshold and NMS
    radius, whose descriptor sampling is one K1 launch an image on the
    card. Returns NeuralFeatures with a leading image dimension."""
    from recon3d_tpu_torch.neural.superpoint import (
        NeuralFeatures, detect_keypoints, scores_from_logits)

    logits, desc = sp(imgs[..., None])
    scores = scores_from_logits(logits)
    feats = [detect_keypoints(scores[i], desc[i], max_keypoints=max_keypoints,
                              detection_threshold=cfg.detection_threshold,
                              nms_radius=cfg.nms_radius) for i in range(len(imgs))]
    return NeuralFeatures(*(torch.stack([getattr(f, k) for f in feats])
                            for k in ("xy", "score", "desc", "valid")))


def train_lightglue(steps: int = 4096, batch: int = 16, hw=(128, 128), max_keypoints: int = 256,
                    lr: float = 2e-4, seed: int = 0, out: Optional[str] = None,
                    batches_per_round: int = 8, epochs_per_round: int = 8,
                    gt_radius_px: float = 3.0, detection_threshold: float = 2e-5,
                    texture_frac: float = 0.0, view_pair_frac: float = 0.0,
                    superpoint_weights: Optional[str] = None, device="cuda",
                    init_params: Optional[Dict[str, np.ndarray]] = None,
                    stats: Optional[dict] = None, mesh=None):
    """LightGlue on synthetic pairs with features of the frozen SuperPoint
    (the bundled checkpoint unless superpoint_weights names another,
    through NeuralMatcher's loader, at the lower training threshold).

    A round renders its pairs on the host (shapes or textures under a
    random homography, or true 3-D view pairs for view_pair_frac, each view
    photometrically jittered), extracts the 2P images' features in one
    batched SuperPoint forward and one detect_keypoints an image (K1 on
    the card), thins each keypoint set by a random survival rate, builds
    the three-class ground truth on the host and runs `batches_per_round *
    epochs_per_round` steps of clip-then-Adam under a linear warmup and
    cosine decay to 10% of lr. init_params replaces the initial draw (flat
    Flax parameters; jax.random's draws cannot be reproduced in torch).
    `stats`, if given, receives each round's seconds, ground-truth matches
    and losses. mesh: as in `train` (the features are extracted on rank
    0; the steps split each batch's pairs). Returns the TrainState."""
    from recon3d_tpu_torch.config import NeuralConfig
    from recon3d_tpu_torch.neural.lightglue import LightGlueNet, normalize_keypoints
    from recon3d_tpu_torch.neural.matcher import NeuralMatcher
    from recon3d_tpu_torch.neural.train import (
        Adam, TrainState, make_lightglue_train_fn, warmup_cosine_decay_schedule)
    from recon3d_tpu_torch.neural.weights import save_params_npz

    _check_out(out)
    device = resolve_device(device)
    nm = NeuralMatcher(NeuralConfig(max_keypoints=max_keypoints,
                                    detection_threshold=detection_threshold,
                                    superpoint_weights=superpoint_weights), device=device)
    nm._ensure_params()
    sp, cfg = nm.sp, nm.config

    lg = _init_module(LightGlueNet(dim=cfg.descriptor_dim, num_layers=cfg.lightglue_layers),
                      seed, init_params, device)
    K, D = max_keypoints, cfg.descriptor_dim
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(200, steps // 10 + 1), decay_steps=max(steps, 2),
        end_value=lr * 0.1)
    tx = Adam(sched, clip_norm=1.0)
    state = TrainState(lg, tx.init(lg.parameters()), 0)
    run = make_lightglue_train_fn(lg, tx, mesh=mesh, epochs=epochs_per_round)
    stats = {} if stats is None else stats
    stats.setdefault("rounds", [])

    rng = np.random.default_rng(seed)
    t_start = time.time()
    done = 0
    steps_per_round = batches_per_round * epochs_per_round
    while done < steps:
        t0 = time.perf_counter()
        n_pairs = batches_per_round * batch
        imgs_a, imgs_b, geos = [], [], []
        for _ in range(n_pairs):
            if rng.uniform() < view_pair_frac:
                sc = synthetic.render_view_pair(rng, hw)
                imgs_a.append(_photometric_jitter(sc["img_a"], rng))
                imgs_b.append(_photometric_jitter(sc["img_b"], rng))
                geos.append(("view", sc))
                continue
            if rng.uniform() < texture_frac:
                im = synthetic.render_texture(rng, hw)
            else:
                im, _ = synthetic.render_shapes(rng, hw)
            Hm = synthetic.random_homography(rng, hw)
            imgs_a.append(_photometric_jitter(im, rng))
            imgs_b.append(_photometric_jitter(synthetic.warp_image(im, Hm), rng))
            geos.append(("homo", Hm))
        stackab = np.stack(imgs_a + imgs_b).astype(np.float32)   # (2P, H, W)
        t1 = time.perf_counter()
        feats = extract_features(sp, cfg, torch.from_numpy(stackab).to(device), max_keypoints)
        xy = feats.xy.cpu().numpy()
        valid = feats.valid.cpu().numpy()
        t2 = time.perf_counter()
        # density augmentation: thin each image's set by a random survival rate
        rate = np.where(rng.random((2 * n_pairs, 1)) < 0.5,
                        rng.uniform(0.4, 1.0, (2 * n_pairs, 1)), 1.0)
        valid = valid & (rng.random((2 * n_pairs, K)) < rate)
        gt, ign1 = _ground_truth(xy, valid, geos, n_pairs, K, gt_radius_px)
        t3 = time.perf_counter()
        sh = (batches_per_round, batch, K)

        def dev(a):
            return torch.from_numpy(a).to(device).reshape(sh)

        data = dict(
            desc0=feats.desc[:n_pairs].reshape(sh + (D,)),
            desc1=feats.desc[n_pairs:].reshape(sh + (D,)),
            xy0n=normalize_keypoints(feats.xy[:n_pairs], hw).reshape(sh + (2,)),
            xy1n=normalize_keypoints(feats.xy[n_pairs:], hw).reshape(sh + (2,)),
            valid0=dev(valid[:n_pairs]), valid1=dev(valid[n_pairs:]),
            gt_idx=dev(gt), ignore1=dev(ign1),
        )
        _, losses = run(state, data)
        losses = losses.cpu().numpy()
        t4 = time.perf_counter()
        done += steps_per_round
        l, lp, lu = losses[-1]
        n_m = (gt >= 0).sum(1)
        stats["rounds"].append({"phase": "lightglue", "steps": steps_per_round,
                                "render_s": t1 - t0, "extract_s": t2 - t1,
                                "ground_truth_s": t3 - t2, "train_s": t4 - t3,
                                "gt_matches_per_pair": float(n_m.mean()),
                                "losses": losses.tolist()})
        print(f"[pretrain-lg] step {done}/{steps} loss {l:.4f} (pos {lp:.4f} unmatch "
              f"{lu:.4f}) gt-matches/pair {n_m.mean():.0f} "
              f"{done / (time.time() - t_start):.2f} steps/s", flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        save_params_npz(lg, out)
        print(f"[pretrain-lg] saved checkpoint -> {out}")
    return state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SuperPoint / LightGlue synthetic pretraining "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--model", choices=("superpoint", "lightglue"), default="superpoint")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=128, help="square image size")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--desc-weight", type=float, default=1.0)
    p.add_argument("--batches-per-round", type=int, default=12)
    p.add_argument("--epochs-per-round", type=int, default=16)
    p.add_argument("--adapt-steps", type=int, default=0,
                   help="homographic-adaptation steps on pseudo-labeled value-noise "
                   "textures after the shapes phase (superpoint)")
    p.add_argument("--texture-frac", type=float, default=0.5,
                   help="fraction of adaptation batches (superpoint) / training pairs "
                   "(lightglue) drawn from textures")
    p.add_argument("--view-pair-frac", type=float, default=0.0,
                   help="fraction of lightglue training pairs rendered as true 3D view "
                   "pairs (parallax + occlusion, depth GT)")
    p.add_argument("--scene-frac", type=float, default=0.0,
                   help="fraction of adaptation batches (superpoint) drawn from in-domain "
                   "multi-plane SCENE renders")
    p.add_argument("--init-weights", default=None,
                   help="warm-start superpoint training from this .npz or .pth (use with "
                   "--steps 0 for adaptation-only fine-tune)")
    p.add_argument("--superpoint", default=None,
                   help="frozen SuperPoint checkpoint for lightglue training (default: "
                   "the JAX package's bundled one)")
    p.add_argument("--out", default=str(DEFAULT_OUT),
                   help="checkpoint to write (default: under recon3d_tpu_torch/neural/"
                   "pretrained/; --model lightglue renames the default to "
                   "lightglue_synthetic.npz)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--devices", type=int, default=1,
                   help="devices to train on, data-parallel (0 = every visible GPU; "
                   "capped at those visible; on cpu, that many CPU ranks)")
    p.add_argument("--stats-json", default=None,
                   help="write each round's host and device seconds, the losses, K1's "
                   "launches and the peak of device memory here")
    return p


def run(a: argparse.Namespace, stats: Optional[dict] = None, mesh=None):
    """Train as the parsed flags of build_parser ask, with the JAX CLI's
    quirks: --model lightglue caps the batch at 16, takes lr 2e-4 for the
    default 1e-3 and writes lightglue_synthetic.npz where the default
    output is named. Returns (the TrainState, the checkpoint written)."""
    out = a.out
    if a.model == "lightglue":
        if out.endswith("superpoint_synthetic.npz"):   # the superpoint default
            out = os.path.join(os.path.dirname(out), "lightglue_synthetic.npz")
        state = train_lightglue(
            steps=a.steps, batch=min(a.batch, 16), hw=(a.size, a.size),
            lr=a.lr if a.lr != 1e-3 else 2e-4, seed=a.seed, out=out,
            batches_per_round=a.batches_per_round, epochs_per_round=a.epochs_per_round,
            texture_frac=a.texture_frac, view_pair_frac=a.view_pair_frac,
            superpoint_weights=a.superpoint, device=a.device, stats=stats, mesh=mesh)
    else:
        state = train(steps=a.steps, batch=a.batch, hw=(a.size, a.size), lr=a.lr, seed=a.seed,
                      out=out, desc_weight=a.desc_weight, batches_per_round=a.batches_per_round,
                      epochs_per_round=a.epochs_per_round, adapt_steps=a.adapt_steps,
                      texture_frac=a.texture_frac, scene_frac=a.scene_frac,
                      init_weights=a.init_weights, device=a.device, stats=stats, mesh=mesh)
    return state, out


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    from recon3d_tpu_torch.kernels.warp import record_launches

    device = resolve_device(a.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    stats: dict = {"model": a.model, "device": str(device)}
    k1: dict = {}
    t0 = time.perf_counter()
    from recon3d_tpu_torch.parallel.mesh import data_parallel_mesh, mesh_devices

    n_dev = mesh_devices(a.devices, device)
    mesh = data_parallel_mesh(n_dev, device)
    try:
        with (mesh.record_launches if mesh else record_launches)(k1, f"train_{a.model}"):
            _, out = run(a, stats, mesh)
    finally:
        if mesh is not None:
            mesh.close()
    stats["devices"] = n_dev
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.update(out=out, wall_s=time.perf_counter() - t0, k1_calls_by_stage=k1,
                 peak_bytes=(torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None))
    if a.stats_json:
        Path(a.stats_json).write_text(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
