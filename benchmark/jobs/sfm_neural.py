"""Sparse SfM from images with the learned front end: the job of a user who
brings photographs with a known focal length and runs the CLI's
`IMAGES --neural` with LightGlue.

A scene is `SfMPipeline(config=cfg, neural_mode=True, device=...)
.reconstruct(image_set=image_set_from_arrays(images, camera))` on a fresh
pipeline object, cfg being `ReconstructionConfig()` with its `neural` block
from the configuration (the checkpoints named there, read from the
checkout). The images are rendered in set-up and handed over read-only.

Besides the SfM scene, `run` hands the check what the timed path's
networks produced at two candidate pairs drawn from the seed and the
scene's number: LightGlue's log-assignment, dustbins included, and its
matches before the mutual-NN fallback chooses, which the matcher keeps on
the device because the job names the pairs (`NeuralMatcher.keep_assignment`),
and SuperPoint's keypoints, scores and descriptors of every view those
pairs use. `check` holds the scene to benchmark/reference/sfm.py and the
networks to benchmark/reference/superpoint_lightglue.py: SuperPoint on
grayscale images it converts from the capture itself, LightGlue on the
checked views' features.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from benchmark import scene as bench_scene
from benchmark.reference import sfm as reference
from benchmark.reference import superpoint_lightglue as network_reference

ROOT = Path(__file__).resolve().parents[2]
CONTROL_POINTS = 5000
SAMPLED = 2                 # pairs of LightGlue checked a scene, with their views
STAGES = ("extract_time", "match_time", "init_time", "incremental_time", "final_ba_time")
GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.neural.matcher import NeuralMatcher

    if not hasattr(NeuralMatcher(device="cpu"), "keep_assignment"):
        raise RuntimeError("this port's NeuralMatcher keeps no LightGlue log-assignment for "
                           "named pairs (keep_assignment), which the cell's check compares")
    weights = {k: str(ROOT / v) for k, v in config["weights"].items()}
    base = ReconstructionConfig()
    cfg = base.replace(neural=dataclasses.replace(
        base.neural, superpoint_weights=weights["superpoint"],
        lightglue_weights=weights["lightglue"], **config["neural"]))
    pool = []
    for k in range(traffic["pool"]):
        capture = bench_scene.render(bench_scene.scene_spec(config, seed, k), device)
        capture["images"].flags.writeable = False
        camera = Camera.from_matrix(torch.from_numpy(capture["K"].astype(np.float32)))
        pool.append({"capture": capture, "camera": camera})
    return {"pool": pool, "device": device, "seed": int(seed), "cfg": cfg, "config": config,
            "reference": {k: network_reference.load_params(v, device)
                          for k, v in weights.items()}}


def _samples(state: dict, k: int, pairs):
    """The candidate pairs scene k checks, drawn from the seed, and the
    views they use."""
    rng = np.random.default_rng(np.random.SeedSequence([state["seed"], int(k), 3]))
    picked = [tuple(pairs[p]) for p in sorted(rng.choice(len(pairs), SAMPLED, replace=False))]
    return sorted({v for p in picked for v in p}), picked


def run(state: dict, k: int) -> dict:
    """Scene k: the pool's scene k mod its size, from scratch."""
    from recon3d_tpu_torch.io.dataset import image_set_from_arrays
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    s = state["pool"][k % len(state["pool"])]
    pipe = SfMPipeline(config=state["cfg"], neural_mode=True, device=state["device"])
    views, pairs = _samples(state, k, pipe._candidate_pairs(state["config"]["views"]))
    pipe.matcher.keep_assignment = pairs
    points, _, _ = pipe.reconstruct(
        image_set=image_set_from_arrays(s["capture"]["images"], s["camera"]))
    if pipe.matcher.matcher_kind != "lightglue":
        raise RuntimeError(f"the scene matched with {pipe.matcher.matcher_kind}, not LightGlue")
    feats, hw = pipe.features, tuple(pipe.image_set.gray.shape[1:3])
    network = {
        "hw": hw,
        "views": [{"view": v, "xy": feats[v].xy, "score": feats[v].score,
                   "desc": feats[v].desc, "valid": feats[v].valid} for v in views],
        "pairs": [{"pair": (i, j), "log_assign": pipe.matcher.kept_assignment[(i, j)],
                   "idx2": pipe.matcher.kept_matches[(i, j)],
                   "desc": (feats[i].desc, feats[j].desc), "xy": (feats[i].xy, feats[j].xy),
                   "valid": (feats[i].valid, feats[j].valid)} for i, j in pairs],
    }
    nc = state["cfg"].neural
    stats = {n: pipe.stats[n] for n in STAGES}
    stats["network"] = {"N": pipe.stats["selection_capacity"], "D": nc.descriptor_dim,
                        "L": nc.lightglue_layers}
    stats["candidate_pairs"] = pipe.stats["num_candidate_pairs"]
    return {"pool_index": k % len(state["pool"]), "points": points,
            "poses": dict(pipe.poses), "observations": pipe.observations,
            "kp_xy": pipe.kp_xy, "features_per_image": pipe.stats["features_per_image"],
            "network": network, "stats": stats}


def _pixel_index(xy: torch.Tensor, width: int) -> torch.Tensor:
    """The pixel a refined keypoint was selected at (refinement moves it by
    at most half a pixel; at exactly half, the neighbour ties in score)."""
    xi, yi = torch.round(xy[:, 0]).long(), torch.round(xy[:, 1]).long()
    return yi * width + xi


def _agreement(idx2: torch.Tensor, ref_idx2: torch.Tensor) -> tuple:
    """(rows where both give the same match, rows where either gives one)."""
    either = (idx2 >= 0) | (ref_idx2 >= 0)
    return int(((idx2 == ref_idx2) & either).sum()), int(either.sum())


def network_numbers(state: dict, net: dict, images: np.ndarray) -> dict:
    """The networks' numbers of one scene against the plain reference, in
    float32: SuperPoint on `images` (the capture's (V, H, W, 3)) converted
    to gray here, LightGlue on the timed scene's features of the checked
    views:
      sp_prob_err_max        max |detector probability - reference's| at
                             the valid keypoints of the checked views
      sp_desc_err_max        max |descriptor - reference's| (components),
                             the reference sampling its own map there
      sp_kp_shared           the least share, over the checked views, of
                             the valid keypoints the reference also selects
      lg_log_assign_err_max  max |log-assignment - reference's| over the
                             valid rows and columns and the dustbins of the
                             sampled pairs
      lg_match_agree         over the sampled pairs together, the share of
                             the rows matched by LightGlue or by the
                             reference's mutual argmax on its own
                             log-assignment at the configured threshold
                             that both match to the same keypoint (1.0
                             where neither matches a row)
      lg_rows_compared       how many rows that share is over (reported
                             for the readings, not limited)"""
    nc, dev = state["cfg"].neural, state["device"]
    sp, lg = state["reference"]["superpoint"], state["reference"]["lightglue"]
    prob_err, desc_err, shared, lg_err = 0.0, 0.0, 1.0, 0.0
    same = either = 0
    for v in net["views"]:
        gray = torch.from_numpy(np.asarray(images[v["view"]], np.float32) @ GRAY).to(dev)
        ref = network_reference.superpoint(sp, gray, nc.max_keypoints, nc.detection_threshold,
                                           nc.nms_radius)
        valid = v["valid"].to(dev)
        xy = v["xy"].to(dev)[valid]
        W = ref["prob"].shape[1]
        at = _pixel_index(xy, W)
        prob_err = max(prob_err, float((ref["prob"].reshape(-1)[at]
                                        - v["score"].to(dev)[valid]).abs().max()))
        own = network_reference.sample_descriptors(ref["desc_map"], xy)
        desc_err = max(desc_err, float((own - v["desc"].to(dev)[valid]).abs().max()))
        chosen = _pixel_index(ref["xy"][ref["valid"]], W)
        shared = min(shared, float(torch.isin(at, chosen).float().mean()))
    for p in net["pairs"]:
        (d0, d1), (x0, x1), (v0, v1) = p["desc"], p["xy"], p["valid"]
        ref = network_reference.lightglue(lg, d0.to(dev), d1.to(dev), x0.to(dev), x1.to(dev),
                                          v0.to(dev), v1.to(dev), net["hw"],
                                          num_layers=nc.lightglue_layers,
                                          num_heads=state["config"]["lightglue_heads"])
        one = torch.ones(1, dtype=torch.bool, device=dev)
        rows, cols = torch.cat([v0.to(dev), one]), torch.cat([v1.to(dev), one])
        diff = (ref - p["log_assign"].to(dev).to(ref.dtype))[rows][:, cols]
        lg_err = max(lg_err, float(diff.abs().max()))
        ref_idx2, _ = network_reference.mutual_matches(ref, v0.to(dev), v1.to(dev),
                                                       nc.lightglue_match_threshold)
        a, b = _agreement(p["idx2"].to(dev), ref_idx2)
        same, either = same + a, either + b
    return {"sp_prob_err_max": prob_err, "sp_desc_err_max": desc_err, "sp_kp_shared": shared,
            "lg_log_assign_err_max": lg_err,
            "lg_match_agree": same / either if either else 1.0, "lg_rows_compared": either}


def check(state: dict, out: dict) -> dict:
    capture = state["pool"][out["pool_index"]]["capture"]
    nums = reference.check_scene(capture, out)
    nums.update(network_numbers(state, out["network"], capture["images"]))
    return nums


def control(state: dict, k: int, dtype) -> dict:
    """Scene k with the references' own answers in `dtype` in the program's
    place: the SfM reference's (reference.control_scene) and the networks'
    at the pairs scene k samples and their views, from images converted to
    gray here."""
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    s = state["pool"][k % len(state["pool"])]
    capture = s["capture"]
    out = reference.control_scene(capture, CONTROL_POINTS, capture["spec"]["rng_seed"], dtype)
    nc, dev = state["cfg"].neural, state["device"]
    sp, lg = state["reference"]["superpoint"], state["reference"]["lightglue"]
    views, pairs = _samples(state, k, SfMPipeline(config=state["cfg"], device="cpu")
                            ._candidate_pairs(state["config"]["views"]))
    feats = {}
    for v in views:
        gray = np.asarray(capture["images"][v], np.float32) @ GRAY
        f = network_reference.superpoint(sp, torch.from_numpy(gray).to(dev), nc.max_keypoints,
                                         nc.detection_threshold, nc.nms_radius, dtype=dtype)
        feats[v] = dict(f, score=f["score"].float(), desc=f["desc"].float())
    hw = capture["images"].shape[1:3]
    pair_out = []
    for i, j in pairs:
        fi, fj = feats[i], feats[j]
        log_assign = network_reference.lightglue(
            lg, fi["desc"], fj["desc"], fi["xy"], fj["xy"], fi["valid"], fj["valid"], hw,
            num_layers=nc.lightglue_layers, num_heads=state["config"]["lightglue_heads"],
            dtype=dtype).float()
        idx2, _ = network_reference.mutual_matches(log_assign, fi["valid"], fj["valid"],
                                                   nc.lightglue_match_threshold)
        pair_out.append({"pair": (i, j), "log_assign": log_assign, "idx2": idx2,
                         "desc": (fi["desc"], fj["desc"]), "xy": (fi["xy"], fj["xy"]),
                         "valid": (fi["valid"], fj["valid"])})
    network = {"hw": hw, "pairs": pair_out,
               "views": [{"view": v, "xy": feats[v]["xy"], "score": feats[v]["score"],
                          "desc": feats[v]["desc"], "valid": feats[v]["valid"]} for v in views]}
    return dict(out, pool_index=k % len(state["pool"]), network=network)
