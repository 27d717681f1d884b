"""Dense MVS from known cameras: the job of a user who brings calibrated
images and their poses (DTU's protocol; the CLI's `--from-colmap --mvs`
without the mesh).

A scene is `PatchMatchMVS(camera, cfg.patchmatch).reconstruct(images,
poses, sparse_points=..., host_small=..., return_maps=True)` on a fresh
pipeline object, with the PatchMatch settings that the configuration
states (ReconstructionConfig's defaults, written out). The images, their
working-scale copy (`ImageSet.small_color`, what the CLI's load prepares)
and the sparse points are made in set-up and handed over read-only, so no
scene can leave anything for the next.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import scene as bench_scene
from benchmark.reference import mvs as reference


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.dataset import image_set_from_arrays

    cfg = dataclasses.replace(ReconstructionConfig().patchmatch, **config["patchmatch"])
    pool = []
    for k in range(traffic["pool"]):
        capture = bench_scene.render(bench_scene.scene_spec(config, seed, k), device)
        K32 = capture["K"].astype(np.float32)
        camera = Camera.from_matrix(torch.from_numpy(K32))
        small = image_set_from_arrays(capture["images"], camera).small_color(cfg.scale)
        Rs = capture["Rs"].astype(np.float32)
        ts = capture["ts"].astype(np.float32)
        sparse = bench_scene.surface_samples(capture, traffic["sparse_points"], seed + k)
        for a in (capture["images"], small, sparse, Rs, ts):
            a.flags.writeable = False
        pool.append({"capture": capture, "camera": camera, "small": small,
                     "inputs": {"images": capture["images"], "K": K32, "Rs": Rs, "ts": ts,
                                "sparse": sparse,
                                "truth": {"Rs": capture["Rs"], "ts": capture["ts"],
                                          "planes": capture["planes"]}},
                     "poses": {i: (Rs[i], ts[i]) for i in range(len(Rs))}})
    return {"pool": pool, "cfg": cfg, "settings": config["patchmatch"], "device": device}


def run(state: dict, k: int) -> dict:
    """Scene k: the pool's scene k mod its size, from scratch."""
    from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS

    s = state["pool"][k % len(state["pool"])]
    pm = PatchMatchMVS(s["camera"], state["cfg"], device=state["device"])
    points, _, maps = pm.reconstruct(
        s["inputs"]["images"], s["poses"], sparse_points=s["inputs"]["sparse"],
        host_small=s["small"], return_maps=True)
    return {"pool_index": k % len(state["pool"]), "points": points,
            "depth": maps["depth"], "conf": maps["conf"], "stats": dict(pm.stats)}


def check(state: dict, out: dict) -> dict:
    s = state["pool"][out["pool_index"]]
    return reference.check_scene(s["inputs"], out, state["settings"])


def control(state: dict, k: int, dtype) -> dict:
    """Scene k with the reference's own answer in `dtype` in the program's
    place (reference.control_scene)."""
    s = state["pool"][k % len(state["pool"])]
    H, W = s["inputs"]["images"].shape[1:3]
    scale = state["cfg"].scale
    out = reference.control_scene(s["inputs"], state["settings"], int(H * scale),
                                  int(W * scale), state["device"], dtype)
    return dict(out, pool_index=k % len(state["pool"]))
