"""Sparse SfM from images: the job of a user who brings uncalibrated
photographs with a known focal length (the CLI's `IMAGES` without the
dense stages).

A scene is `SfMPipeline(config=ReconstructionConfig(), device=...)
.reconstruct(image_set=image_set_from_arrays(images, camera))` on a fresh
pipeline object. The images are rendered in set-up and handed over
read-only, so no scene can leave anything for the next.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import scene as bench_scene
from benchmark.reference import sfm as reference

CONTROL_POINTS = 5000
STAGES = ("extract_time", "match_time", "init_time", "incremental_time", "final_ba_time")


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from recon3d_tpu_torch.camera import Camera

    pool = []
    for k in range(traffic["pool"]):
        capture = bench_scene.render(bench_scene.scene_spec(config, seed, k), device)
        capture["images"].flags.writeable = False
        camera = Camera.from_matrix(torch.from_numpy(capture["K"].astype(np.float32)))
        pool.append({"capture": capture, "camera": camera})
    return {"pool": pool, "device": device}


def run(state: dict, k: int) -> dict:
    """Scene k: the pool's scene k mod its size, from scratch."""
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.dataset import image_set_from_arrays
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    s = state["pool"][k % len(state["pool"])]
    pipe = SfMPipeline(config=ReconstructionConfig(), device=state["device"])
    points, _, _ = pipe.reconstruct(
        image_set=image_set_from_arrays(s["capture"]["images"], s["camera"]))
    return {"pool_index": k % len(state["pool"]), "points": points,
            "poses": dict(pipe.poses), "observations": pipe.observations,
            "kp_xy": pipe.kp_xy, "features_per_image": pipe.stats["features_per_image"],
            "stats": {n: pipe.stats[n] for n in STAGES}}


def check(state: dict, out: dict) -> dict:
    return reference.check_scene(state["pool"][out["pool_index"]]["capture"], out)


def control(state: dict, k: int, dtype) -> dict:
    """Scene k with the reference's own answer in `dtype` in the program's
    place (reference.control_scene)."""
    capture = state["pool"][k % len(state["pool"])]["capture"]
    out = reference.control_scene(capture, CONTROL_POINTS, capture["spec"]["rng_seed"], dtype)
    return dict(out, pool_index=k % len(state["pool"]))
