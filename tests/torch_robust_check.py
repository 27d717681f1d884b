"""The distorted capture of tests/test_robustness.py, end to end through
the port's undistort-at-load path, for tests/test_torch_robustness.py,
tests/test_torch_robust_cuda.py and chip_smoke.py (torch and numpy only:
no jax).

The scene, configuration and gates are tests/test_robustness.py's: 6
views of 192x256 on an arc of 0.14 rad, rendered through a k1/k2/p1/p2
lens (tests/torch_render.py), SfM at its tuned configuration, at least 5
cameras, mean reprojection under 1.5 px, median relative rotation error
of consecutive views under 1.0 deg. The views go to disk as PNGs and come
back through SfMPipeline.load_images with the lens as calibration, which
undistorts them on the pipeline's device (io/dataset.py: every colour
plane of the set in one K1 launch on a GPU, K1's plain version on the
CPU); the JAX test hands the arrays to the pipeline instead, which never
undistorts them.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.kernels import warp
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.synthetic import rotation_angle_deg
from tests.torch_render import render_views

DIST = np.array([0.12, -0.25, 0.004, 0.003, 0.0], np.float32)
SCENE = dict(n_views=6, image_size=(192, 256), arc_step=0.14)
GATE = {"min_cameras": SCENE["n_views"] - 1, "mean_reproj_px": 1.5, "median_rel_rot_deg": 1.0}


def tuned_config() -> ReconstructionConfig:
    """tests/test_robustness.py::_tuned_config on the port's config."""
    cfg = ReconstructionConfig()
    return cfg.replace(
        sift=dataclasses.replace(cfg.sift, max_features=1024, contrast_threshold=0.012),
        match=dataclasses.replace(cfg.match, min_matches=15, ransac_hypotheses=512),
        sfm=dataclasses.replace(cfg.sfm, pnp_hypotheses=512),
    )


def median_rel_rot_err(poses, Rs_gt) -> float:
    """Median rotation error of consecutive registered views' relative
    rotations; poses {view: (R, t)} as SfMPipeline.poses holds them."""
    ids = sorted(poses)
    errs = [rotation_angle_deg(np.asarray(poses[b][0]) @ np.asarray(poses[a][0]).T,
                               Rs_gt[b] @ Rs_gt[a].T) for a, b in zip(ids[:-1], ids[1:])]
    return float(np.median(errs))


def undistort_shape_key() -> str:
    """K1's shape_key at the load: every colour plane of the set at the
    H*W forward-distorted pixel positions they share."""
    V, (H, W) = SCENE["n_views"], SCENE["image_size"]
    return f"{3 * V}x{H}x{W}/1x{H * W}"


def write_pngs(images: np.ndarray, out: Path) -> Path:
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray((img * 255).astype(np.uint8)).save(out / f"view_{i:03d}.png")
    return out


def distorted_capture(work: Path, device) -> dict:
    """Render, write, load with the lens (K1's counts set to 0 just before
    the load and read just after), reconstruct; returns the outcome, K1's
    counts at the load, and the seconds of each step. Raises nothing:
    check_gate judges."""
    t0 = time.perf_counter()
    scene = render_views(**SCENE, dist=DIST)
    img_dir = write_pngs(scene["images"], Path(work) / "distorted")
    render_s = time.perf_counter() - t0

    pipe = SfMPipeline(config=tuned_config(), device=device)
    pipe.camera = Camera.from_matrix(scene["K"], DIST)
    sync = torch.cuda.synchronize if pipe.device.type == "cuda" else (lambda: None)
    sync()
    warp.counts.reset()
    t0 = time.perf_counter()
    iset = pipe.load_images(str(img_dir))
    sync()
    load_s = time.perf_counter() - t0
    load = {"kernel": warp.counts.kernel, "plain": warp.counts.plain,
            "kernel_by_shape": dict(warp.counts.by_shape),
            "kernel_by_variant": dict(warp.counts.by_variant)}
    t0 = time.perf_counter()
    _, _, poses = pipe.reconstruct(image_set=iset)
    sync()
    sfm_s = time.perf_counter() - t0
    return {
        "num_cameras": len(poses),
        "mean_reproj_px": float(pipe.stats["mean_reproj_px"]),
        "median_rel_rot_deg": median_rel_rot_err(pipe.poses, scene["Rs"]),
        "camera_dist_after_load": pipe.camera.dist.tolist(),
        "k1_by_stage": {"load": load},
        "seconds": {"render": render_s, "load": load_s, "sfm": sfm_s},
    }


def check_gate(out: dict) -> list:
    """The gate's failures, empty when it holds."""
    failed = []
    if out["num_cameras"] < GATE["min_cameras"]:
        failed.append(f"{out['num_cameras']} cameras registered")
    for key in ("mean_reproj_px", "median_rel_rot_deg"):
        if not out[key] < GATE[key]:
            failed.append(f"{key} {out[key]:.4f}")
    if any(out["camera_dist_after_load"]):
        failed.append("the camera keeps its distortion after the load")
    return failed
