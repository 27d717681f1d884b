"""Command-line entry point of the PyTorch port: a COLMAP model's images and
poses -> sparse + dense PLY point clouds.

Port of recon3d_tpu/cli.py. The flag surface is the JAX CLI's whole one
(cli.py:23-75) plus --device. This slice runs the `--from-colmap` path,
with or without `--mvs`, on one device: load the images, adopt the model's
intrinsics and poses, PatchMatch, fuse, filter, and write sparse.ply,
cameras.ply, poses.npz and dense_mvs.ply. Every other mode exits non-zero
with a message naming it as not yet ported.

Run as `python -m recon3d_tpu_torch.cli <image_dir> --mvs --from-colmap MODEL_DIR`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="recon3d_tpu_torch",
        description="3D reconstruction from images (PyTorch/CUDA port)",
    )
    p.add_argument(
        "dataset",
        help="Image directory, or dataset name under data/samples/",
    )
    p.add_argument("--max-images", type=int, default=None,
                   help="Maximum number of images to process")
    p.add_argument("--dense", action="store_true",
                   help="Dense SIFT triangulation backend")
    p.add_argument("--stereo", action="store_true",
                   help="Plane-sweep stereo backend")
    p.add_argument("--mvs", action="store_true",
                   help="PatchMatch MVS backend (best quality)")
    p.add_argument("--combined", action="store_true",
                   help="Combined stereo + dense (deprecated; runs both)")
    p.add_argument("--fast", action="store_true",
                   help="Fast mode: sparse only, reduced resolution")
    p.add_argument("--neural", action="store_true",
                   help="SuperPoint + LightGlue neural matcher")
    p.add_argument("--output", type=str, default=None,
                   help="Output directory (default: <dataset>/reconstruction)")
    p.add_argument("--calibration", type=str, default=None,
                   help=".npz calibration file (keys mtx, dist)")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="Stage checkpoint directory (resume after crash)")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed")
    p.add_argument("--profile", type=str, default=None,
                   help="Write a device trace to this directory")
    p.add_argument("--stats-json", type=str, default=None,
                   help="Write pipeline statistics + stage timings to a JSON file")
    p.add_argument("--devices", type=int, default=0,
                   help="Max devices to use (0 = all; 1 disables the mesh)")
    p.add_argument("--global-sfm", action="store_true",
                   help="Global SfM (rotation/translation averaging over "
                        "the whole pose graph) instead of incremental "
                        "registration")
    p.add_argument("--mesh", action="store_true",
                   help="Also extract a TSDF triangle mesh (mesh.ply) from "
                        "the PatchMatch depth maps (implies --mvs)")
    p.add_argument("--mesh-resolution", type=int, default=192,
                   help="TSDF voxels per axis for --mesh")
    p.add_argument("--export-colmap", action="store_true",
                   help="Also write the sparse model as a COLMAP text model "
                        "(<output>/sparse_colmap/)")
    p.add_argument("--from-colmap", type=str, default=None, metavar="MODEL_DIR",
                   help="Skip SfM: take poses + sparse points from an "
                        "existing COLMAP text model and run the requested "
                        "dense stages on its images")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device to run on (default cuda; an error if no GPU)")
    return p


def unported_modes(args) -> list:
    """The requested modes this port cannot run yet, as flag names."""
    out = []
    if not args.from_colmap:
        out.append("SfM (running without --from-colmap)")
    for flag, on in [
        ("--stereo", args.stereo), ("--dense", args.dense),
        ("--combined", args.combined), ("--mesh", args.mesh),
        ("--neural", args.neural), ("--global-sfm", args.global_sfm),
        ("--checkpoint-dir", args.checkpoint_dir),
        ("--profile", args.profile), ("--export-colmap", args.export_colmap),
        ("--devices > 1", args.devices > 1),
    ]:
        if on:
            out.append(flag)
    return out


def resolve_dataset(dataset: str) -> Path:
    d = Path(dataset)
    if d.is_dir():
        return d
    candidate = Path("data/samples") / dataset
    if candidate.is_dir():
        return candidate
    raise SystemExit(f"ERROR: image directory not found: {dataset}")


def load_from_colmap(model_dir: str, image_dir: str, cfg, max_images=None,
                     device="cuda", prescales=()):
    """Load the images of `image_dir` with the intrinsics of a COLMAP text
    model (rescaled to the working resolution, pixels undistorted on
    `device`), map model entries to them by file name, and adopt the
    model's poses and sparse points. Mirrors recon3d_tpu/cli.py:88-146 with
    SfMPipeline.load_images (sfm/pipeline.py:372-383).

    Returns (image_set, points, colors, poses)."""
    import torch

    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.io.colmap import load_colmap_text
    from recon3d_tpu_torch.io.dataset import load_image_set

    model = load_colmap_text(model_dir)
    if model.images:
        first_im = model.images[min(model.images)]
        cam = model.cameras[first_im.camera_id]
    else:
        cam = model.cameras[min(model.cameras)]
    if len(model.cameras) > 1:
        print(
            f"WARNING: COLMAP model has {len(model.cameras)} cameras; "
            f"adopting camera {cam.camera_id} ({cam.model}) for ALL "
            f"images — views calibrated differently will reproject wrongly"
        )
    camera = Camera(K=torch.from_numpy(cam.K()), dist=torch.from_numpy(cam.dist()))
    iset = load_image_set(
        image_dir, camera, max_size=cfg.sfm.max_image_size,
        max_images=max_images, device=device,
    )
    for s in prescales:
        iset.small_color(s)
    name_to_idx = {n: i for i, n in enumerate(iset.names)}

    poses = {}
    for im in model.images.values():
        idx = name_to_idx.get(im.name)
        if idx is None:
            idx = name_to_idx.get(os.path.basename(im.name))
        if idx is None:
            continue
        poses[idx] = (im.R().astype(np.float32), im.t.astype(np.float32))
    if not poses:
        raise SystemExit(
            f"ERROR: no image names in {model_dir}/images.txt match files "
            f"in {image_dir}"
        )
    points = model.points.astype(np.float32).reshape(-1, 3)
    colors = model.colors.reshape(-1, 3)
    return iset, points, colors, poses


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    missing = unported_modes(args)
    if missing:
        raise SystemExit(
            "ERROR: not yet ported to recon3d_tpu_torch: "
            + ", ".join(missing)
            + " (run the JAX package's CLI, python -m recon3d_tpu.cli, for these)"
        )

    import torch

    from recon3d_tpu_torch.camera import CameraPose, stack_poses
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.ply import save_cameras_ply, save_ply
    from recon3d_tpu_torch.runtime.device import resolve_device
    from recon3d_tpu_torch.runtime.profiling import StageTimer

    device = resolve_device(args.device)
    image_dir = resolve_dataset(args.dataset)
    output_dir = Path(args.output) if args.output else image_dir / "reconstruction"
    output_dir.mkdir(parents=True, exist_ok=True)

    mode = [m for f, m in [(args.mvs, "PatchMatch MVS"), (args.fast, "Fast/sparse")]
            if f] or ["Sparse"]
    print(f"recon3d_tpu_torch: {image_dir} -> {output_dir}  "
          f"[{' + '.join(mode)}] on {device}")
    if args.calibration:
        print("[colmap] --calibration is superseded by the COLMAP model's "
              "intrinsics (as in the JAX CLI)")

    cfg = ReconstructionConfig.fast() if args.fast else ReconstructionConfig()
    cfg = cfg.replace(sfm=dataclasses.replace(cfg.sfm, seed=args.seed))
    timer = StageTimer()
    prescales = (cfg.patchmatch.scale,) if args.mvs and not args.fast else ()

    with timer.stage("sparse_sfm"):
        iset, points, colors, poses = load_from_colmap(
            args.from_colmap, str(image_dir), cfg, args.max_images,
            device=device, prescales=prescales,
        )
    print(f"[colmap] imported {len(poses)} posed images, "
          f"{len(points):,} sparse points from {args.from_colmap}")

    save_ply(str(output_dir / "sparse.ply"), points, colors)
    ids = sorted(poses)
    save_cameras_ply(
        str(output_dir / "cameras.ply"),
        stack_poses([CameraPose(R=torch.from_numpy(poses[i][0]),
                                t=torch.from_numpy(poses[i][1])) for i in ids]),
    )
    np.savez(
        output_dir / "poses.npz",
        image_ids=np.asarray(ids, np.int32),
        Rs=np.stack([np.asarray(poses[i][0]) for i in ids]),
        ts=np.stack([np.asarray(poses[i][1]) for i in ids]),
    )
    print(f"  sparse.ply: {len(points):,} points")

    stats = {}
    if args.mvs and not args.fast and len(poses) >= 3:
        from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS

        with timer.stage("patchmatch_mvs"):
            rec = PatchMatchMVS(iset.camera, cfg.patchmatch, device=device)
            dp, dc = rec.reconstruct(
                iset.color, poses, sparse_points=points,
                host_small=iset.prescaled.get(round(float(cfg.patchmatch.scale), 6)),
            )
        stats["patchmatch_breakdown_s"] = rec.stats
        stats["num_dense_points"] = int(len(dp))
        if len(dp):
            save_ply(str(output_dir / "dense_mvs.ply"), dp, dc)
            print(f"  dense_mvs.ply: {len(dp):,} points")

    timer.report()
    if args.stats_json:
        stats["stage_times_s"] = timer.as_dict()
        stats["num_sparse_points"] = int(len(points))
        stats["device"] = (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2, default=float)
        print(f"  stats -> {args.stats_json}")
    print(f"DONE. Results in {output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
