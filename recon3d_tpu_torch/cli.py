"""Command-line entry point of the PyTorch port: images -> sparse + dense
PLY point clouds and a mesh.

Port of recon3d_tpu/cli.py. The flag surface is the JAX CLI's whole one
(cli.py:23-75) plus --device. On one device it runs incremental SfM, or
takes poses and sparse points from a COLMAP model (--from-colmap), then the
dense stages asked for: PatchMatch (--mvs), plane sweep (--stereo) and the
TSDF mesh (--mesh, from whichever of the two ran), and writes the JAX
CLI's files: sparse.ply, cameras.ply, poses.npz, sparse_colmap/
(--export-colmap), dense_mvs.ply, dense_stereo.ply, mesh.ply and dense.ply
(dense SIFT: --dense, or --combined, which also runs the sweep). With
--checkpoint-dir it saves the sparse state and each PatchMatch depth map
and resumes from them; --profile writes a torch.profiler trace of the run.

--devices N runs on a data-parallel mesh of N devices (parallel/mesh.py;
0 takes every visible GPU): pair matching, bundle adjustment, PatchMatch,
the plane sweep and the TSDF fusion shard over it, as the JAX CLI's mesh
does (recon3d_tpu/cli.py:187-203). The CLI starts the other ranks itself.
On "cuda" N is capped at the visible GPUs; on "cpu" N asks for N CPU
ranks. The default is 1, one device, where the JAX CLI takes every
device: on two GPUs the mesh has run slower than one GPU so far.

Run as `python -m recon3d_tpu_torch.cli <image_dir> --mvs [--mesh] [--stereo]`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
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
    p.add_argument("--devices", type=int, default=1,
                   help="Max devices to use, data-parallel (1, the default: one "
                        "device, no mesh; 0 = every visible GPU)")
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


def resolve_dataset(dataset: str) -> Path:
    d = Path(dataset)
    if d.is_dir():
        return d
    candidate = Path("data/samples") / dataset
    if candidate.is_dir():
        return candidate
    raise SystemExit(f"ERROR: image directory not found: {dataset}")


def load_from_colmap(pipeline, model_dir: str, image_dir: str, max_images=None):
    """Seed `pipeline` (an SfMPipeline) from an existing COLMAP text model:
    load the images with the model's intrinsics (rescaled to the working
    resolution, pixels undistorted on the pipeline's device), map model
    entries to them by file name, and adopt the model's poses and sparse
    points, as recon3d_tpu/cli.py:88-146 does.

    Returns (points, colors, poses)."""
    iset, points, colors, poses = _load_from_colmap(
        model_dir, image_dir, pipeline.config, max_images,
        device=pipeline.device, prescales=pipeline.prescale_hints)
    pipeline.image_set = iset
    pipeline.camera = iset.camera
    pipeline.poses = dict(poses)
    pipeline.registered = set(poses)
    pipeline.points3d = points
    pipeline.point_colors = colors
    return points, colors, poses


def _load_from_colmap(model_dir: str, image_dir: str, cfg, max_images=None,
                      device="cuda", prescales=()):
    """load_from_colmap without a pipeline: the CLI's dense-only runs take
    the image set with the model. Returns (image_set, points, colors,
    poses)."""
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

    import torch

    from recon3d_tpu_torch.kernels import pointcloud
    from recon3d_tpu_torch.parallel.mesh import data_parallel_mesh, mesh_devices
    from recon3d_tpu_torch.runtime.device import resolve_device
    from recon3d_tpu_torch.runtime.profiling import StageTimer, maybe_trace, span

    device = resolve_device(args.device)
    image_dir = resolve_dataset(args.dataset)
    output_dir = Path(args.output) if args.output else image_dir / "reconstruction"
    output_dir.mkdir(parents=True, exist_ok=True)

    mode = [
        m for f, m in [
            (args.neural, "Neural matching"),
            (args.mvs, "PatchMatch MVS"), (args.stereo, "Plane-sweep stereo"),
            (args.dense, "Dense SIFT"), (args.combined, "Combined"),
            (args.fast, "Fast/sparse"),
        ] if f
    ] or ["Sparse"]
    print(f"recon3d_tpu_torch: {image_dir} -> {output_dir}  "
          f"[{' + '.join(mode)}] on {device}")

    timer = StageTimer()
    k1_calls = {}
    searches = pointcloud.snapshot()
    n_dev = mesh_devices(args.devices, device)
    mesh = data_parallel_mesh(n_dev, device)
    try:
        # the run is one root trace; --profile's trace shows its spans
        with maybe_trace(args.profile, device), span("cli.run") as run:
            stats, points = _run(args, device, image_dir, output_dir, timer, k1_calls, mesh)
    finally:
        if mesh is not None:
            mesh.close()

    timer.report()
    if args.stats_json:
        stats["stage_times_s"] = timer.as_dict()
        stats["trace"] = run.trace.aggregate()
        stats["num_sparse_points"] = int(len(points))
        stats["k1_calls_by_stage"] = k1_calls
        # K2's and K3's launches and plain calls in this run
        stats["pointcloud_calls"] = pointcloud.since(searches)
        stats["device"] = (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")
        stats["devices"] = n_dev
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2, default=float)
        print(f"  stats -> {args.stats_json}")
    print(f"DONE. Results in {output_dir}")
    return 0


def _run(args, device, image_dir: Path, output_dir: Path, timer, k1_calls: dict, mesh=None):
    """The stages the flags ask for (recon3d_tpu/cli.py:217-384). Returns
    (the --stats-json record so far, the sparse points). With a mesh, K1's
    launches are counted on every rank (summed, and 'by_rank')."""
    import torch

    from recon3d_tpu_torch.camera import CameraPose, stack_poses
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.ply import save_cameras_ply, save_ply
    from recon3d_tpu_torch.kernels import warp

    record_launches = mesh.record_launches if mesh is not None else warp.record_launches

    cfg = ReconstructionConfig.fast() if args.fast else ReconstructionConfig()
    cfg = cfg.replace(sfm=dataclasses.replace(cfg.sfm, seed=args.seed))

    # Dense-stage working scales, prescaled at image-load time.
    will_mvs = args.mvs or (args.mesh and not (args.stereo and not args.mvs))
    will_stereo = args.stereo or args.combined
    prescales = set()
    if will_mvs and not args.fast:
        prescales.add(cfg.patchmatch.scale)
    if will_stereo and not args.fast:
        prescales.add(cfg.plane_sweep.scale)

    ckpt = None
    if args.checkpoint_dir:
        from recon3d_tpu_torch.runtime.checkpoint import StageCheckpointer

        ckpt = StageCheckpointer(args.checkpoint_dir)

    pipeline = None
    if args.from_colmap:
        if args.calibration:
            print("[colmap] --calibration is superseded by the COLMAP model's "
                  "intrinsics (as in the JAX CLI)")
        with timer.stage("sparse_sfm"):
            iset, points, colors, poses = _load_from_colmap(
                args.from_colmap, str(image_dir), cfg, args.max_images,
                device=device, prescales=sorted(prescales),
            )
        print(f"[colmap] imported {len(poses)} posed images, "
              f"{len(points):,} sparse points from {args.from_colmap}")
    else:
        from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

        pipeline = SfMPipeline(
            calibration_path=args.calibration,
            fast_mode=args.fast,
            neural_mode=args.neural,
            config=cfg,
            mesh=mesh,
            prescale_hints=tuple(sorted(prescales)),
            device=device,
        )
        # SuperPoint samples its descriptors through K1
        k1_sparse = (record_launches(k1_calls, "sparse_sfm") if args.neural
                     else contextlib.nullcontext())
        with timer.stage("sparse_sfm"), k1_sparse:
            if ckpt and ckpt.restore_sparse(pipeline):
                print("[ckpt] restored sparse reconstruction")
                points = pipeline.points3d.copy()
                colors = pipeline.point_colors.copy()
                pipeline.load_images(str(image_dir), args.max_images)
            else:
                run = pipeline.reconstruct_global if args.global_sfm else pipeline.reconstruct
                points, colors, _ = run(str(image_dir), args.max_images)
                if ckpt:
                    ckpt.save_sparse(pipeline)
            poses = dict(pipeline.poses)
        iset = pipeline.image_set

    save_ply(str(output_dir / "sparse.ply"), points, colors)
    if poses:
        ids = sorted(poses)
        save_cameras_ply(
            str(output_dir / "cameras.ply"),
            stack_poses([CameraPose(R=torch.from_numpy(np.asarray(poses[i][0])),
                                    t=torch.from_numpy(np.asarray(poses[i][1])))
                         for i in ids]),
        )
        np.savez(
            output_dir / "poses.npz",
            image_ids=np.asarray(ids, np.int32),
            Rs=np.stack([np.asarray(poses[i][0]) for i in ids]),
            ts=np.stack([np.asarray(poses[i][1]) for i in ids]),
        )
    print(f"  sparse.ply: {len(points):,} points")
    if args.export_colmap and pipeline is not None:
        pipeline.save_colmap(str(output_dir / "sparse_colmap"))
        print("  sparse_colmap/: COLMAP text model")

    stats = dict(pipeline.stats) if pipeline is not None else {}
    run_dense = (
        (args.mvs or args.stereo or args.dense or args.combined or args.mesh)
        and not args.fast
    )
    if not (run_dense and len(poses) >= 3):
        return stats, points
    camera = iset.camera
    images = iset.color
    # --mesh fuses the depth maps of whichever dense stage ran
    # (plane sweep if --stereo was given without --mvs, else MVS)
    mesh_from_stereo = args.mesh and args.stereo and not args.mvs
    mesh_maps, mesh_cloud = None, None

    if args.mvs or (args.mesh and not mesh_from_stereo):
        from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS

        want_maps = args.mesh and not mesh_from_stereo
        with timer.stage("patchmatch_mvs"), record_launches(k1_calls, "patchmatch_mvs"):
            rec = PatchMatchMVS(camera, cfg.patchmatch, device=device)
            out = rec.reconstruct(
                images, poses, sparse_points=points, checkpointer=ckpt,
                return_maps=want_maps,
                host_small=iset.prescaled.get(round(float(cfg.patchmatch.scale), 6)),
                mesh=mesh,
            )
            dp, dc = out[:2]
            if want_maps:
                mesh_maps, mesh_cloud = out[2], (dp, dc)
                # the stage's own fusion gate, min(min_views, J): with
                # few views the raw min_views count is unreachable
                j = min(cfg.patchmatch.num_source_views, len(poses) - 1)
                mesh_min_conf = float(min(cfg.patchmatch.min_views, j))
        stats["patchmatch_breakdown_s"] = rec.stats
        stats["num_dense_points"] = int(len(dp))
        if len(dp):
            save_ply(str(output_dir / "dense_mvs.ply"), dp, dc)
            print(f"  dense_mvs.ply: {len(dp):,} points")

    if will_stereo:
        from recon3d_tpu_torch.dense.plane_sweep import PlaneSweepReconstructor

        with timer.stage("plane_sweep"), record_launches(k1_calls, "plane_sweep"):
            rec = PlaneSweepReconstructor(camera, cfg.plane_sweep, device=device)
            out = rec.reconstruct(
                images, poses, sparse_points=points, return_maps=mesh_from_stereo,
                host_small=iset.prescaled.get(round(float(cfg.plane_sweep.scale), 6)),
                mesh=mesh,
            )
            dp, dc = out[:2]
            if mesh_from_stereo:
                mesh_maps, mesh_cloud = out[2], (dp, dc)
                # the stage's per-ref gate min(min_views, #neighbours)
                # at its global bound
                j = min(cfg.plane_sweep.num_neighbors, len(poses) - 1)
                mesh_min_conf = float(min(cfg.plane_sweep.min_views, j))
        stats["num_stereo_points"] = int(len(dp))
        if len(dp):
            save_ply(str(output_dir / "dense_stereo.ply"), dp, dc)
            print(f"  dense_stereo.ply: {len(dp):,} points")

    if args.mesh and mesh_maps is not None and len(mesh_cloud[0]):
        from recon3d_tpu_torch.dense.mesh import extract_mesh, mesh_vertex_colors
        from recon3d_tpu_torch.dense.tsdf import fuse_tsdf
        from recon3d_tpu_torch.io.ply import save_mesh_ply

        dp, dc = mesh_cloud
        tsdf_s = {}
        with timer.stage("tsdf_mesh"):
            with record_launches(k1_calls, "tsdf_mesh"):
                vol = fuse_tsdf(
                    mesh_maps["depth"], mesh_maps["conf"],
                    mesh_maps["K"], mesh_maps["Rs"], mesh_maps["ts"],
                    sparse_points=dp,
                    resolution=args.mesh_resolution,
                    # conf counts NCC-consistent views; weight only
                    # pixels the stage's own fusion would keep
                    min_conf=mesh_min_conf,
                    timings=tsdf_s,
                    device=device,
                    mesh=mesh,
                )
            t_mesh = time.perf_counter()
            mv, mf = extract_mesh(vol)
            mc = mesh_vertex_colors(mv, dp, dc, device=device)
            tsdf_s["extract_mesh_s"] = time.perf_counter() - t_mesh
        stats["tsdf_breakdown_s"] = tsdf_s
        stats["mesh_vertices"], stats["mesh_faces"] = int(len(mv)), int(len(mf))
        if len(mf):
            save_mesh_ply(str(output_dir / "mesh.ply"), mv, mf, mc)
            print(f"  mesh.ply: {len(mv):,} verts, {len(mf):,} faces")

    if args.dense or args.combined:
        from recon3d_tpu_torch.dense.sift_dense import DenseSiftReconstructor

        with timer.stage("dense_sift"):
            rec = DenseSiftReconstructor(camera, cfg.dense_sift, device=device)
            dp, dc = rec.reconstruct(images, poses)
        stats["dense_sift_breakdown"] = rec.stats
        stats["num_dense_sift_points"] = int(len(dp))
        if len(dp):
            save_ply(str(output_dir / "dense.ply"), dp, dc)
            print(f"  dense.ply: {len(dp):,} points")
    return stats, points


if __name__ == "__main__":
    sys.exit(main())
