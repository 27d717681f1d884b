"""Smoke test of the PyTorch/CUDA port (recon3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # 5 to 10 minutes on an H100, by the host

Phases, each of which passes or raises:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port, from csrc/, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     every shape the main path gives it (K1 at the 13 shapes of its three
     call sites: PatchMatch, the TSDF lookup, the plane sweep), bit for bit
     in every variant its launch planner can pick there, with times (each
     variant, the plain version, one library call as a yardstick) and the
     least time the card could take; the TSDF shape once more with one
     plane, which shows what a second plane on the same points costs;
  4. small scene: PatchMatchMVS on the card at the settings of
     tests/test_patchmatch.py::test_full_mvs_reconstructor, held to its gate;
  5. dense from known poses: the port's CLI `--mvs --from-colmap` on the
     50-view 480x640 rendered scene (tests/render.py), dense cloud gated
     against the scene's true surfaces at the level the JAX reference
     reaches there (NORTH_STAR_GATE), and a profiled rerun;
  6. sfm_front: the SfM front end (SfMPipeline.load_images ->
     extract_features -> match_image_pairs at the default configuration) on
     the same 50 PNGs, its match graph gated against the scene's true
     epipolar geometry (SFM_FRONT_GATE), run cold, warm and under the
     profiler; then small runs at match_window=2 that enter the long-span
     rematch. Plain PyTorch: the JAX package computes it outside any Pallas
     kernel;
  7. sfm_sparse: the whole sparse reconstruction, SfMPipeline.reconstruct()
     on the same PNGs with the scene's K as calibration, run cold and warm,
     gated on cameras registered, reprojection error and the
     similarity-aligned pose errors against the scene's true poses
     (SFM_SPARSE_GATE), then its back-end stages once more under the
     profiler. Plain PyTorch as well;
  8. cli_images, the main path: the port's CLI `IMAGES --mvs --mesh --stereo
     --export-colmap` on the same PNGs, K1's counts set to 0 just before and
     read just after: SfM at SFM_SPARSE_GATE, the dense cloud in the scene's
     frame at CLI_DENSE_GATE, mesh.ply, dense_stereo.ply and sparse_colmap/
     checked, K1 launched by PatchMatch, the plane sweep and the TSDF, only
     at the kernel phase's shapes, in the variant the planner picks there,
     and its plain version never;
  9. stereo: `--stereo --from-colmap` on the model of the true poses,
     dense_stereo.ply at STEREO_GATE;
 10. the dense stages of the main path once more, each under the profiler
     with its peak of device memory;
 11. dense_sift: the CLI's `--combined --from-colmap` on the model the main
     path exported (the plane sweep and dense SIFT on its SfM cameras),
     dense.ply in the scene's frame at DENSE_SIFT_GATE, with the stage's
     breakdown, match capacity, pair count, peak device memory and the
     k-NN filter's path (native library or scipy);
 12. checkpoint: `IMAGES --mvs --checkpoint-dir` from scratch, again after
     half the depth maps are deleted, again with none left (the sparse
     state restored, every map recomputed), and once more under --profile
     after one batch of maps is deleted: dense_mvs.ply identical across
     the runs, K1's launches by shape in each, and K1's kernel in the
     trace;
 13. rescue: SfMPipeline.reconstruct() on the first 20 views of the 50-view
     parity arc for 8 seeds, the views the rescue pass wins back held to
     the JAX reference's count on the same PNGs (RESCUE_JAX);
 14. dense_sift_budget: match_pairs_batched at dense SIFT's budget, 16
     views of 65,536 random unit descriptors over dense_pairs(16, 8), with
     the JAX package's chunk of 64 pairs and with the chunk
     sift_dense.pair_chunk picks from the free memory: the peak of device
     memory, or the out-of-memory error.

Prints the kernel table as one JSON line, then the card line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero, printing no
result, when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# tests/ has no __init__.py, so an installed package named `tests` would win
# over it: bind the name to the repository's directory (for tests.render
# and tests.torch_scene, which are numpy only).
_tests = types.ModuleType("tests")
_tests.__path__ = [str(REPO / "tests")]
sys.modules["tests"] = _tests

from recon3d_tpu_torch.cli import main as cli_main  # noqa: E402
from recon3d_tpu_torch.io.colmap import load_colmap_text, save_colmap_text  # noqa: E402
from recon3d_tpu_torch.io.ply import load_mesh_ply, load_ply  # noqa: E402
from recon3d_tpu_torch.kernels import warp  # noqa: E402
from tests.render import render_views  # noqa: E402
from tests.torch_scene import (  # noqa: E402
    match_graph_levels, pose_errors, sparse_from_depth, surface_gate, to_scene_frame)

# H100 SXM published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# The north-star scene (scripts/northstar_run.py): 50 views of 480x640.
N_VIEWS, IMAGE_SIZE, ARC_STEP = 50, (480, 640), 0.035
ARC_OFFSET = ARC_STEP * (N_VIEWS - 1) / 2.0
# Surface gate of the north-star dense cloud (median distance, share within
# 0.15). The JAX reference reaches median 0.268-0.271 and share 0.379-0.385
# on this scene at the CLI's settings (seeds 0 and 1, on the CPU:
# tests/torch_reference_levels.py), far from the 0.1 / 0.6 that it passes on
# the small scene; the gate sits 11-13% beyond the reference.
NORTH_STAR_GATE = (0.30, 0.33)

# Gate of the sfm_front phase against the scene's true epipolar geometry:
# every adjacent pair kept, one component, and over the inlier matches of
# all kept non-aux pairs a median Sampson distance under the true F below
# 1.0 px with at least 95% under the RANSAC threshold of 2.0 px. The JAX
# reference on the same PNGs (tests/torch_reference_levels.py, part 4, on
# the CPU) passes it.
SFM_FRONT_GATE = {"median_sampson_px": 1.0, "share_under_threshold": 0.95}
# Gate of the sfm_sparse phase: at least 47 of the 50 cameras and a mean
# reprojection error below 1.5 px (the quality gate of
# scripts/northstar_run.py), and similarity-aligned pose errors against the
# scene's true poses: mean rotation error and mean centre error (scene
# units; the cameras stand about 5 from the scene). The JAX reference on
# the same PNGs on the CPU (tests/torch_reference_levels.py, part 6)
# registers 50 of 50 at 0.5527 px with a mean rotation error of 0.1643 deg
# and a mean centre error of 0.0078: it passes the first two limits as they
# were set, and the pose limits stand at three times its errors.
SFM_SPARSE_GATE = {"min_cameras": 47, "mean_reproj_px": 1.5,
                   "mean_rot_err_deg": 0.5, "mean_center_err": 0.025}
# Gates of the cli_images phase (the main path, `IMAGES --mvs --mesh
# --stereo --export-colmap`): the sparse result at SFM_SPARSE_GATE, and the
# dense cloud, taken into the scene's frame by the SfM cameras
# (tests/torch_scene.to_scene_frame), at the lower of NORTH_STAR_GATE and the
# JAX reference's own level with its SfM cameras: the JAX CLI on the same
# PNGs on the CPU reaches median 0.2786 and share 0.3683
# (tests/torch_reference_levels.py part 8), within NORTH_STAR_GATE, which
# therefore stands. The mesh must hold MESH_MIN_FACES faces (the JAX one
# there: 710,198).
CLI_DENSE_GATE = (0.30, 0.33)
MESH_MIN_FACES = 10_000
# Gate of the stereo run (`--stereo --from-colmap` on the model of the
# true poses): dense_stereo.ply against the true surfaces. The JAX CLI on the
# same PNGs and model on the CPU reaches median 0.0497 and share 0.8637
# (tests/torch_reference_levels.py part 9); the gate sits 20% and 6 points
# beyond.
STEREO_GATE = (0.06, 0.80)
# Gate of the dense_sift phase: dense.ply of `IMAGES --combined
# --from-colmap` on the main path's exported model, carried into the
# scene's frame by its SfM cameras. The JAX CLI's `--dense --from-colmap`
# on the same 50 PNGs, on the CPU (tests/torch_reference_levels.py part
# 12), reaches median 0.0518 and share 0.8689 (38,120 points) with that
# exported model of the port's SfM cameras, and 0.0414 / 0.923 (35,300
# points) with the true poses: the cameras, not the dense stage, cost the
# difference. The gate sits 20% and 6 points beyond the level on the same
# cameras, as STEREO_GATE does beyond its reference.
DENSE_SIFT_GATE = (0.062, 0.81)
# The budget case of dense_sift_budget: dense SIFT's 65,536 keypoints a view
# (DenseSiftConfig.max_features) on 16 views, pairs within 8 views.
BUDGET_VIEWS, BUDGET_KEYPOINTS = 16, 65536
# The rescue phase: the first 20 views of the 50-view parity arc
# (scripts/parity_run.py, arc step 0.06; views 0-9 are edge-on and never
# register, view 10 is starved) at the default configuration with the
# scene's K, for RESCUE_SEEDS. The pass is chaotic there (view 10's best
# re-matched pair holds few matches on near-planar texture): the JAX reference
# on the same PNGs on the CPU (tests/torch_reference_levels.py part 10)
# rescues view 10 or 11 in 6 of the 8 seeds, RESCUE_JAX views in all.
RESCUE_SCENE = dict(n_views=20, image_size=(480, 640), arc_step=0.06,
                    arc_offset=(19 / 2 - 49 / 2) * 0.06)
RESCUE_SEEDS = range(8)
RESCUE_JAX = 6
# The small long-span runs at match_window=2: 12 views of 240x320 on an arc
# wide enough that probe pairs of span >= 4 fail at load resolution and go
# to the 2x rematch (on the CPU none of them reaches min_matches there
# either), and 10 views of 120x160, where the rematched pairs do and are
# then rejected by the homography gate (the scene is made of planes).
LONG_SPAN = [dict(n_views=12, image_size=(240, 320), arc_step=0.2),
             dict(n_views=10, image_size=(120, 160), arc_step=0.12)]

# K1 at every shape the main path gives it: (stage, planes N, H, W, samples
# per plane M, kind of points). PatchMatch: one keep_best evaluation, a batch
# of 4 views x J=4 sources = 16 planes (the last of the 13 batches holds 2
# views, 8 planes), at F candidate fields of the 120x160 fine level (9: 1 +
# 8 propagation shifts, 5: 1 + 4 refinement samples, 1: the final cost) or
# the 30x40 coarse level (13: 1 + 12 shifts, 9: 1 + 8 samples). TSDF: one
# view, its depth and confidence planes sharing the nearest-pixel
# coordinates of all 192^3 voxels (the CLI's --mesh-resolution). Plane
# sweep: every second of the 50 views is a reference view (max_ref_views 20
# gives a stride of 2), 25 x J=6 neighbours = 150 planes, 8 plane
# homographies a chunk at the 60x80 half resolution, then 5 candidate
# fields at 120x160.
K1_SHAPES = [
    ("patchmatch_mvs", 16, 120, 160, 9 * 120 * 160, "fields"),
    ("patchmatch_mvs", 16, 30, 40, 13 * 30 * 40, "fields"),
    ("tsdf_mesh", 2, 120, 160, 192 ** 3, "voxels"),
    ("plane_sweep", 150, 60, 80, 8 * 60 * 80, "fields"),
    ("plane_sweep", 150, 120, 160, 5 * 120 * 160, "fields"),
    ("patchmatch_mvs", 16, 120, 160, 5 * 120 * 160, "fields"),
    ("patchmatch_mvs", 16, 120, 160, 1 * 120 * 160, "fields"),
    ("patchmatch_mvs", 16, 30, 40, 9 * 30 * 40, "fields"),
    ("patchmatch_mvs", 8, 120, 160, 9 * 120 * 160, "fields"),
    ("patchmatch_mvs", 8, 120, 160, 5 * 120 * 160, "fields"),
    ("patchmatch_mvs", 8, 120, 160, 1 * 120 * 160, "fields"),
    ("patchmatch_mvs", 8, 30, 40, 13 * 30 * 40, "fields"),
    ("patchmatch_mvs", 8, 30, 40, 9 * 30 * 40, "fields"),
]
K1_REPLACES = "recon3d_tpu/ops/warp_pallas.py:98"
# Floating-point operations of one bilinear sample: 2 floor, 4 fraction
# subtractions, 8 products, 3 sums.
K1_OPS_PER_SAMPLE = 17


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, prefill: bool = True) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after warm-up.

    prefill: hold the stream with a spin kernel while the host enqueues
    all the calls, so the events time the device's work back to back and
    not the host's launch rate; without it, the time per call is the
    larger of the two, as the main path sees it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(100_000_000)  # ~50 ms at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _special_points(W: int, H: int) -> torch.Tensor:
    nan, inf = float("nan"), float("inf")
    return torch.tensor(
        [[nan, 1.0], [1.0, nan], [inf, 1.0], [-inf, 1.0], [1.0, inf],
         [1.0, -inf], [W - 1, H - 1], [0.0, 0.0], [W - 1, 0.0], [0.0, H - 1],
         [W - 1 + 1e-3, 1.0], [-1e-3, 1.0], [1.0, H - 1 + 1e-3], [W - 1.5, H - 1.5],
         [W, 2.0], [-1.0, 2.0], [2.0, H], [2.0, -1.0]],
        device="cuda",
    )


def k1_inputs(N: int, H: int, W: int, M: int, kind: str, gen: torch.Generator):
    """Planes and M (x, y) points per plane, led by NaN, +-inf, out-of-range
    points, the corners and the exact (W-1, H-1).

    kind "fields": the points of each of the M/(H*W) fields are the pixel
    grid moved by a random shift of up to 10% of the image, scaled by
    0.9-1.1 and jittered by up to half a pixel, as the reprojections of a
    smooth depth field or a plane homography are: neighbouring samples read
    neighbouring texels. Planes in [0, 1].
    kind "voxels": the TSDF lookup. One set of points for all N planes
    (coords (1, M, 2)): the nearest-pixel coordinates of a 192^3 voxel grid
    over the scene's box seen by a north-star camera at the working scale,
    through the port's own projection (dense/tsdf.py); planes of depths in
    [3, 4.5] with 20% holes (0) and of confidence counts 0-4.
    kind "uniform": uniform points over a margin around the image (every
    tap a cache miss of its own), in the coordinate layout of `shared`."""
    dev = "cuda"
    if kind == "voxels":
        from recon3d_tpu_torch.dense.tsdf import tsdf_view_coords, voxel_centers

        n = round(M ** (1 / 3))
        depth = 3.0 + 1.5 * torch.rand((H, W), generator=gen, device=dev)
        depth = torch.where(torch.rand((H, W), generator=gen, device=dev) < 0.2, 0.0, depth)
        conf = torch.randint(0, 5, (H, W), generator=gen, device=dev).to(torch.float32)
        planes = torch.stack([depth, conf])
        X = voxel_centers(torch.full((3,), -1.6, device=dev), 3.2 / (n - 1), n)
        f = 0.9 * W
        K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], device=dev)
        th = 0.5
        C = torch.tensor([3.5 * math.sin(th), -0.3, -3.5 * math.cos(th)], device=dev)
        z = -C / C.norm()
        x = torch.linalg.cross(torch.tensor([0.0, -1.0, 0.0], device=dev), z)
        x = x / x.norm()
        R = torch.stack([x, torch.linalg.cross(z, x), z])
        _, uv = tsdf_view_coords(X, K, R, -R @ C)
        coords = uv[None].contiguous()
    else:
        planes = torch.rand((N, H, W), generator=gen, device=dev)
        if kind == "fields":
            F = M // (H * W)
            ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                    torch.arange(W, device=dev, dtype=torch.float32),
                                    indexing="ij")
            a = torch.rand((N, F, 1, 1, 3), generator=gen, device=dev) * 2 - 1
            sc = 1.0 + 0.1 * a[..., 0]
            x = xs * sc + 0.1 * W * a[..., 1]
            y = ys * sc + 0.1 * H * a[..., 2]
            x = (x + torch.rand(x.shape, generator=gen, device=dev) - 0.5).reshape(N, M)
            y = (y + torch.rand(y.shape, generator=gen, device=dev) - 0.5).reshape(N, M)
        else:
            x = torch.rand((N, M), generator=gen, device=dev) * (W + 3) - 2
            y = torch.rand((N, M), generator=gen, device=dev) * (H + 3) - 2
        coords = torch.stack([x, y], dim=-1)
    special = _special_points(W, H)
    coords[:, : len(special)] = special
    return planes, coords.contiguous()


def k1_bytes(N: int, H: int, W: int, Nc: int, M: int) -> int:
    """K1's byte count: each input read once (planes, coordinates), each
    output written once (samples 4 B per plane and point, validity 1 B per
    point of each coordinate row: shared points have one validity row)."""
    return N * H * W * 4 + Nc * M * (8 + 1) + N * M * 4


def k1_library_call(planes, coords):
    """grid_sample on K1's work, K1's yardstick: the same planes and points
    (shared points: the N planes as the channels of one image)."""
    N, H, W = planes.shape
    gx = 2.0 * coords[..., 0] / (W - 1) - 1.0
    gy = 2.0 * coords[..., 1] / (H - 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[:, None]          # (Nc, 1, M, 2)
    img = planes[None] if coords.shape[0] == 1 else planes[:, None]
    return lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True)


def check_k1(planes, coords, what: str, variant=None):
    """K1 (the planner's variant, or the one named) against its plain
    version on the card: bit-identical samples and validity, and both valid
    and invalid points present."""
    out, valid = warp.tent_warp(planes, coords, variant=variant)
    ref, ref_valid = warp.tent_warp_reference(planes, coords)
    torch.cuda.synchronize()
    what = f"{what}, variant {variant or warp.plan_for(planes, coords).variant}"
    if not torch.equal(valid, ref_valid):
        raise AssertionError(f"K1 valid differs from the plain version on {what}")
    if not torch.equal(out, ref):
        err = float((out - ref).abs().max())
        raise AssertionError(f"K1 is not bit-identical to its plain version on {what} "
                             f"(max |err| {err})")
    n_invalid = int((~valid).sum())
    if n_invalid == 0 or n_invalid == valid.numel():
        raise AssertionError(f"K1 inputs must hold valid and invalid points ({what})")
    return 0.0, n_invalid


def k1_variants(planes, coords, coords_u, what: str) -> dict:
    """Every variant that can take this shape, held bit for bit to the plain
    version on the main path's points and on uniform ones, and timed on
    the main path's: {variant: ms}."""
    N, H, W = planes.shape
    out = {}
    for v in warp.variants_for(N, H, W, coords.shape[0], warp.device_limits(planes.device)):
        check_k1(planes, coords_u, what + " (uniform)", v)
        check_k1(planes, coords, what, v)
        out[v] = cuda_ms(lambda: warp.tent_warp(planes, coords, variant=v), 200)
    return out


def k1_bound(N: int, H: int, W: int, Nc: int, M: int) -> dict:
    n_bytes = k1_bytes(N, H, W, Nc, M)
    n_ops = N * M * K1_OPS_PER_SAMPLE
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def kernel_phase() -> list:
    """K1 at each shape of K1_SHAPES, on the main path's kind of points and
    on uniform ones, in every variant the planner can pick there; timed on
    the main path's kind. At the TSDF shape, the same points once more with
    one plane (N = 1), which shows whether a second plane costs a second
    read of the coordinates."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for stage, N, H, W, M, kind in K1_SHAPES:
        what = f"{stage}: {N}x{H}x{W} planes, {M} points each"
        shared = kind == "voxels"
        planes, coords = k1_inputs(N, H, W, M, kind, gen)
        coords_u = k1_inputs(1 if shared else N, H, W, M, "uniform", gen)[1]
        plan = warp.plan_for(planes, coords)
        variant_ms = k1_variants(planes, coords, coords_u, what)
        ms_uniform = cuda_ms(lambda: warp.tent_warp(planes, coords_u), 200)
        del coords_u
        err, n_invalid = check_k1(planes, coords, f"{what} ({kind})")

        def k1():
            return warp.tent_warp(planes, coords)

        ms = cuda_ms(k1, 200)
        issue_ms = cuda_ms(k1, 200, prefill=False)
        plain_ms = cuda_ms(lambda: warp.tent_warp_reference(planes, coords), 20)
        library_ms = cuda_ms(k1_library_call(planes, coords), 200)
        bound = k1_bound(N, H, W, coords.shape[0], M)
        shapes.append({
            "stage": stage, "shape_key": warp.shape_key(planes, coords),
            "planes": [N, H, W], "samples_per_plane": M,
            "shared_points": shared, "invalid": n_invalid,
            "variant": plan.variant, "plan": vars(plan), "variant_ms": variant_ms,
            "max_abs_err": err, "ms": ms, "issue_ms": issue_ms,
            "ms_uniform_points": ms_uniform,
            "plain_ms": plain_ms, "library_ms": library_ms, **bound,
        })
        print(f"[kernels] tent_warp on {what}: bit-identical to its plain version in "
              f"every variant ({', '.join(f'{v} {t:.4f}' for v, t in variant_ms.items())} "
              f"ms); the planner's {plan.variant} (vec {plan.vec}): {ms:.4f} ms on the device "
              f"({ms_uniform:.4f} on uniform points), {issue_ms:.4f} ms a call issued "
              f"back to back; plain {plain_ms:.4f}, grid_sample {library_ms:.4f} "
              f"(K1/grid_sample {ms / library_ms:.2f}), bound {bound['bound_ms']:.4f} "
              f"by {bound['bound_by']} ({100 * bound['bound_ms'] / ms:.0f}% of it)",
              flush=True)
        if shared:
            one = planes[:1].contiguous()
            n1 = {"ms": cuda_ms(lambda: warp.tent_warp(one, coords), 200),
                  "variant": warp.plan_for(one, coords).variant,
                  "variant_ms": {v: cuda_ms(lambda: warp.tent_warp(one, coords, variant=v), 200)
                                 for v in warp.variants_for(1, H, W, 1)},
                  **k1_bound(1, H, W, 1, M)}
            check_k1(one, coords, f"{what} (one plane)")
            shapes[-1]["one_plane"] = n1
            print(f"[kernels] tent_warp on {what}, one plane: {n1['ms']:.4f} ms "
                  f"({n1['variant']}; "
                  + ", ".join(f"{v} {t:.4f}" for v, t in n1["variant_ms"].items())
                  + f"); two planes / one plane {ms / n1['ms']:.2f}; bound "
                  f"{n1['bound_ms']:.4f} ({100 * n1['bound_ms'] / n1['ms']:.0f}% of it)",
                  flush=True)
            del one
        del planes, coords
    return shapes


def gate(points: np.ndarray, max_median: float, min_share: float, what: str):
    """tests.torch_scene.surface_gate, held to its bounds: raises unless
    there are 3000 finite points, median < max_median and share >
    min_share."""
    if not (points.ndim == 2 and points.shape[1] == 3 and np.isfinite(points).all()):
        raise AssertionError(f"{what}: non-finite or malformed points")
    med, share = surface_gate(points)
    print(f"[{what}] {len(points)} dense points; median distance to the true "
          f"surface {med:.4f} (gate < {max_median}), share within 0.15 "
          f"{share:.4f} (gate > {min_share})", flush=True)
    if len(points) < 3000 or not med < max_median or not share > min_share:
        raise AssertionError(f"{what}: dense cloud fails the surface gate")
    return med, share


def small_scene_check() -> None:
    """The port's PatchMatchMVS on the card at the size and settings of
    tests/test_patchmatch.py::test_full_mvs_reconstructor (5 views of 96x128,
    full resolution, 4 rounds, 7x7 windows), held to that test's gate,
    which the JAX reference passes there."""
    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.config import PatchMatchConfig
    from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS

    scene = render_views(n_views=5, image_size=(96, 128), arc_step=0.12)
    cfg = PatchMatchConfig(scale=1.0, num_iterations=4, patch_size=7,
                           min_views=3, voxel_size=0.01)
    rec = PatchMatchMVS(Camera.from_matrix(scene["K"]), cfg, device="cuda")
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(5)}
    points, _ = rec.reconstruct(
        scene["images"], poses,
        sparse_points=sparse_from_depth(scene, per_view=300, views=[2]))
    gate(points, 0.1, 0.6, "small scene")


def render_north_star(work: Path) -> dict:
    """The north-star scene as PNGs in work/images and a COLMAP model of
    its true poses in work/model; returns the scene (with K, Rs, ts)."""
    from PIL import Image

    t0 = time.perf_counter()
    scene = render_views(n_views=N_VIEWS, image_size=IMAGE_SIZE,
                         arc_step=ARC_STEP, arc_offset=ARC_OFFSET)
    img_dir = work / "images"
    img_dir.mkdir()
    names = [f"view_{i:03d}.png" for i in range(N_VIEWS)]
    for name, img in zip(names, scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
    np.savez(work / "calibration.npz", mtx=np.asarray(scene["K"], np.float64),
             dist=np.zeros(5))
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(N_VIEWS)}
    save_colmap_text(str(work / "model"), scene["K"], IMAGE_SIZE, poses,
                     sparse_from_depth(scene, per_view=100), None, names=names)
    print(f"[main] rendered {N_VIEWS} views of {IMAGE_SIZE} and their COLMAP "
          f"model in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    return scene


def main_path(work: Path, card: str) -> dict:
    img_dir = work / "images"
    out, stats_path = work / "recon", work / "stats.json"
    warp.counts.reset()
    t0 = time.perf_counter()
    rc = cli_main([str(img_dir), "--mvs", "--from-colmap", str(work / "model"),
                   "--output", str(out), "--stats-json", str(stats_path),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    if launches == 0 or plain_calls != 0:
        raise AssertionError(
            f"main path: K1 launched {launches} times, plain version {plain_calls}")

    stats = json.loads(stats_path.read_text())
    points, colors = load_ply(str(out / "dense_mvs.ply"))
    if colors is None or colors.shape != points.shape:
        raise AssertionError("dense_mvs.ply: colours missing or malformed")
    med, frac = gate(points, *NORTH_STAR_GATE, "main")

    stages = stats["stage_times_s"]
    pm = stages["patchmatch_mvs"]
    mpix = N_VIEWS * IMAGE_SIZE[0] * IMAGE_SIZE[1] / 1e6
    print(f"[main] on {card}: wall {wall:.3f} s; stages (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + "; patchmatch breakdown (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stats["patchmatch_breakdown_s"].items())
          + f"; {len(points) / pm:.1f} dense points/s and {mpix / pm:.3f} MP/s of "
          f"input through patchmatch_mvs; K1 launches {launches}", flush=True)
    argv = [str(img_dir), "--mvs", "--from-colmap", str(work / "model"),
            "--output", str(work / "recon_profiled"), "--device", "cuda"]
    profile_run(lambda: cli_main(argv), wall, "main path", "tent_warp", top=8)
    return {"launches": launches, "points": len(points), "median": med,
            "share": frac, "wall_s": wall, "stages_s": stages,
            "patchmatch_breakdown_s": stats["patchmatch_breakdown_s"]}


def profile_run(fn, wall: float, what: str, highlight: str = "", top: int = 5) -> dict:
    """Run fn() once more under torch.profiler: device time by kernel, the
    device's busy and idle share of `wall` (the unprofiled run's time: the
    profiler slows the host several times), the `top` operations with most
    device time, and the share of the kernels whose name holds `highlight`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return summarize_profiles([prof], wall, what, highlight, top)


class _Op:
    """Device time and count of one operation, summed over profiles."""

    def __init__(self, key):
        self.key, self.self_device_time_total, self.count = key, 0.0, 0


def summarize_profiles(profs, wall: float, what: str, highlight: str = "",
                       top: int = 5) -> dict:
    """The device-side summary of one or more torch.profiler runs against
    `wall` seconds of unprofiled time (see profile_run)."""
    ops = {}
    for prof in profs:
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                op = ops.setdefault(e.key, _Op(e.key))
                op.self_device_time_total += e.self_device_time_total
                op.count += e.count
    events = list(ops.values())
    if not events:
        print(f"[profile] {what}: the profiler recorded no device time: not measured")
        return {}
    busy = sum(e.self_device_time_total for e in events) / 1e6
    n_kernels = sum(e.count for e in events)
    line = (f"[profile] {what} under the profiler: device busy {busy:.4f} s in "
            f"{n_kernels} kernels and copies, {100 * busy / wall:.1f}% of the "
            f"unprofiled run's {wall:.3f} s (idle {100 * (1 - busy / wall):.1f}%)")
    if highlight:
        hl = [e for e in events if highlight in e.key]
        hl_s = sum(e.self_device_time_total for e in hl) / 1e6
        line += (f"; {highlight} {hl_s:.4f} s in {sum(e.count for e in hl)} launches "
                 f"({100 * hl_s / busy:.1f}% of device time)")
    print(line + "; top (s):")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    for e in ranked:
        print(f"[profile]   {e.self_device_time_total / 1e6:8.4f}  x{e.count:<6d} "
              f"{e.key[:90]}")
    return {"device_busy_s": busy, "kernels": n_kernels,
            "idle_share": 1 - busy / wall,
            "top": [[e.key[:90], e.self_device_time_total / 1e6, e.count] for e in ranked]}


def run_front(img_dir: Path) -> dict:
    """Stages 1-3 of the port's SfMPipeline on `img_dir` at the default
    configuration on the card, each stage timed to a device sync with its
    own peak of allocated device memory."""
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    pipe = SfMPipeline(config=ReconstructionConfig(), device="cuda")
    times, peaks = {}, {}
    for stage, fn in (("load_images", lambda: pipe.load_images(str(img_dir))),
                      ("extract_features", pipe.extract_features),
                      ("match_image_pairs", pipe.match_image_pairs)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[stage] = time.perf_counter() - t0
        peaks[stage] = torch.cuda.max_memory_allocated()
    return {"pipe": pipe, "seconds": times, "peak_bytes": peaks}


def sfm_front(work: Path, scene: dict, card: str) -> dict:
    """The sfm_front phase: cold run (gated), warm run (the times kept),
    profiled rerun, then the small long-span run."""
    img_dir = work / "images"
    warp.counts.reset()
    cold = run_front(img_dir)
    pipe = cold["pipe"]
    if pipe.features_stacked.desc.device.type != "cuda":
        raise AssertionError("sfm_front: the features are not on the card")
    counts = pipe.stats["features_per_image"]
    levels = match_graph_levels(pipe.matches, pipe.kp_xy, scene,
                                len(pipe._components(N_VIEWS)),
                                pipe.config.match.ransac_threshold_px)
    del pipe
    warm = run_front(img_dir)
    stats = warm["pipe"].stats
    report = {
        "phase": "sfm_front", "card": card,
        "views": N_VIEWS, "image_size": list(IMAGE_SIZE),
        "features_per_image": {"mean": float(np.mean(counts)), "min": int(min(counts)),
                               "max": int(max(counts))},
        "selection_capacity": stats["selection_capacity"],
        "candidate_pairs": stats["num_candidate_pairs"],
        "pairs_kept": levels["pairs_kept"],
        "seconds_cold": cold["seconds"], "seconds": warm["seconds"],
        "extract_detail_s": stats["extract_detail_s"],
        "match_detail_s": stats["match_detail_s"],
        "peak_device_bytes": warm["peak_bytes"],
        "levels": levels,
        "port_kernel_launches": warp.counts.kernel + warp.counts.plain,
    }
    print(json.dumps(report), flush=True)

    failed = []
    if levels["adjacent_kept"] != levels["adjacent_total"]:
        failed.append("an adjacent pair was dropped")
    if levels["components"] != 1:
        failed.append(f"{levels['components']} components")
    if not levels["median_sampson_px"] < SFM_FRONT_GATE["median_sampson_px"]:
        failed.append("median Sampson distance under the true F")
    if not levels["share_under_threshold"] >= SFM_FRONT_GATE["share_under_threshold"]:
        failed.append("share of inlier matches under the threshold")
    if warm["pipe"].stats["num_pairs"] != levels["pairs_kept"]:
        failed.append("the warm run kept another number of pairs than the cold one")
    if failed:
        raise AssertionError("sfm_front fails its gate: " + "; ".join(failed))

    seconds = warm["seconds"]
    del warm

    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.dataset import load_image_set
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    # The profiled rerun, stage by stage, against the warm run's times.
    p = SfMPipeline(config=ReconstructionConfig(), device="cuda")
    p.set_image_set(load_image_set(str(img_dir), device="cuda"))
    prof = {stage: profile_run(getattr(p, stage), seconds[stage], f"sfm_front {stage}")
            for stage in ("extract_features", "match_image_pairs")}
    if all(prof.values()):
        busy = sum(v["device_busy_s"] for v in prof.values())
        wall = seconds["extract_features"] + seconds["match_image_pairs"]
        print(f"[profile] sfm_front, both stages: device busy {busy:.4f} s in "
              f"{sum(v['kernels'] for v in prof.values())} kernels and copies, "
              f"{100 * busy / wall:.1f}% of the warm run's {wall:.3f} s "
              f"(idle {100 * (1 - busy / wall):.1f}%)", flush=True)
    report["profile"] = prof
    report["long_span"] = long_span_run()
    return report


class _StageClock:
    """Wraps methods of one SfMPipeline so that each call is timed to a
    device sync and records the peak of allocated device memory, summed
    and maxed by stage name."""

    def __init__(self, pipe, stages):
        self.seconds = {s: 0.0 for s in stages}
        self.peak_bytes = {s: 0 for s in stages}
        self.calls = {s: 0 for s in stages}
        for name in stages:
            setattr(pipe, name, self._wrap(name, getattr(pipe, name)))

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.peak_bytes[name] = max(self.peak_bytes[name], torch.cuda.max_memory_allocated())
            self.calls[name] += 1
            return out
        return timed


SPARSE_STAGES = ("find_best_initial_pair", "_register_wave", "_triangulate_images",
                 "bundle_adjustment_light", "bundle_adjustment_full")


def sparse_pipeline(work: Path):
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    return SfMPipeline(calibration_path=str(work / "calibration.npz"),
                       config=ReconstructionConfig(), device="cuda")


def run_sparse(work: Path) -> dict:
    """SfMPipeline.reconstruct() on the north-star PNGs at the default
    configuration on the card. The back end's stages are timed one by one
    as well, with a device sync around each call (the pipeline's own stage
    times in `stats` include the few milliseconds those syncs cost)."""
    pipe = sparse_pipeline(work)
    clock = _StageClock(pipe, SPARSE_STAGES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    points, colors, poses = pipe.reconstruct(str(work / "images"))
    torch.cuda.synchronize()
    return {"pipe": pipe, "clock": clock, "wall_s": time.perf_counter() - t0,
            "points": points, "colors": colors, "poses": poses}


def sfm_sparse(work: Path, scene: dict, card: str) -> dict:
    """The sfm_sparse phase: cold run, warm run (gated, its times kept),
    then a third run with the back end's stages under the profiler."""
    warp.counts.reset()
    cold = run_sparse(work)
    cold_stats = cold["pipe"].stats
    del cold["pipe"]
    warm = run_sparse(work)
    pipe, clock, st = warm["pipe"], warm["clock"], warm["pipe"].stats
    points, colors, poses = warm["points"], warm["colors"], warm["poses"]
    errs = pose_errors(pipe.poses, scene)
    times = ("load_time", "extract_time", "match_time", "init_time", "incremental_time",
             "final_ba_time", "total_time")
    ba = st["ba_full_detail_s"]
    report = {
        "phase": "sfm_sparse", "card": card, "views": N_VIEWS, "image_size": list(IMAGE_SIZE),
        "num_cameras": st["num_cameras"], "num_points": st["num_points"],
        "mean_reproj_px": st["mean_reproj_px"],
        "unregistered": sorted(set(range(N_VIEWS)) - set(pipe.registered)),
        "pose_errors": errs,
        "seconds": {k: st[k] for k in times},
        "seconds_cold": {k: cold_stats[k] for k in times},
        "wall_s": warm["wall_s"], "wall_cold_s": cold["wall_s"],
        "incremental_breakdown_s": st["incremental_breakdown_s"],
        "register_detail_s": st["register_detail_s"],
        "ba_full_detail_s": ba,
        "waves": st["register_detail_s"]["waves"],
        "lm_iterations": ba["iterations"],
        "stage_seconds_synced": clock.seconds, "stage_calls": clock.calls,
        "stage_peak_device_bytes": clock.peak_bytes,
        "cold": {"num_cameras": cold_stats["num_cameras"], "num_points": cold_stats["num_points"],
                 "mean_reproj_px": cold_stats["mean_reproj_px"],
                 "waves": cold_stats["register_detail_s"]["waves"]},
        "port_kernel_launches": warp.counts.kernel + warp.counts.plain,
    }
    print(json.dumps(report), flush=True)

    failed = []
    if not (points.ndim == 2 and points.shape[1] == 3 and points.dtype == np.float32
            and np.isfinite(points).all() and colors.shape == points.shape
            and colors.dtype == np.uint8):
        failed.append("points or colours malformed or not finite")
    if sorted(poses) != sorted(pipe.registered) or not all(
            bool(torch.isfinite(p.R).all() and torch.isfinite(p.t).all()) for p in poses.values()):
        failed.append("poses malformed or not finite")
    if st["num_cameras"] < SFM_SPARSE_GATE["min_cameras"]:
        failed.append(f"{st['num_cameras']} cameras registered")
    if not st["mean_reproj_px"] < SFM_SPARSE_GATE["mean_reproj_px"]:
        failed.append("mean reprojection error")
    for key in ("mean_rot_err_deg", "mean_center_err"):
        if not errs[key] < SFM_SPARSE_GATE[key]:
            failed.append(key)
    if failed:
        raise AssertionError("sfm_sparse fails its gate: " + "; ".join(failed))
    del warm, pipe

    # The profiled rerun: every call of a back-end stage under its own
    # profile, summed by stage name, against the warm run's synced stage
    # times (the front end of this run is not profiled: sfm_front did).
    # Device activity only: with the host's operators recorded as well,
    # the 200,000 launches of the back end take minutes to profile.
    from torch.profiler import ProfilerActivity, profile

    third = sparse_pipeline(work)
    profs = {}

    def under(name, fn):
        def run(*args, **kwargs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            profs.setdefault(name, []).append(prof)
            return out
        return run

    for name in SPARSE_STAGES:
        setattr(third, name, under(name, getattr(third, name)))
    third.reconstruct(str(work / "images"))
    report["profile"] = {
        name: summarize_profiles(profs.get(name, []), clock.seconds[name], f"sfm_sparse {name}")
        for name in SPARSE_STAGES}
    measured = [v for v in report["profile"].values() if v]
    if measured:
        busy = sum(v["device_busy_s"] for v in measured)
        wall = sum(clock.seconds.values())
        print(f"[profile] sfm_sparse, init + waves + BA: device busy {busy:.4f} s in "
              f"{sum(v['kernels'] for v in measured)} kernels and copies, "
              f"{100 * busy / wall:.1f}% of the warm run's {wall:.3f} s in those stages "
              f"(idle {100 * (1 - busy / wall):.1f}%)", flush=True)
    return report


def long_span_run() -> list:
    """Small scenes at match_window=2: failed probe pairs of span >= 4 go
    through SfMPipeline._rematch_long_span (which returns at once above
    320 px, so the full-width run never enters it)."""
    import dataclasses

    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.io.dataset import image_set_from_arrays
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    cfg = ReconstructionConfig()
    cfg = cfg.replace(sfm=dataclasses.replace(cfg.sfm, match_window=2))
    outs = []
    for scene_kw in LONG_SPAN:
        scene = render_views(**scene_kw)
        pipe = SfMPipeline(config=cfg, device="cuda")
        pipe.set_image_set(image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"])))
        pipe.extract_features()
        pipe.match_image_pairs()
        torch.cuda.synchronize()
        out = {k: pipe.stats[k] for k in ("rematch_attempted", "rematch_recovered",
                                          "rematch_rejected", "num_pairs",
                                          "num_candidate_pairs")}
        out["components"] = len(pipe._components(scene_kw["n_views"]))
        print(f"[long span] {scene_kw['n_views']} views of {scene_kw['image_size']}: "
              f"{json.dumps(out)}", flush=True)
        if out["rematch_attempted"] == 0:
            raise AssertionError("long-span run: no failed probe pair reached the rematch")
        outs.append(out)
    return outs


def read_poses(path: Path) -> dict:
    p = np.load(path)
    return {int(i): (R, t) for i, R, t in zip(p["image_ids"], p["Rs"], p["ts"])}


def check_mesh(path: Path, what: str) -> dict:
    """mesh.ply: at least MESH_MIN_FACES faces, finite vertices with a
    colour each, every face three distinct indices of existing vertices."""
    verts, faces, cols = load_mesh_ply(str(path))
    if not (len(faces) >= MESH_MIN_FACES and np.isfinite(verts).all()
            and cols is not None and cols.shape == verts.shape
            and faces.min() >= 0 and faces.max() < len(verts)
            and (faces[:, 0] != faces[:, 1]).all() and (faces[:, 1] != faces[:, 2]).all()
            and (faces[:, 0] != faces[:, 2]).all()):
        raise AssertionError(f"{what}: mesh.ply malformed or too small "
                             f"({len(verts)} vertices, {len(faces)} faces)")
    return {"vertices": len(verts), "faces": len(faces)}


def cli_images(work: Path, scene: dict, card: str) -> dict:
    """The main path: the port's CLI on the north-star PNGs with SfM in
    front, `IMAGES --mvs --mesh --stereo --export-colmap --calibration K
    --stats-json`, K1's counts set to 0 just before and read just after.
    Gated: the sparse result at SFM_SPARSE_GATE from poses.npz against the
    true poses, dense_mvs.ply at CLI_DENSE_GATE in the scene's frame, a
    well-formed mesh.ply and dense_stereo.ply, sparse_colmap/ read back to
    the poses of poses.npz, K1 launched in every dense stage (the TSDF once
    a view) and its plain version never."""
    out, stats_path = work / "cli_images", work / "cli_images.json"
    argv = [str(work / "images"), "--mvs", "--mesh", "--stereo", "--export-colmap",
            "--calibration", str(work / "calibration.npz"), "--output", str(out),
            "--stats-json", str(stats_path), "--device", "cuda"]
    torch.cuda.synchronize()
    warp.counts.reset()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    if rc != 0:
        raise AssertionError(f"cli_images: CLI returned {rc}")
    st = json.loads(stats_path.read_text())
    poses = read_poses(out / "poses.npz")
    errs = pose_errors(poses, scene)
    dense, dcols = load_ply(str(out / "dense_mvs.ply"))
    if dcols is None or dcols.shape != dense.shape:
        raise AssertionError("cli_images: dense_mvs.ply colours missing or malformed")
    med, share = gate(to_scene_frame(dense, poses, scene), *CLI_DENSE_GATE,
                      "cli_images dense_mvs.ply, SfM cameras")
    stereo, _ = load_ply(str(out / "dense_stereo.ply"))
    stereo_med, stereo_share = surface_gate(to_scene_frame(stereo, poses, scene))
    mesh = check_mesh(out / "mesh.ply", "cli_images")
    model = load_colmap_text(str(out / "sparse_colmap"))
    by_name = {im.name: im for im in model.images.values()}
    for i, (R, t) in poses.items():
        im = by_name[f"view_{i:03d}.png"]
        if not (np.abs(im.R() - R).max() < 1e-5 and np.abs(im.t - t).max() < 1e-5):
            raise AssertionError(f"cli_images: sparse_colmap pose of view {i} differs")
    k1 = st["k1_calls_by_stage"]
    report = {
        "phase": "cli_images", "card": card, "wall_s": wall,
        "num_cameras": st["num_cameras"], "num_points": st["num_points"],
        "mean_reproj_px": st["mean_reproj_px"], "pose_errors": errs,
        "stage_times_s": st["stage_times_s"],
        "sparse_seconds": {k: st[k] for k in ("load_time", "extract_time", "match_time",
                                              "init_time", "incremental_time",
                                              "final_ba_time", "total_time")},
        "patchmatch_breakdown_s": st["patchmatch_breakdown_s"],
        "tsdf_breakdown_s": st["tsdf_breakdown_s"],
        "dense_points": len(dense), "dense_median": med, "dense_share": share,
        "stereo_points": len(stereo), "stereo_median": stereo_med,
        "stereo_share": stereo_share, "mesh": mesh,
        "colmap_images": len(model.images), "colmap_points": len(model.points),
        "k1_launches": launches, "k1_plain_calls": plain_calls, "k1_by_stage": k1,
    }
    print(json.dumps(report), flush=True)
    failed = []
    if st["num_cameras"] < SFM_SPARSE_GATE["min_cameras"]:
        failed.append(f"{st['num_cameras']} cameras registered")
    if not st["mean_reproj_px"] < SFM_SPARSE_GATE["mean_reproj_px"]:
        failed.append("mean reprojection error")
    for key in ("mean_rot_err_deg", "mean_center_err"):
        if not errs[key] < SFM_SPARSE_GATE[key]:
            failed.append(key)
    if len(model.images) != st["num_cameras"] or len(model.points) != st["num_sparse_points"]:
        failed.append("sparse_colmap does not hold the sparse model")
    if not (len(stereo) >= 3000 and np.isfinite(stereo).all()):
        failed.append("dense_stereo.ply")
    if plain_calls != 0 or launches != sum(v["kernel"] for v in k1.values()):
        failed.append(f"K1 plain version called {plain_calls} times")
    for stage in ("patchmatch_mvs", "plane_sweep", "tsdf_mesh"):
        if k1.get(stage, {}).get("kernel", 0) == 0:
            failed.append(f"K1 never launched in {stage}")
    if k1["tsdf_mesh"]["kernel"] != st["num_cameras"]:
        failed.append("the TSDF stage did not launch K1 once a view")
    if failed:
        raise AssertionError("cli_images fails its gate: " + "; ".join(failed))
    return report


def stereo_run(work: Path, card: str) -> dict:
    """The CLI's `--stereo --from-colmap` on the model of the true poses:
    dense_stereo.ply held to STEREO_GATE, K1 launched by the sweep and its
    plain version never."""
    out, stats_path = work / "stereo", work / "stereo.json"
    torch.cuda.synchronize()
    warp.counts.reset()
    rc = cli_main([str(work / "images"), "--stereo", "--from-colmap",
                   str(work / "model"), "--output", str(out), "--stats-json",
                   str(stats_path), "--device", "cuda"])
    torch.cuda.synchronize()
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    if rc != 0:
        raise AssertionError(f"stereo run: CLI returned {rc}")
    st = json.loads(stats_path.read_text())
    points, _ = load_ply(str(out / "dense_stereo.ply"))
    med, share = gate(points, *STEREO_GATE, "stereo run dense_stereo.ply")
    k1 = st["k1_calls_by_stage"]
    report = {"phase": "stereo", "card": card, "stage_times_s": st["stage_times_s"],
              "stereo_points": len(points), "median": med, "share": share,
              "k1_launches": launches, "k1_plain_calls": plain_calls, "k1_by_stage": k1}
    print(json.dumps(report), flush=True)
    if plain_calls != 0 or k1.get("plane_sweep", {}).get("kernel", 0) == 0:
        raise AssertionError(f"stereo run: K1 by stage {k1}, plain calls {plain_calls}")
    return report


def dense_profile(work: Path, images: dict) -> dict:
    """The dense stages of the main path once more, `--mvs --mesh --stereo
    --from-colmap` on the model the main path exported (its SfM cameras and
    points), each stage call under a device-only profiler and with its peak
    of allocated device memory; device busy against the main path's
    unprofiled stage times."""
    from torch.profiler import ProfilerActivity, profile

    from recon3d_tpu_torch.dense import patchmatch, plane_sweep, tsdf

    targets = {
        "patchmatch_mvs": (patchmatch.PatchMatchMVS, "reconstruct"),
        "plane_sweep": (plane_sweep.PlaneSweepReconstructor, "reconstruct"),
        "tsdf_mesh": (tsdf, "fuse_tsdf"),
    }
    profs, peaks, saved = {}, {}, {}

    def under(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
            profs.setdefault(name, []).append(prof)
            return out
        return run

    for name, (owner, attr) in targets.items():
        saved[name] = getattr(owner, attr)
        setattr(owner, attr, under(name, saved[name]))
    try:
        rc = cli_main([str(work / "images"), "--mvs", "--mesh", "--stereo", "--from-colmap",
                       str(work / "cli_images" / "sparse_colmap"), "--output",
                       str(work / "dense_profiled"), "--device", "cuda"])
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, saved[name])
    if rc != 0:
        raise AssertionError(f"dense profile: CLI returned {rc}")
    walls = images["stage_times_s"]
    out = {name: summarize_profiles(profs.get(name, []), walls[name], f"cli_images {name}")
           for name in targets}
    for name in targets:
        print(f"[profile] cli_images {name}: peak allocated device memory "
              f"{peaks.get(name, 0) / 1e9:.3f} GB", flush=True)
        if out[name]:
            out[name]["peak_bytes"] = peaks.get(name, 0)
    return out


def dense_sift_phase(work: Path, scene: dict, card: str) -> dict:
    """The CLI's `--combined --from-colmap` on the model the main path
    exported, K1's counts set to 0 just before and read just after:
    dense.ply in the scene's frame at DENSE_SIFT_GATE, dense_stereo.ply
    written, the plane sweep's K1 launches; dense SIFT's breakdown and its
    own peak of allocated device memory."""
    from recon3d_tpu_torch.dense import sift_dense
    from recon3d_tpu_torch.runtime.native import native_available

    out, stats_path = work / "dense_sift", work / "dense_sift.json"
    inner = sift_dense.DenseSiftReconstructor.reconstruct
    peak = {}

    def measured(self, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        peak["bytes"] = torch.cuda.max_memory_allocated()
        return result

    sift_dense.DenseSiftReconstructor.reconstruct = measured
    try:
        torch.cuda.synchronize()
        warp.counts.reset()
        t0 = time.perf_counter()
        rc = cli_main([str(work / "images"), "--combined", "--from-colmap",
                       str(work / "cli_images" / "sparse_colmap"), "--output", str(out),
                       "--stats-json", str(stats_path), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sift_dense.DenseSiftReconstructor.reconstruct = inner
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    if rc != 0:
        raise AssertionError(f"dense_sift: CLI returned {rc}")
    st = json.loads(stats_path.read_text())
    poses = read_poses(out / "poses.npz")
    dense, cols = load_ply(str(out / "dense.ply"))
    if cols is None or cols.shape != dense.shape:
        raise AssertionError("dense_sift: dense.ply colours missing or malformed")
    med, share = gate(to_scene_frame(dense, poses, scene), *DENSE_SIFT_GATE,
                      "dense_sift dense.ply, SfM cameras")
    stereo, _ = load_ply(str(out / "dense_stereo.ply"))
    k1 = st["k1_calls_by_stage"]
    report = {"phase": "dense_sift", "card": card, "wall_s": wall,
              "stage_times_s": st["stage_times_s"],
              "dense_sift_breakdown": st["dense_sift_breakdown"],
              "peak_bytes": peak.get("bytes"), "native_available": native_available(),
              "dense_points": len(dense), "median": med, "share": share,
              "gate": list(DENSE_SIFT_GATE), "stereo_points": len(stereo),
              "k1_launches": launches, "k1_plain_calls": plain_calls, "k1_by_stage": k1}
    print(json.dumps(report), flush=True)
    if plain_calls != 0 or k1.get("plane_sweep", {}).get("kernel", 0) == 0:
        raise AssertionError(f"dense_sift: K1 by stage {k1}, plain calls {plain_calls}")
    if st["dense_sift_breakdown"]["pairs"] != len(sift_dense.dense_pairs(N_VIEWS, 8)):
        raise AssertionError("dense_sift: not every dense pair was matched")
    return report


def checkpoint_phase(work: Path, card: str) -> dict:
    """`IMAGES --mvs --calibration K --checkpoint-dir` on the north-star
    PNGs: from scratch (SfM, every depth map saved), after the second half
    of the maps is deleted (sparse state and half the maps restored), with
    no map left (sparse state restored, every map recomputed in the
    checkpoint branch), and after one batch of maps is deleted under
    --profile. Each run's K1 counts are set to 0 just before it and read
    just after. Gated: dense_mvs.ply identical across the runs, K1 launched
    in each run that computes a map and its plain version never, and K1's
    kernel in the trace."""
    ck = work / "ckpt"
    maps_dir = ck / "depth_maps"
    runs = {}

    def run(name, extra=()):
        out, stats_path = work / f"ckpt_{name}", work / f"ckpt_{name}.json"
        torch.cuda.synchronize()
        warp.counts.reset()
        t0 = time.perf_counter()
        rc = cli_main([str(work / "images"), "--mvs", "--calibration",
                       str(work / "calibration.npz"), "--checkpoint-dir", str(ck),
                       "--output", str(out), "--stats-json", str(stats_path),
                       "--device", "cuda", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"checkpoint {name}: CLI returned {rc}")
        st = json.loads(stats_path.read_text())
        k1 = st["k1_calls_by_stage"]["patchmatch_mvs"]
        runs[name] = {"wall_s": wall, "stage_times_s": st["stage_times_s"],
                      "patchmatch_breakdown_s": st["patchmatch_breakdown_s"],
                      "maps_on_disk_before": n_maps_before,
                      "k1_launches": warp.counts.kernel, "k1_plain_calls": warp.counts.plain,
                      "k1_by_shape": k1["kernel_by_shape"],
                      "dense_points": st["num_dense_points"]}
        print(f"[checkpoint] {name}: wall {wall:.3f} s, stages (s) "
              + ", ".join(f"{k} {v:.3f}" for k, v in st["stage_times_s"].items())
              + f"; {n_maps_before} maps on disk before; K1 launches {warp.counts.kernel}",
              flush=True)
        return load_ply(str(out / "dense_mvs.ply"))

    n_maps_before = 0
    clouds = {"fresh": run("fresh")}
    maps = sorted(maps_dir.iterdir())
    for m in maps[len(maps) // 2:]:
        m.unlink()
    n_maps_before = len(maps) // 2
    clouds["resume_half"] = run("resume_half")
    for m in maps:
        m.unlink()
    n_maps_before = 0
    clouds["restore_sparse"] = run("restore_sparse")
    for m in maps[:4]:
        m.unlink()
    n_maps_before = len(maps) - 4
    trace_dir = work / "ckpt_trace"
    clouds["profiled"] = run("profiled", ["--profile", str(trace_dir)])
    from recon3d_tpu_torch.runtime.profiling import TRACE_NAME

    trace_path = trace_dir / TRACE_NAME
    events = json.loads(trace_path.read_text())["traceEvents"]
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "tent_warp" in e.get("name", "")]
    report = {"phase": "checkpoint", "card": card, "views": N_VIEWS,
              "depth_maps": len(maps), "runs": runs,
              "trace_bytes": trace_path.stat().st_size, "trace_events": len(events),
              "trace_k1_kernels": len(k1_events),
              "trace_kernels": sum(e.get("cat") == "kernel" for e in events)}
    print(json.dumps(report), flush=True)
    failed = []
    ref_pts, ref_cols = clouds["fresh"]
    for name, (pts, cols) in clouds.items():
        if not (np.array_equal(pts, ref_pts) and np.array_equal(cols, ref_cols)):
            failed.append(f"dense_mvs.ply of {name} differs from the fresh run's")
    for name, r in runs.items():
        if r["k1_launches"] == 0 or r["k1_plain_calls"] != 0:
            failed.append(f"{name}: K1 launched {r['k1_launches']} times, "
                          f"plain {r['k1_plain_calls']}")
    if runs["profiled"]["k1_launches"] != len(k1_events):
        failed.append(f"the trace holds {len(k1_events)} K1 kernels, the run launched "
                      f"{runs['profiled']['k1_launches']}")
    if len(ref_pts) < 3000:
        failed.append(f"{len(ref_pts)} dense points")
    if failed:
        raise AssertionError("checkpoint fails its gate: " + "; ".join(failed))
    return report


def dense_sift_budget(card: str) -> dict:
    """match_pairs_batched at dense SIFT's budget: BUDGET_VIEWS views of
    BUDGET_KEYPOINTS random unit descriptors (all valid, so the match
    capacity is the budget) over dense_pairs(BUDGET_VIEWS, 8), dense SIFT's
    match configuration, with the JAX package's chunk of 64 pairs and with
    the chunk sift_dense.pair_chunk picks: the peak of allocated device
    memory and the time of each, or the out-of-memory error. Fails unless
    the picked chunk runs."""
    from recon3d_tpu_torch.config import DenseSiftConfig, MatchConfig
    from recon3d_tpu_torch.dense.sift_dense import dense_pairs, pair_chunk
    from recon3d_tpu_torch.features.frontend import match_pairs_batched

    V, C = BUDGET_VIEWS, BUDGET_KEYPOINTS
    gen = torch.Generator(device="cuda").manual_seed(0)
    desc = torch.randn(V, C, 128, device="cuda", generator=gen)
    desc /= torch.linalg.norm(desc, dim=-1, keepdim=True)
    feats = types.SimpleNamespace(
        desc=desc, valid=torch.ones(V, C, dtype=torch.bool, device="cuda"),
        xy=torch.rand(V, C, 2, device="cuda", generator=gen)
        * torch.tensor([640.0, 480.0], device="cuda"))
    pairs = dense_pairs(V, 8)
    cfg = MatchConfig(ratio=DenseSiftConfig().ratio, cross_check=True)
    picked = pair_chunk(C, cfg.ransac_hypotheses, "cuda")
    free, total = torch.cuda.mem_get_info()
    base = torch.cuda.memory_allocated()
    runs = []
    for chunk in (64, picked):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            res = match_pairs_batched(feats, pairs, torch.Generator(device="cuda").manual_seed(0),
                                      cfg, chunk=chunk)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            runs.append({"chunk": chunk, "seconds": time.perf_counter() - t0,
                         "peak_bytes": peak, "bytes_per_slot": (peak - base) / (
                             min(chunk, len(pairs)) * cfg.ransac_hypotheses * C),
                         "pairs_with_inliers": sum(r[5] > 0 for r in res),
                         "raw_matches_max": max(r[6] for r in res)})
            del res
        except torch.OutOfMemoryError as e:
            runs.append({"chunk": chunk, "seconds": time.perf_counter() - t0,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "out_of_memory": str(e).splitlines()[0][:300]})
        torch.cuda.empty_cache()
        print(f"[dense_sift_budget] chunk {chunk}: " + json.dumps(runs[-1]), flush=True)
    report = {"phase": "dense_sift_budget", "card": card, "views": V, "capacity": C,
              "pairs": len(pairs), "free_bytes_before": free, "total_bytes": total,
              "picked_chunk": picked, "runs": runs}
    print(json.dumps(report), flush=True)
    if "out_of_memory" in runs[-1]:
        raise AssertionError(f"dense_sift_budget: pair_chunk's chunk of {picked} pairs "
                             "does not fit")
    return report


def rescue_phase(card: str) -> dict:
    """The rescue pass on the card: SfMPipeline.reconstruct() on the PNGs
    of RESCUE_SCENE for each of RESCUE_SEEDS, counting the views that
    _rescue_unregistered wins back. Gated: at least RESCUE_JAX views in all,
    what the JAX reference rescues on the same PNGs and seeds."""
    import dataclasses

    from PIL import Image

    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    t0 = time.perf_counter()
    scene = render_views(**RESCUE_SCENE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rescue_") as tmp:
        for i, img in enumerate(scene["images"]):
            Image.fromarray((img * 255).astype(np.uint8)).save(f"{tmp}/view_{i:03d}.png")
        calib = f"{tmp}/calibration.npz"
        np.savez(calib, mtx=np.asarray(scene["K"], np.float64), dist=np.zeros(5))
        render_s = time.perf_counter() - t0
        runs = []
        for seed in RESCUE_SEEDS:
            cfg = ReconstructionConfig()
            pipe = SfMPipeline(calibration_path=calib, device="cuda",
                               config=cfg.replace(sfm=dataclasses.replace(cfg.sfm, seed=seed)))
            found = {}
            rescue = pipe._rescue_unregistered

            def counted(rescue=rescue, pipe=pipe, found=found):
                before = set(pipe.registered)
                torch.cuda.synchronize()
                t = time.perf_counter()
                found["n"] = rescue()
                torch.cuda.synchronize()
                found["seconds"] = time.perf_counter() - t
                found["views"] = sorted(set(pipe.registered) - before)
                return found["n"]

            pipe._rescue_unregistered = counted
            t = time.perf_counter()
            pipe.reconstruct(tmp)
            torch.cuda.synchronize()
            runs.append({"seed": seed, "rescued": found.get("n", 0),
                         "rescued_views": found.get("views", []),
                         "rescue_s": found.get("seconds"),
                         "num_cameras": len(pipe.registered),
                         "mean_reproj_px": pipe.stats["mean_reproj_px"],
                         "reconstruct_s": time.perf_counter() - t})
    total = sum(r["rescued"] for r in runs)
    report = {"phase": "rescue", "card": card, "render_s": render_s, "runs": runs,
              "rescued_total": total, "jax_rescued_total": RESCUE_JAX}
    print(json.dumps(report), flush=True)
    if total < RESCUE_JAX:
        raise AssertionError(f"rescue: the port rescued {total} views over seeds "
                             f"{list(RESCUE_SEEDS)}, the JAX reference {RESCUE_JAX}")
    return report


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    lib_path, build_s, log = warp.build()
    print(f"[build] {lib_path.name}: {build_s:.2f} s with nvcc"
          + (" (already built)" if build_s == 0.0 else ""), flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    shapes = kernel_phase()
    small_scene_check()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        scene = render_north_star(work)
        main_path(work, card)
        sfm_front(work, scene, card)
        sfm_sparse(work, scene, card)
        images = cli_images(work, scene, card)
        stereo = stereo_run(work, card)
        dense_profile(work, images)
        dsift = dense_sift_phase(work, scene, card)
        ckpt = checkpoint_phase(work, card)
    rescue_phase(card)
    dense_sift_budget(card)

    # launches on the main path (cli_images) at each shape of the kernel phase
    for sh in shapes:
        sh["launches"] = images["k1_by_stage"][sh["stage"]]["kernel_by_shape"].get(
            sh["shape_key"], 0)
    unseen = [sh["shape_key"] for sh in shapes if sh["launches"] == 0]
    if unseen:
        raise AssertionError(f"the main path never launched K1 at the kernel phase's "
                             f"shapes {unseen}: {images['k1_by_stage']}")
    if sum(sh["launches"] for sh in shapes) != images["k1_launches"]:
        raise AssertionError(f"the main path launched K1 at shapes the kernel phase does "
                             f"not hold: {images['k1_by_stage']}")
    # launches by variant on the main path, against the planner's pick at
    # each shape of the kernel phase
    by_variant, expected = {}, {}
    for st in images["k1_by_stage"].values():
        for v, n in st["kernel_by_variant"].items():
            by_variant[v] = by_variant.get(v, 0) + n
    for sh in shapes:
        expected[sh["variant"]] = expected.get(sh["variant"], 0) + sh["launches"]
    if by_variant != expected:
        raise AssertionError(f"the main path's K1 variants {by_variant} are not the "
                             f"planner's picks at its shapes {expected}")
    head = shapes[0]
    variants = []
    for v in warp.VARIANTS:
        picked = [sh["shape_key"] for sh in shapes if sh["variant"] == v]
        at = next((sh for sh in shapes if sh["variant"] == v), None) or next(
            (sh for sh in shapes if v in sh["variant_ms"]), None)
        if at is None:
            continue
        variants.append({
            "name": f"tent_warp/{v}", "route": "cuda",
            "source": "recon3d_tpu_torch/csrc/warp.cu", "replaces": K1_REPLACES,
            "launches": by_variant.get(v, 0), "max_abs_err": 0.0,
            "ms": at["variant_ms"][v], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "timed_at": at["shape_key"],
            "picked_at": picked})
    kernels = [{
        "name": "tent_warp", "route": "cuda",
        "source": "recon3d_tpu_torch/csrc/warp.cu", "replaces": K1_REPLACES,
        "launches": images["k1_launches"],
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "variants": variants, "shapes": shapes,
        "launches_by_stage": images["k1_by_stage"],
        "stereo_run_launches": stereo["k1_by_stage"],
        "dense_sift_run_launches": dsift["k1_by_stage"],
        "checkpoint_run_launches": {name: r["k1_by_shape"]
                                    for name, r in ckpt["runs"].items()},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
