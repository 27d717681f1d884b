"""Smoke test of the PyTorch/CUDA port (recon3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # 8 to 12 minutes on an H100, by the host
    python3 chip_smoke.py --against DIR   # also K2 and K3 of the checkout DIR

--against DIR times the K2 and K3 (kernels and wrappers) of another
checkout of this repository in the pointcloud phase, beside this one's, in
the order this, DIR, DIR, this: a comparison within one call on one card.

Phases, each of which passes or raises:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every library of the port from its source, all at once: K1
     (csrc/warp.cu) and K2/K3 (csrc/pointcloud.cu) with nvcc, the host PLY
     routines (csrc/pointcloud_host.cpp) with g++;
  3. kernels: each kernel against its plain PyTorch version on the card at
     every shape the main paths give it (K1 at the 25 shapes of its seven
     call sites: PatchMatch, the TSDF lookup, the plane sweep, SuperPoint's
     descriptor sampling in neural SfM and in LightGlue's training,
     calibration's corner refinement and the undistortion at load; the
     first three also at the shapes of the bench phase), bit for bit
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
     --export-colmap` on the same PNGs, K1's, K2's and K3's counts set to 0
     just before and read just after: SfM at SFM_SPARSE_GATE, the dense
     cloud in the scene's frame at CLI_DENSE_GATE, mesh.ply,
     dense_stereo.ply and sparse_colmap/ checked, K1 launched by PatchMatch,
     the plane sweep and the TSDF, only at the kernel phase's shapes, in the
     variant the planner picks there, K3 once for the mesh colours, and no
     plain version ever (every later CLI run checks K2's and K3's plain
     calls too);
  9. stereo: `--stereo --from-colmap` on the model of the true poses,
     dense_stereo.ply at STEREO_GATE;
 10. the dense stages of the main path once more, each under the profiler
     with its peak of device memory;
 11. dense_sift: the CLI's `--combined --from-colmap` on the model the main
     path exported (the plane sweep and dense SIFT on its SfM cameras),
     dense.ply in the scene's frame at DENSE_SIFT_GATE, with the stage's
     breakdown, match capacity, pair count, peak device memory and the
     k-NN filter's time and path: K2 launched once on the card (knn_path
     "cuda"), no plain call;
 11b. pointcloud: K2 against its plain version on dense SIFT's raw cloud
     (whole, at a cut of K2_CUT points, and that cut at K2_WIDE_K) and on a
     cloud with a cell no ring fills, bit for bit, with the pairs it
     evaluated beside the ring rule's; K3 (a grid search) on the main
     path's mesh vertices against its fused cloud, index for index; each
     timed against its bound (K2: two, the ring rule's pairs and the
     evaluated ones), its plain version and (K3) torch.cdist + argmin, and
     each of its kernels' launches (K3: the stages and the walks) by
     torch.profiler; the voxel dedup on the card against the plain rule at
     the fused cloud's size;
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
     memory, or the out-of-memory error;
 15. global_sfm: SfMPipeline.reconstruct_global() on the north-star PNGs
     with the scene's K, cold and warm, gated at the JAX reference's level
     (GLOBAL_SFM_GATE); the CLI's `IMAGES --global-sfm --mvs`, its K1
     counts set to 0 just before and read just after, the dense cloud at
     GLOBAL_DENSE_GATE; the global solve's stages once more under the
     profiler;
 16. neural: (a) the CLI's `IMAGES --neural --mvs` (SuperPoint with the
     bundled weights, the nn matcher) with its K1 counts set to 0 just
     before and read just after: 50 launches at SuperPoint's shape and
     PatchMatch's, gated at NEURAL_SPARSE_GATE and CLI_DENSE_GATE; (b)
     SfMPipeline(neural_mode=True) with matcher="lightglue" (the bundled
     checkpoint at full width) on the first LIGHTGLUE_VIEWS views, gated at
     LIGHTGLUE_GATE, the attention kernel launched 4 times a layer of every
     LightGlueNet run; (c) one match_pairs_batched chunk of 8 pairs at 2,048
     keypoints: 36 attention launches, ms a pair, peak memory, and
     LightGlue's operations against the card's float32 peak; (d) the
     attention kernel at that chunk's shape, self and cross, against its
     float32 bound, its plain version and scaled_dot_product_attention's
     math backend (`attention_timing`);
 17. train: the neural front end's training path at full width: (a)
     `python -m recon3d_tpu_torch.neural.pretrain` (SuperPoint from scratch,
     one round of 192 steps at batch 32 of 128x128) in a subprocess, its
     losses finite and falling; (b) the bundled fine-tune recipe, one round
     of homographic adaptation, its .npz loaded into NeuralMatcher with the
     trained module's forward within float16 storage; (c) `--model
     lightglue`, one round of 64 steps at batch 16 and 256 keypoints, K1's
     counts set to 0 just before and read just after: 256 launches at the
     training shape, 0 plain; (d) one SuperPoint and one LightGlue step on
     the card against the CPU (tests/torch_train_check.py); (e) a public
     LightGlue .pth on the card, bit for bit the forward of the same
     weights through save_params_npz and the .npz path;
 18. multi_device: the mesh of recon3d_tpu_torch/parallel/ on the first 16
     north-star views (tests/torch_mesh_check.py): (a) a world of 1 over
     NCCL, where distributed_patchmatch, distributed_plane_sweep, the
     sharded TSDF and the sharded BA are bit-identical to one device; (b)
     a world of 2 sharing the card over gloo: the same four within the JAX
     mesh tests' bounds, match_pairs_batched's shards bit for bit, one
     make_pair_train_step step within 1e-5 relative, K1's launches by rank
     (both non-zero, no plain call) and the gloo all_reduce of a TSDF grid
     timed; (c) part (b) over NCCL when two cards are visible, else one
     line saying why it did not run;
 19. calibration: 20 rendered boards through calibrate_camera_robust on the
     card and the CPU, K1 counted at the refinement's shape, the module
     CLI;
 20. serve: the daemon, two north-star requests, a fresh CLI process, the
     worker and the faults the daemon must survive;
 21. robustness: tests/test_robustness.py's distorted capture end to end
     on the card (tests/torch_robust_check.py: 6 views of 192x256 rendered
     through a k1/k2/p1/p2 lens without JAX, loaded with the lens as
     calibration, SfM at the JAX test's gates), K1's counts set to 0 just
     before the load and read just after: one launch at the undistortion
     shape, no plain call;
 22. bench: bench_cuda.main (PatchMatch throughput, 1 window of 4
     repetitions) and scripts/bench_stages_torch.py --quick (its other five
     stages), their JSON lines printed, K1's launches in each (the timed
     windows of bench_cuda, each stage of the other) only at the kernel
     phase's shapes, in the variant the planner picks there, and its plain
     version never.

Every phase's wall time is printed, and their total, before the JSON lines.

Prints the kernel table (K1, K2, K3) as one JSON line, then the card line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero, printing no
result, when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import importlib.util
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
from recon3d_tpu_torch.kernels import attention as attention_kernel  # noqa: E402
from recon3d_tpu_torch.kernels import bundle as bundle_kernels, pointcloud, warp  # noqa: E402
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
# Gates of the global_sfm phase. The JAX reference's global SfM on the same
# PNGs with the scene's K, on the CPU (tests/torch_reference_levels.py part
# 13), registers 50 of 50 at 0.4956 px, but its cameras stand off the true
# ones: after the similarity alignment a mean rotation error of 13.32 deg
# and a mean centre error of 0.6957, and its `--mvs` cloud, carried into the
# scene's frame by those cameras, lands at median 4.4566 and share 0.0387
# (CLI_DENSE_GATE fails the reference itself). The port is held to that
# level: all but 3 cameras, reprojection under 1.5 px (the quality gate of
# SFM_SPARSE_GATE), pose errors under 1.5 times the reference's, and the
# dense cloud at 1.5 times its median and two thirds of its share.
GLOBAL_SFM_GATE = {"min_cameras": 47, "mean_reproj_px": 1.5,
                   "mean_rot_err_deg": 20.0, "mean_center_err": 1.05}
GLOBAL_DENSE_GATE = (6.7, 0.025)
# Gates of the neural CLI run (`IMAGES --neural --mvs`, the default
# NeuralConfig: SuperPoint at 2,048 keypoints, the nn matcher). The JAX CLI
# on the same PNGs on the CPU (part 14) registers 50 of 50 at 1.9514 px,
# mean rotation error 0.3707 deg, mean centre error 0.0092, and its dense
# cloud reaches 0.2665 / 0.3744, within CLI_DENSE_GATE, which therefore
# holds. The reprojection limit stands 25% beyond the reference, the pose
# limits at three times its errors (as SFM_SPARSE_GATE's).
NEURAL_SPARSE_GATE = {"min_cameras": 47, "mean_reproj_px": 2.44,
                      "mean_rot_err_deg": 1.11, "mean_center_err": 0.028}
# The LightGlue run: SfMPipeline(neural_mode=True) with matcher="lightglue"
# on the first LIGHTGLUE_VIEWS PNGs. The JAX reference there on the CPU
# (part 15) registers 12 of 12 at 1.6866 px, mean rotation error 1.0794
# deg, mean centre error 0.0062 (60 pairs kept); the same rule as
# NEURAL_SPARSE_GATE, with one camera to spare.
LIGHTGLUE_VIEWS = 12
LIGHTGLUE_GATE = {"min_cameras": 11, "mean_reproj_px": 2.11,
                  "mean_rot_err_deg": 3.24, "mean_center_err": 0.0186}
# The small long-span runs at match_window=2: 12 views of 240x320 on an arc
# wide enough that probe pairs of span >= 4 fail at load resolution and go
# to the 2x rematch (on the CPU none of them reaches min_matches there
# either), and 10 views of 120x160, where the rematched pairs do and are
# then rejected by the homography gate (the scene is made of planes).
LONG_SPAN = [dict(n_views=12, image_size=(240, 320), arc_step=0.2),
             dict(n_views=10, image_size=(120, 160), arc_step=0.12)]
# The training phase: the JAX defaults that made the bundled checkpoints
# (SuperPoint batch 32 of 128x128 pairs; LightGlue 9 layers x dim 256 x 4
# heads, 256 keypoints, batch 16 pairs of 128x128), one round each.
TRAIN_SP_ARGS = ["--steps", "192", "--batch", "32", "--size", "128"]
TRAIN_FINETUNE_ARGS = ["--steps", "0", "--adapt-steps", "192", "--init-weights",
                       str(REPO / "recon3d_tpu/neural/pretrained/superpoint_synthetic.npz"),
                       "--lr", "1e-4", "--scene-frac", "0.3", "--texture-frac", "0.3"]
TRAIN_LG_PAIRS, TRAIN_LG_BATCHES, TRAIN_KEYPOINTS = 16, 8, 256
TRAIN_LG_ARGS = ["--model", "lightglue", "--steps", "64", "--batches-per-round",
                 str(TRAIN_LG_BATCHES), "--epochs-per-round", "8"]
# A checkpoint stores float16: the written SuperPoint's logits on a
# north-star view within this share of their range of the trained module's.
FP16_LOGIT_TOL = 1e-2

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
    # SuperPoint (neural mode): one image's 256 coarse descriptor planes of
    # 60x80 sampled at its 2,048 keypoint slots, shared by all planes
    ("sparse_sfm", 256, 60, 80, 2048, "keypoints"),
    # LightGlue's training (train_lightglue): one 128x128 image's 256 coarse
    # descriptor planes of 16x16 at its 256 keypoint slots
    ("train_lightglue", 256, 16, 16, 256, "keypoints"),
    # calibration's corner refinement (calib/corners.py::
    # refine_corners_gradient): a 480x640 board's two gradient planes at the
    # 11x11 windows of its 54 corners, shared by both planes; 4 a board
    ("calibration", 2, 480, 640, 54 * 121, "windows"),
    # the undistortion at load (io/dataset.py -> ops/image.py::
    # undistort_image) of the robustness phase's distorted capture: the 3
    # colour planes of its 6 views of 192x256 at the 49,152 forward-distorted
    # pixel positions they share, one launch for the set
    ("load", 18, 192, 256, 192 * 256, "undistort"),
    # the bench phase. bench_cuda.py: its 16 views x J=3 sources = 48
    # planes in one batch, at the fields of the 120x160 fine level (9, 5,
    # 1) and the 30x40 coarse level (13, 9). bench_stages_torch.py --quick:
    # the sweep's 4 reference views x 5 sources = 20 planes, 8 plane
    # homographies a chunk at 60x80, then 5 candidate fields at 120x160;
    # TSDF, one view's depth and confidence planes at all 64^3 voxels
    ("bench_patchmatch", 48, 120, 160, 9 * 120 * 160, "fields"),
    ("bench_patchmatch", 48, 120, 160, 5 * 120 * 160, "fields"),
    ("bench_patchmatch", 48, 120, 160, 1 * 120 * 160, "fields"),
    ("bench_patchmatch", 48, 30, 40, 13 * 30 * 40, "fields"),
    ("bench_patchmatch", 48, 30, 40, 9 * 30 * 40, "fields"),
    ("bench_sweep", 20, 60, 80, 8 * 60 * 80, "fields"),
    ("bench_sweep", 20, 120, 160, 5 * 120 * 160, "fields"),
    ("bench_tsdf", 2, 120, 160, 64 ** 3, "voxels"),
]
K1_REPLACES = "recon3d_tpu/ops/warp_pallas.py:98"
# K2 and K3 have no Pallas kernel behind them: they replace the JAX
# package's host C++, which the port does not load.
K2_REPLACES = ("native/pointcloud.cpp:67 knn_mean_dist (the JAX package's host C++; "
               "no Pallas kernel stands behind it)")
K3_REPLACES = ("native/pointcloud.cpp:136 nearest_index (the JAX package's host C++; "
               "no Pallas kernel stands behind it)")
K2_SOURCE = K3_SOURCE = "recon3d_tpu_torch/csrc/pointcloud.cu"
BUNDLE_SOURCE = "recon3d_tpu_torch/csrc/bundle.cu"
BUNDLE_REPLACES = ("recon3d_tpu/sfm/bundle.py:_lm_step (plain jnp: no Pallas kernel stands "
                   "behind it)")
ATTENTION_SOURCE = "recon3d_tpu_torch/csrc/attention.cu"
ATTENTION_REPLACES = ("recon3d_tpu/neural/lightglue.py's attention (plain jnp: no Pallas kernel "
                      "stands behind it)")
# LightGlue's attention at the neural cell's chunk: 8 pairs, 4 heads, 2,048
# keypoint slots, head width 64.
ATTENTION_SHAPE = (8, 4, 2048, 64)
# Launches of each kernel of csrc/bundle.cu in one LM step at
# tests/torch_bundle_check.py's CG_ITERS (24): pass A once more for the
# back-substitution.
BUNDLE_LAUNCHES = {"linearize": 1, "point_setup": 1, "cam_setup": 1, "cg_init": 1,
                   "point_pass": 25, "cam_pass": 24, "cg_update": 24, "point_update": 1,
                   "cost": 1, "half_sum": 1}
# Floating-point operations of one squared distance: 3 differences, 3
# products, 2 sums (K2 and K3 alike).
OPS_PER_PAIR = 8
# Dense SIFT's raw cloud is compared whole against K2's plain version at
# this cut (a seeded random subset), and at its full size.
K2_CUT = 20_000
# K beyond K2's register list: the cut is held once more at this k.
K2_WIDE_K = 40
# Queries of one torch.cdist call in K3's library yardstick.
K3_LIBRARY_CHUNK = 2048
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


def once_ms(fn):
    """(milliseconds, result) of one fn() on the card, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def device_ms_by_kernel(fn, names, calls: int = 3) -> dict:
    """{name: mean device milliseconds a launch} of the CUDA kernels whose
    names contain one of `names`, over `calls` calls of fn() after one
    warm-up, by torch.profiler (its device events, as profile_run reads
    them), averaged over the launches the profiler saw; None for a name it
    saw none of. A process that has run for a while loses some device events
    of a session (the first of it), and in a whole run of this script the
    point-cloud kernels' sessions here have come back empty: the cause is
    not found, and their split is measured in a process that runs only the
    phases this one needs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = {name: [0.0, 0] for name in names}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.self_device_time_total <= 0:
            continue
        for name in names:
            if name in e.key:
                seen[name][0] += e.self_device_time_total
                seen[name][1] += e.count
    return {name: t / 1e3 / n if n else None for name, (t, n) in seen.items()}


def pointcloud_calls(st: dict, what: str) -> dict:
    """K2's and K3's launches and plain calls in a CLI run (--stats-json);
    their plain versions are never called on the card."""
    calls = st["pointcloud_calls"]
    plain = {name: c["plain"] for name, c in calls.items() if c["plain"]}
    if plain:
        raise AssertionError(f"{what}: the plain versions of K2/K3 ran on the card: {plain}")
    return calls


def bundle_steps(counters: dict, launches: int, what: str) -> dict:
    """The bundle adjustment kernels in one SfM run, their counts set to 0
    just before it: kernels enqueued, LM steps and LM steps on the kernels
    (the run's `ba.lm_steps` and `ba.kernel_steps` counters). Every LM step
    on the card runs on the kernels, and some ran."""
    out = {"launches": launches, "lm_steps": counters.get("ba.lm_steps", 0),
           "kernel_steps": counters.get("ba.kernel_steps", 0)}
    if not (out["lm_steps"] > 0 and out["kernel_steps"] == out["lm_steps"] and launches > 0):
        raise AssertionError(f"{what}: LM steps not all on the bundle kernels: {out}")
    return out


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
    kind "keypoints": SuperPoint's descriptor sampling. One set of points
    for all N planes: M keypoints of an 8H x 8W image (2,048 of 480x640 in
    neural SfM, 256 of 128x128 in LightGlue's training) inside its 4-pixel
    border, in the cells' units, (x + 0.5) / 8 - 0.5; planes of unit
    descriptors.
    kind "windows": calibration's corner refinement. One set of points for
    all N planes: the 11x11 integer offset grid of refine_corners_gradient
    around each of M/121 corners, the corners of a 9-wide board of 25-40 px
    squares, turned by up to 0.5 rad, at subpixel positions near the image
    centre; planes of gradients (normal values).
    kind "undistort": the undistortion at load. One set of points for all
    N planes: every pixel's forward-distorted position under the
    robustness phase's lens (tests/torch_robust_check.DIST, f = 0.9 W, the
    principal point at the centre), as ops/image.py::undistort_image makes
    them; planes of 8-bit colour levels in [0, 1].
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
    elif kind == "keypoints":
        planes = torch.randn((N, H, W), generator=gen, device=dev)
        planes = planes / torch.linalg.norm(planes, dim=0, keepdim=True)
        px = 4 + torch.rand((1, M, 2), generator=gen, device=dev) * torch.tensor(
            [8.0 * W - 9, 8.0 * H - 9], device=dev)
        coords = (px + 0.5) / 8.0 - 0.5
    elif kind == "undistort":
        from recon3d_tpu_torch.ops.image import distort_points
        from tests.torch_robust_check import DIST

        planes = torch.randint(0, 256, (N, H, W), generator=gen, device=dev) / 255.0
        f = 0.9 * W
        ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                torch.arange(W, device=dev, dtype=torch.float32),
                                indexing="ij")
        d = distort_points(torch.stack([(xs - W / 2) / f, (ys - H / 2) / f], dim=-1),
                           torch.from_numpy(DIST).to(dev))
        coords = (d * f + torch.tensor([W / 2, H / 2], device=dev)).reshape(1, M, 2)
    elif kind == "windows":
        planes = torch.randn((N, H, W), generator=gen, device=dev)
        n, cols = M // 121, 9
        a = torch.rand(4, generator=gen, device=dev)
        gy, gx = torch.meshgrid(torch.arange(n // cols, device=dev) - (n // cols - 1) / 2,
                                torch.arange(cols, device=dev) - (cols - 1) / 2, indexing="ij")
        th = a[1] - 0.5
        rot = torch.stack([torch.stack([th.cos(), -th.sin()]), torch.stack([th.sin(), th.cos()])])
        centre = torch.stack([W / 2 + (a[2] - 0.5) * W / 4, H / 2 + (a[3] - 0.5) * H / 4])
        q = (25 + 15 * a[0]) * torch.stack([gx, gy], dim=-1).reshape(-1, 2) @ rot.T + centre
        q = q + torch.rand(q.shape, generator=gen, device=dev) - 0.5
        ar = torch.arange(-5, 6, dtype=torch.float32, device=dev)
        oy, ox = torch.meshgrid(ar, ar, indexing="ij")
        coords = (q[:, None, :] + torch.stack([ox, oy], dim=-1).reshape(-1, 2)).reshape(1, M, 2)
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


def k1_texels(N: int, H: int, W: int, coords: torch.Tensor) -> int:
    """The plane texels that K1 must read on these points: the distinct
    taps of the valid points of each coordinate row, once on each plane
    that row serves (all N planes for shared points)."""
    x, y = coords[..., 0], coords[..., 1]
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    total = 0
    for row in range(coords.shape[0]):
        x0 = x[row][valid[row]].floor().long()
        y0 = y[row][valid[row]].floor().long()
        x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
        hit = torch.zeros(H * W, dtype=torch.bool, device=coords.device)
        for yi, xi in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
            hit[yi * W + xi] = True
        total += int(hit.sum())
    return total * (N if coords.shape[0] == 1 else 1)


def k1_bytes(N: int, H: int, W: int, Nc: int, M: int, texels=None) -> int:
    """K1's byte count: each input read once (the planes' texels that the
    points touch, k1_texels, else the whole planes; the coordinates), each
    output written once (samples 4 B per plane and point, validity 1 B per
    point of each coordinate row: shared points have one validity row)."""
    return (N * H * W if texels is None else texels) * 4 + Nc * M * (8 + 1) + N * M * 4


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


def check_k1(planes, coords, what: str, variant=None, **launch):
    """K1 (the planner's variant, or the one named; `launch` forces vec or
    planes_per_block) against its plain version on the card: bit-identical
    samples and validity, and both valid and invalid points present."""
    out, valid = warp.tent_warp(planes, coords, variant=variant, **launch)
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


def k1_split(planes, coords, coords_u, what: str) -> dict:
    """`shared` with its planes split into groups on grid y as the planner
    splits them, and in one group of all N (PR 11's launch): each held bit
    for bit to the plain version at every vector width, on the main path's
    points and on uniform ones; both timed at the planner's width."""
    N = planes.shape[0]
    for pts, tag in ((coords, ""), (coords_u, " (uniform)")):
        for vec in warp.vec_widths(pts.shape[1], pts.data_ptr() % 16):
            for P in (None, N):
                check_k1(planes, pts, f"{what}{tag}, vec {vec}, planes a block "
                         f"{P or 'as planned'}", "shared", vec=vec, planes_per_block=P)
    plan = warp.plan_for(planes, coords, "shared")
    return {"planes_per_block": plan.planes_per_block, "grid": list(plan.grid),
            "vec": plan.vec,
            "ms": cuda_ms(lambda: warp.tent_warp(planes, coords, variant="shared"), 200),
            "one_group_ms": cuda_ms(lambda: warp.tent_warp(
                planes, coords, variant="shared", planes_per_block=N), 200)}


def k1_bound(N: int, H: int, W: int, Nc: int, M: int, texels: int) -> dict:
    n_bytes = k1_bytes(N, H, W, Nc, M, texels)
    n_ops = N * M * K1_OPS_PER_SAMPLE
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "texels": texels, "ops": n_ops}


def kernel_phase() -> list:
    """K1 at each shape of K1_SHAPES, on the main path's kind of points and
    on uniform ones, in every variant the planner can pick there; timed on
    the main path's kind. Where `shared` can take the shape, its split of
    the planes over grid y against one group of all planes (k1_split). At
    the TSDF shape, the same points once more with one plane (N = 1), which
    shows whether a second plane costs a second read of the coordinates."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for stage, N, H, W, M, kind in K1_SHAPES:
        what = f"{stage}: {N}x{H}x{W} planes, {M} points each"
        shared = kind in ("voxels", "keypoints", "windows", "undistort")
        planes, coords = k1_inputs(N, H, W, M, kind, gen)
        coords_u = k1_inputs(1 if shared else N, H, W, M, "uniform", gen)[1]
        plan = warp.plan_for(planes, coords)
        variant_ms = k1_variants(planes, coords, coords_u, what)
        split = k1_split(planes, coords, coords_u, what) if "shared" in variant_ms else None
        ms_uniform = cuda_ms(lambda: warp.tent_warp(planes, coords_u), 200)
        del coords_u
        err, n_invalid = check_k1(planes, coords, f"{what} ({kind})")

        def k1():
            return warp.tent_warp(planes, coords)

        ms = cuda_ms(k1, 200)
        issue_ms = cuda_ms(k1, 200, prefill=False)
        plain_ms = cuda_ms(lambda: warp.tent_warp_reference(planes, coords), 20)
        library_ms = cuda_ms(k1_library_call(planes, coords), 200)
        bound = k1_bound(N, H, W, coords.shape[0], M, k1_texels(N, H, W, coords))
        shapes.append({
            "stage": stage, "shape_key": warp.shape_key(planes, coords),
            "planes": [N, H, W], "samples_per_plane": M,
            "shared_points": shared, "invalid": n_invalid,
            "variant": plan.variant, "plan": vars(plan), "variant_ms": variant_ms,
            "max_abs_err": err, "ms": ms, "issue_ms": issue_ms,
            "ms_uniform_points": ms_uniform,
            "plain_ms": plain_ms, "library_ms": library_ms, "shared_split": split, **bound,
        })
        print(f"[kernels] tent_warp on {what}: bit-identical to its plain version in "
              f"every variant ({', '.join(f'{v} {t:.4f}' for v, t in variant_ms.items())} "
              f"ms); the planner's {plan.variant} (vec {plan.vec}): {ms:.4f} ms on the device "
              f"({ms_uniform:.4f} on uniform points), {issue_ms:.4f} ms a call issued "
              f"back to back; plain {plain_ms:.4f}, grid_sample {library_ms:.4f} "
              f"(K1/grid_sample {ms / library_ms:.2f}), bound {bound['bound_ms']:.4f} "
              f"by {bound['bound_by']} ({100 * bound['bound_ms'] / ms:.0f}% of it)",
              flush=True)
        if split:
            print(f"[kernels] tent_warp on {what}, shared: {split['planes_per_block']} "
                  f"planes a block, grid {tuple(split['grid'])}, vec {split['vec']}: "
                  f"{split['ms']:.4f} ms; one group of {N}: {split['one_group_ms']:.4f} ms "
                  f"(split / one group {split['ms'] / split['one_group_ms']:.2f}); "
                  f"grid_sample {library_ms:.4f} (shared / grid_sample "
                  f"{split['ms'] / library_ms:.2f}), bound {bound['bound_ms']:.4f}; "
                  f"bit-identical at every width", flush=True)
        if kind == "voxels":
            one = planes[:1].contiguous()
            n1 = {"ms": cuda_ms(lambda: warp.tent_warp(one, coords), 200),
                  "variant": warp.plan_for(one, coords).variant,
                  "variant_ms": {v: cuda_ms(lambda: warp.tent_warp(one, coords, variant=v), 200)
                                 for v in warp.variants_for(1, H, W, 1)},
                  **k1_bound(1, H, W, 1, M, k1_texels(1, H, W, coords))}
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
    pointcloud_calls(stats, "dense from colmap")
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


class _Wrapped:
    """Wraps named callables of objects, (owner, name) pairs (pipeline
    methods, module functions), each with self._wrap(name, fn); restore()
    puts the originals back."""

    def __init__(self, targets):
        self._saved = []
        for owner, name in targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))

    def restore(self) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


class _StageClock(_Wrapped):
    """Each call timed to a device sync, with the peak of allocated device
    memory, summed and maxed by name."""

    def __init__(self, targets):
        targets = list(targets)
        self.seconds = {name: 0.0 for _, name in targets}
        self.peak_bytes = {name: 0 for _, name in targets}
        self.calls = {name: 0 for _, name in targets}
        super().__init__(targets)

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


class _StageProfiles(_Wrapped):
    """Each call under a device-only torch.profiler of its own; the
    profiles listed by name in self.profs. Device activity only: with the
    host's operators recorded as well, the back end's hundreds of thousands
    of launches take minutes to profile."""

    def __init__(self, targets):
        self.profs = {}
        super().__init__(targets)

    def _wrap(self, name, fn):
        from torch.profiler import ProfilerActivity, profile

        def run(*args, **kwargs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            self.profs.setdefault(name, []).append(prof)
            return out
        return run


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
    clock = _StageClock((pipe, name) for name in SPARSE_STAGES)
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
    third = sparse_pipeline(work)
    profs = _StageProfiles((third, name) for name in SPARSE_STAGES).profs
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
    from recon3d_tpu_torch.dense import filters, mesh

    out, stats_path = work / "cli_images", work / "cli_images.json"
    argv = [str(work / "images"), "--mvs", "--mesh", "--stereo", "--export-colmap",
            "--calibration", str(work / "calibration.npz"), "--output", str(out),
            "--stats-json", str(stats_path), "--device", "cuda"]
    # K3's and the voxel dedup's inputs on this path, for pointcloud_phase
    captured = {}
    inner_colors, inner_voxel = mesh.mesh_vertex_colors, filters.voxel_downsample

    def colors(verts, points, cols, device="cuda"):
        captured["mesh_vertices"], captured["fused_cloud"] = verts.copy(), points.copy()
        return inner_colors(verts, points, cols, device=device)

    def voxel(points, cols=None, voxel_size=0.02, device="cuda"):
        captured.setdefault("voxel_input", (np.array(points, np.float32), float(voxel_size)))
        return inner_voxel(points, cols, voxel_size, device)

    mesh.mesh_vertex_colors, filters.voxel_downsample = colors, voxel
    try:
        torch.cuda.synchronize()
        warp.counts.reset()
        pointcloud.reset_counts()
        bundle_kernels.counts.reset()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mesh.mesh_vertex_colors, filters.voxel_downsample = inner_colors, inner_voxel
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    searches = pointcloud.snapshot()
    ba_launches = bundle_kernels.counts.kernel
    if rc != 0:
        raise AssertionError(f"cli_images: CLI returned {rc}")
    st = json.loads(stats_path.read_text())
    ba = bundle_steps(st["trace"]["counters"], ba_launches, "cli_images")
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
        "pointcloud_calls": pointcloud_calls(st, "cli_images"),
        "k3_launches": searches["nearest_index"]["kernel"], "bundle_kernels": ba,
        "mesh_vertices": len(captured.get("mesh_vertices", ())),
        "fused_points": len(captured.get("fused_cloud", ())),
    }
    print(json.dumps(report), flush=True)
    failed = []
    if searches != st["pointcloud_calls"] or searches["nearest_index"]["kernel"] != 1:
        failed.append(f"K3 not launched once for the mesh colours: {searches}, "
                      f"the CLI's {st['pointcloud_calls']}")
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
    report["captured"] = captured
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
              "k1_launches": launches, "k1_plain_calls": plain_calls, "k1_by_stage": k1,
              "pointcloud_calls": pointcloud_calls(st, "stereo")}
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
    exported, K1's, K2's and K3's counts set to 0 just before and read just
    after: dense.ply in the scene's frame at DENSE_SIFT_GATE,
    dense_stereo.ply written, the plane sweep's K1 launches, the k-NN
    filter through K2 on the card (knn_path "cuda", launched, no plain
    call); dense SIFT's breakdown and its own peak of allocated device
    memory. The filter's raw cloud is kept for pointcloud_phase."""
    from recon3d_tpu_torch.dense import sift_dense

    out, stats_path = work / "dense_sift", work / "dense_sift.json"
    inner, inner_filter = (sift_dense.DenseSiftReconstructor.reconstruct,
                           sift_dense.knn_statistical_filter)
    peak, captured = {}, {}

    def measured(self, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        peak["bytes"] = torch.cuda.max_memory_allocated()
        return result

    def capture(points, colors=None, k=20, **kwargs):
        captured["raw_cloud"], captured["k"] = points.detach().clone(), k
        return inner_filter(points, colors, k=k, **kwargs)

    sift_dense.DenseSiftReconstructor.reconstruct = measured
    sift_dense.knn_statistical_filter = capture
    try:
        torch.cuda.synchronize()
        warp.counts.reset()
        pointcloud.reset_counts()
        t0 = time.perf_counter()
        rc = cli_main([str(work / "images"), "--combined", "--from-colmap",
                       str(work / "cli_images" / "sparse_colmap"), "--output", str(out),
                       "--stats-json", str(stats_path), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sift_dense.DenseSiftReconstructor.reconstruct = inner
        sift_dense.knn_statistical_filter = inner_filter
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    searches = pointcloud.snapshot()
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
    br = st["dense_sift_breakdown"]
    report = {"phase": "dense_sift", "card": card, "wall_s": wall,
              "stage_times_s": st["stage_times_s"], "dense_sift_breakdown": br,
              "peak_bytes": peak.get("bytes"),
              "dense_points": len(dense), "median": med, "share": share,
              "gate": list(DENSE_SIFT_GATE), "stereo_points": len(stereo),
              "k1_launches": launches, "k1_plain_calls": plain_calls, "k1_by_stage": k1,
              "pointcloud_calls": pointcloud_calls(st, "dense_sift"),
              "k2_launches": searches["knn_mean_dist"]["kernel"]}
    print(json.dumps(report), flush=True)
    print(f"[dense_sift] on {card}: the k-NN filter took {br['filter_s']:.3f} s of the "
          f"stage's {st['stage_times_s']['dense_sift']:.3f} s on {br['triangulated_points']} "
          f"triangulated points (path {br['knn_path']}, K2 launches {br['knn_launches']}); "
          f"K2/K3 launches and plain calls {searches}", flush=True)
    if plain_calls != 0 or k1.get("plane_sweep", {}).get("kernel", 0) == 0:
        raise AssertionError(f"dense_sift: K1 by stage {k1}, plain calls {plain_calls}")
    if br["pairs"] != len(sift_dense.dense_pairs(N_VIEWS, 8)):
        raise AssertionError("dense_sift: not every dense pair was matched")
    if not (br["knn_path"] == "cuda" and br["knn_launches"] == 1
            and searches == st["pointcloud_calls"]
            and searches["knn_mean_dist"]["kernel"] == 1
            and len(captured.get("raw_cloud", ())) == br["triangulated_points"]):
        raise AssertionError(f"dense_sift: the k-NN filter did not go through K2 once: "
                             f"{br}, counts {searches}")
    report["captured"] = captured
    return report


def pointcloud_phase(images: dict, dsift: dict, card: str, against=None) -> dict:
    """K2 and K3 on the card against their plain versions at the shapes the
    paths gave them, timed with CUDA events against their bounds:
    - K2 on dense SIFT's raw cloud (captured in dense_sift) at its full
      size, the whole result bit for bit, and at a seeded cut of K2_CUT
      points; then on a synthetic cloud with a cell whose rings never hold
      k other points; the cut once more at K2_WIDE_K, past the register
      list. Each row prints the pairs the kernel evaluated (counted by the
      kernel on its first launch) beside the ring rule's. Two bounds: the
      ring rule's pairs at OPS_PER_PAIR float32 operations (the bound of
      a kernel that evaluates them all, kept for comparison) and the
      evaluated pairs at the same operations (`bound_ms`, what this run's
      data needed), each against
      its bytes (points read, distances written), the longer. No single
      library call computes the ring rule.
    - K3 on cli_images' mesh vertices against the fused cloud it coloured
      them from, index for index; bound: its bytes, or the pairs its grid
      search evaluated (counted by the kernel on its first launch) at
      OPS_PER_PAIR operations, whichever takes longer; the library
      yardstick is torch.cdist and argmin (two calls) over chunks of
      K3_LIBRARY_CHUNK queries, a brute force. K3 is one call of two
      kernels, the blocks' stages and the walks they leave: each one's
      device time comes from torch.profiler (K2's one kernel's too).
    - The voxel dedup on the device (torch ops) against the plain rule (the
      first point of every floor(p / voxel) cell, numpy on the host) at the
      fused cloud's size, before PatchMatch's dedup in cli_images.
    - With `against` (a checkout's root): pointcloud_against on the same
      clouds."""
    raw, k = dsift["captured"]["raw_cloud"], dsift["captured"]["k"]
    n = len(raw)
    out = {}

    def k2_case(points, what, k=k):
        prep = pointcloud.knn_prepare(points, k)
        evaluated = torch.zeros(1, dtype=torch.int64, device=points.device)
        got = pointcloud.knn_launch(prep, evaluated)
        plain_ms, want = once_ms(lambda: pointcloud.knn_mean_dist_reference(points, k))
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K2 on {what}: {bad} of {len(points)} values differ from "
                                 f"the plain version (max abs {err})")
        ms = cuda_ms(lambda: pointcloud.knn_launch(prep), 10)
        pairs, evaluated = prep.grid.candidate_pairs(), int(evaluated)
        if not 0 < evaluated <= pairs:
            raise AssertionError(f"K2 on {what}: {evaluated} pairs evaluated, the ring rule's "
                                 f"{pairs}")
        t_bytes = 16 * len(points) / HBM_BYTES_PER_S   # 12 bytes read, 4 written a point

        def bound(n_pairs):
            t_ops = n_pairs * OPS_PER_PAIR / F32_OPS_PER_S
            return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

        bound_ms, bound_by = bound(evaluated)
        ring_ms, ring_by = bound(pairs)
        return {"points": len(points), "k": k, "cells": len(prep.grid.key),
                "chunks": len(prep.block_chunk),
                "rings": torch.bincount(prep.grid.ring).tolist(),
                "largest_cell": int(prep.grid.count.max()), "pairs": pairs,
                "pairs_evaluated": evaluated, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ring_rule_ms": ring_ms, "bound_ring_rule_by": ring_by,
                "library_ms": None}

    def k2_line(row):
        return (f"{row['ms']:.4f} ms, {row['pairs_evaluated']} pairs evaluated of the ring "
                f"rule's {row['pairs']} ({row['pairs'] / row['pairs_evaluated']:.1f}x fewer); "
                f"bound {row['bound_ms']:.4f} by {row['bound_by']} on the evaluated pairs "
                f"({100 * row['bound_ms'] / row['ms']:.1f}% of it), "
                f"{row['bound_ring_rule_ms']:.4f} on the ring rule's "
                f"({100 * row['bound_ring_rule_ms'] / row['ms']:.1f}%); plain "
                f"{row['plain_ms']:.4f}")

    full = k2_case(raw, "dense SIFT's raw cloud")
    full["wrapper_ms"] = cuda_ms(lambda: pointcloud.knn_mean_dist(raw, k), 3, prefill=False)
    k2_prep = pointcloud.knn_prepare(raw, k)
    full["ms_by_kernel"] = device_ms_by_kernel(lambda: pointcloud.knn_launch(k2_prep),
                                               ["knn_mean_dist_kernel"])
    cut_rows = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:K2_CUT]
    cut = k2_case(raw[cut_rows.to(raw.device)].contiguous(), f"a cut of {K2_CUT} points")
    rng = np.random.default_rng(3)
    lone = np.concatenate([rng.uniform(0, 10, (30_000, 3)),
                           [[80.0, 80.0, 80.0], [79.5, 80.0, 80.0], [80.0, 79.0, 80.0]]])
    lone_t = torch.from_numpy(lone.astype(np.float32)).cuda()
    grid = pointcloud.cell_grid(lone_t, k)
    if not bool(((grid.ring == pointcloud.RING_MAX) & (grid.cube - 1 < k)).any()):
        raise AssertionError("K2's synthetic cloud has no cell whose rings miss k")
    synthetic = k2_case(lone_t, "the synthetic cloud with a lone cell")
    wide = k2_case(raw[cut_rows.to(raw.device)].contiguous(), f"the cut at k {K2_WIDE_K}",
                   K2_WIDE_K)
    out["knn_mean_dist"] = {**full, "cut": cut, "no_ring_reaches_k": synthetic,
                            "wide_k": wide}
    print(f"[pointcloud] K2 on dense SIFT's raw cloud ({n} points, k {k}, "
          f"{full['cells']} cells in {full['chunks']} chunks, the largest "
          f"{full['largest_cell']} points, rings {full['rings']}): bit-identical to its plain "
          f"version; {k2_line(full)}; the wrapper with its glue {full['wrapper_ms']:.4f} ms",
          flush=True)
    for row, what in ((cut, f"a cut of {K2_CUT}"),
                      (synthetic, f"a cloud with a lone cell ({synthetic['points']} points)"),
                      (wide, f"the cut at k {K2_WIDE_K} (the scratch list)")):
        print(f"[pointcloud] K2 on {what}: bit-identical; {k2_line(row)}", flush=True)

    cap = images["captured"]
    ref = torch.from_numpy(cap["fused_cloud"]).cuda()
    query = torch.from_numpy(cap["mesh_vertices"]).cuda()
    prep = pointcloud.nearest_prepare(ref, query)
    pairs = torch.zeros(1, dtype=torch.int64, device=ref.device)
    got = pointcloud.nearest_launch(prep, pairs)
    plain_ms, want = once_ms(lambda: pointcloud.nearest_index_reference(ref, query))
    if not torch.equal(got, want):
        raise AssertionError(f"K3 on the mesh vertices: {int((got != want).sum())} of "
                             f"{len(query)} indices differ from the plain version")
    ms = cuda_ms(lambda: pointcloud.nearest_launch(prep), 10)
    wrapper_ms = cuda_ms(lambda: pointcloud.nearest_index(ref, query), 3, prefill=False)
    by_kernel = device_ms_by_kernel(lambda: pointcloud.nearest_launch(prep),
                                    ["nearest_stage_kernel", "nearest_walk_kernel"])

    def library():
        return [torch.cdist(query[i:i + K3_LIBRARY_CHUNK], ref).argmin(1)
                for i in range(0, len(query), K3_LIBRARY_CHUNK)]

    library_ms = cuda_ms(library, 2)
    agree = float((torch.cat(library()) == got).float().mean())
    pairs = int(pairs)
    t_ops = pairs * OPS_PER_PAIR / F32_OPS_PER_S
    t_bytes = (12 * (len(ref) + len(query)) + 8 * len(query)) / HBM_BYTES_PER_S
    out["nearest_index"] = {
        "ref_points": len(ref), "queries": len(query), "grid": list(prep.span),
        "pairs": pairs, "brute_force_pairs": len(ref) * len(query), "max_abs_err": 0.0,
        "blocks": -(-len(query) // pointcloud.NN_THREADS), "ms_by_kernel": by_kernel,
        "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_calls": "torch.cdist + argmin, chunks of %d queries" % K3_LIBRARY_CHUNK,
        "library_agree": agree, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    k3 = out["nearest_index"]
    print(f"[pointcloud] K3 on cli_images' {len(query)} mesh vertices against its "
          f"{len(ref)} fused points (a grid of {prep.span} cells): index for index its plain "
          f"version; {ms:.4f} ms (the wrapper with its glue {wrapper_ms:.4f}), plain "
          f"{plain_ms:.4f}, cdist + argmin {library_ms:.4f} (same index {agree:.6f}), "
          f"{pairs} pairs evaluated ({pairs / len(query):.1f} a query), bound "
          f"{k3['bound_ms']:.4f} by {k3['bound_by']} ({100 * k3['bound_ms'] / ms:.1f}% of it); "
          f"a launch of each kernel (torch.profiler): {by_kernel}", flush=True)
    print(f"[pointcloud] K2's kernel a launch (torch.profiler): {full['ms_by_kernel']}",
          flush=True)

    pts, voxel = cap["voxel_input"]
    dev_ms, kept = once_ms(lambda: pointcloud.voxel_first_indices(
        torch.from_numpy(pts).cuda(), voxel))
    cells = np.floor(pts * (np.float32(1) / np.float32(voxel))).astype(np.int64)
    want = np.sort(np.unique(cells, axis=0, return_index=True)[1])
    if not np.array_equal(kept.cpu().numpy(), want):
        raise AssertionError(f"the voxel dedup on the card keeps {len(kept)} points, the "
                             f"plain rule {len(want)}")
    out["voxel_dedup"] = {"points": len(pts), "voxel": voxel, "kept": len(want), "ms": dev_ms}
    print(f"[pointcloud] voxel dedup on the card at the fused cloud's {len(pts)} points "
          f"(voxel {voxel}): the plain rule's {len(want)} indices; {dev_ms:.4f} ms",
          flush=True)
    if against is not None:
        out["against"] = pointcloud_against(against, raw, k, ref, query)
    print(json.dumps({"phase": "pointcloud", "card": card, **out}), flush=True)
    return out


def pointcloud_against(root: Path, raw, k: int, ref, query) -> list:
    """K2 and K3 of this checkout and of the one at `root` on the same
    clouds, in the order this, root, root, this: each kernel alone on its
    prepared inputs (CUDA events, the queue held full) and each wrapper
    with its glue as a caller calls it (the queue not held), each result
    held to this checkout's. Uses only the entry points every version has:
    knn_prepare/knn_launch, nearest_prepare/nearest_launch and the two
    wrappers."""
    spec = importlib.util.spec_from_file_location(
        "pointcloud_against", root / "recon3d_tpu_torch" / "kernels" / "pointcloud.py")
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other   # dataclasses look their module up there
    spec.loader.exec_module(other)
    want = pointcloud.knn_mean_dist(raw, k), pointcloud.nearest_index(ref, query)
    rows = []
    for name, mod in (("this", pointcloud), (str(root), other), (str(root), other),
                      ("this", pointcloud)):
        got = mod.knn_mean_dist(raw, k), mod.nearest_index(ref, query)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"pointcloud against {root}: {name}'s K2 or K3 differs")
        k2_prep, k3_prep = mod.knn_prepare(raw, k), mod.nearest_prepare(ref, query)
        row = {"checkout": name,
               "k2_ms": cuda_ms(lambda: mod.knn_launch(k2_prep), 10),
               "k2_wrapper_ms": cuda_ms(lambda: mod.knn_mean_dist(raw, k), 5, prefill=False),
               "k3_ms": cuda_ms(lambda: mod.nearest_launch(k3_prep), 10),
               "k3_wrapper_ms": cuda_ms(lambda: mod.nearest_index(ref, query), 5,
                                        prefill=False)}
        print(f"[pointcloud] against: {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def bundle_phase(card: str) -> dict:
    """The bundle adjustment kernels (csrc/bundle.cu) against the plain
    version at DTU's size (tests/torch_bundle_check.py): one LM step's
    costs and step against the plain version in float32 and in float64
    (the step within 2e-3 of float64's), two runs bit for bit, one step's
    launches (BUNDLE_LAUNCHES); each kernel's device time (torch.profiler,
    null with a reason where it saw no launch) against its byte bound on
    the live rows, the step's and the plain version's times (CUDA events:
    the device's back to back, and as the host launches them), and the
    plain version's two CG passes."""
    from recon3d_tpu_torch.ops.linalg import einsum_hp
    from recon3d_tpu_torch.sfm import bundle
    from tests import torch_bundle_check as bc

    dev = torch.device("cuda")
    table = bc.dtu_table(dev)
    damping = torch.full((), bc.DAMPING, device=dev)

    def step():
        return bundle._lm_step(table, damping, bc.DELTA, bc.CG_ITERS)

    def plain():
        return bundle._lm_step_plain(table, damping, bc.DELTA, bc.CG_ITERS)

    got, c0, c1 = step()
    bundle_kernels.counts.reset()
    again = step()
    launches = bundle_kernels.counts.kernel
    ref, c0_ref, c1_ref = plain()
    exact, _, c1_exact = bundle._lm_step_plain(bc.float64(table), damping.double(), bc.DELTA,
                                               bc.CG_ITERS)
    rows, P, C = int(table.obs_w.sum()), table.X0.shape[0], table.R0.shape[0]
    out = {"rows": rows, "points": P, "cameras": C, "capacity": table.obs_cam.shape[0],
           "launches_a_step": launches,
           "cost0": float(c0), "cost0_plain": float(c0_ref), "cost1": float(c1),
           "cost1_plain": float(c1_ref), "cost1_float64": float(c1_exact),
           "xi_rel_float64": bc.rel(got.xi, exact.xi), "dX_rel_float64": bc.rel(got.dX, exact.dX),
           "plain_xi_rel_float64": bc.rel(ref.xi, exact.xi),
           "plain_dX_rel_float64": bc.rel(ref.dX, exact.dX)}
    if not (torch.equal(got.xi, again[0].xi) and torch.equal(got.dX, again[0].dX)
            and torch.equal(c1, again[2])):
        raise AssertionError("bundle kernels: two runs of one step differ")
    if (abs(out["cost0"] - out["cost0_plain"]) > 1e-5 * out["cost0_plain"]
            or max(out["xi_rel_float64"], out["dX_rel_float64"]) > 2e-3
            or launches != sum(BUNDLE_LAUNCHES.values())):
        raise AssertionError(f"bundle kernels against the plain version: {out}")
    per_launch = device_ms_by_kernel(step, [f"{name}_kernel(" for name in BUNDLE_LAUNCHES], 5)
    kernels = {}
    for name, nbytes in bc.kernel_bytes(rows, P, C).items():
        ms = per_launch[f"{name}_kernel("]
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        kernels[name] = {"launches_a_step": BUNDLE_LAUNCHES[name], "bytes": nbytes,
                         "bound_us": bound_us}
        if ms is None:
            kernels[name]["us"] = None
            kernels[name]["why_null"] = "the profiler saw no launch of it"
        else:
            kernels[name].update(us=ms * 1e3, share_of_bound=bound_us / (ms * 1e3))

    _, Jc, Jp = bundle._per_obs_jacobians(table, torch.ones_like(table.obs_w))
    x = torch.randn((C, 6), device=dev)
    v = torch.randn((P, 3), device=dev)

    def pass_a():       # the plain version's E^T x, summed into points
        u = einsum_hp("oij,oj->oi", Jc, x[table.obs_cam])
        return bundle._reduce_pt(table, einsum_hp("oij,oi->oj", Jp, u))

    def pass_b():       # its camera block and coupling, summed into cameras
        u = einsum_hp("oij,oj->oi", Jc, x[table.obs_cam])
        w = einsum_hp("oij,oj->oi", Jp, v[table.obs_pt])
        return (bundle._reduce_cam(table, einsum_hp("oij,oi->oj", Jc, u))
                - bundle._reduce_cam(table, einsum_hp("oij,oi->oj", Jc, w)))

    out.update(kernels=kernels, step_device_ms=cuda_ms(step, 10),
               step_ms=cuda_ms(step, 10, prefill=False),
               plain_step_ms=cuda_ms(plain, 5, prefill=False),
               plain_pass_ms={"point_pass": cuda_ms(pass_a, 20), "cam_pass": cuda_ms(pass_b, 20)})
    print(json.dumps({"phase": "bundle", "card": card, **out}), flush=True)
    return out


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
                      "pointcloud_calls": pointcloud_calls(st, f"checkpoint {name}"),
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


GLOBAL_FUNCTIONS = ("relative_poses", "rotation_averaging", "_solve_points")
GLOBAL_METHODS = ("bundle_adjustment_light", "bundle_adjustment_full",
                  "drop_invalid_observations", "try_recover_images")


def check_sparse(st: dict, errs: dict, gate: dict, what: str) -> None:
    failed = []
    if st["num_cameras"] < gate["min_cameras"]:
        failed.append(f"{st['num_cameras']} cameras registered")
    if not st["mean_reproj_px"] < gate["mean_reproj_px"]:
        failed.append(f"mean reprojection error {st['mean_reproj_px']:.4f} px")
    for key in ("mean_rot_err_deg", "mean_center_err"):
        if not errs[key] < gate[key]:
            failed.append(f"{key} {errs[key]:.4f}")
    if failed:
        raise AssertionError(f"{what} fails its gate {gate}: " + "; ".join(failed))


def check_k1_shapes(by_stage: dict, shapes: list, what: str) -> None:
    """Every K1 launch of a run at a kernel-phase shape, in the variant the
    planner picks there, and the plain version never."""
    known = {sh["shape_key"]: sh["variant"] for sh in shapes}
    for stage, st in by_stage.items():
        if st["plain"] != 0:
            raise AssertionError(f"{what}: K1's plain version called in {stage}")
        off = {k: n for k, n in st["kernel_by_shape"].items() if k not in known}
        if off:
            raise AssertionError(f"{what}: K1 launched in {stage} at shapes the kernel "
                                 f"phase does not hold: {off}")
        expected = {}
        for k, n in st["kernel_by_shape"].items():
            expected[known[k]] = expected.get(known[k], 0) + n
        if {v: n for v, n in st["kernel_by_variant"].items() if n} != expected:
            raise AssertionError(f"{what}: K1's variants in {stage} {st['kernel_by_variant']} "
                                 f"are not the planner's picks {expected}")


def cli_sparse_run(work: Path, scene: dict, card: str, name: str, flags) -> dict:
    """The CLI `IMAGES <flags> --mvs --calibration K --stats-json`, K1's
    and the bundle kernels' counts set to 0 just before and read just
    after: the sparse result against the true poses and the dense cloud in
    the scene's frame."""
    out, stats_path = work / name, work / f"{name}.json"
    torch.cuda.synchronize()
    warp.counts.reset()
    bundle_kernels.counts.reset()
    t0 = time.perf_counter()
    rc = cli_main([str(work / "images"), *flags, "--mvs", "--calibration",
                   str(work / "calibration.npz"), "--output", str(out),
                   "--stats-json", str(stats_path), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    ba_launches = bundle_kernels.counts.kernel
    if rc != 0:
        raise AssertionError(f"{name}: CLI returned {rc}")
    st = json.loads(stats_path.read_text())
    ba = bundle_steps(st["trace"]["counters"], ba_launches, name)
    poses = read_poses(out / "poses.npz")
    dense, dcols = load_ply(str(out / "dense_mvs.ply"))
    if dcols is None or dcols.shape != dense.shape or not np.isfinite(dense).all():
        raise AssertionError(f"{name}: dense_mvs.ply malformed")
    sparse, _ = load_ply(str(out / "sparse.ply"))
    if len(sparse) != st["num_points"] or not np.isfinite(sparse).all():
        raise AssertionError(f"{name}: sparse.ply malformed")
    med, share = surface_gate(to_scene_frame(dense, poses, scene))
    k1 = st["k1_calls_by_stage"]
    if launches != sum(v["kernel"] for v in k1.values()) or plain_calls != 0:
        raise AssertionError(f"{name}: K1 launched {launches} times, by stage {k1}, "
                             f"plain {plain_calls}")
    return {"phase": name, "card": card, "wall_s": wall,
            "num_cameras": st["num_cameras"], "num_points": st["num_points"],
            "num_pairs": st["num_pairs"], "mean_reproj_px": st["mean_reproj_px"],
            "pose_errors": pose_errors(poses, scene), "stage_times_s": st["stage_times_s"],
            "sparse_seconds": {k: st[k] for k in ("load_time", "extract_time", "match_time",
                                                  "total_time", "global_solve_time",
                                                  "init_time", "incremental_time",
                                                  "final_ba_time") if k in st},
            "dense_points": len(dense), "dense_median": med, "dense_share": share,
            "k1_launches": launches, "k1_plain_calls": plain_calls, "k1_by_stage": k1,
            "pointcloud_calls": pointcloud_calls(st, name), "bundle_kernels": ba}


def global_sfm_phase(work: Path, scene: dict, card: str, shapes: list) -> dict:
    """SfMPipeline.reconstruct_global() on the north-star PNGs, cold and
    warm (gated at GLOBAL_SFM_GATE, each stage of the global solve timed to
    a device sync), the CLI's `IMAGES --global-sfm --mvs` (the dense cloud
    at GLOBAL_DENSE_GATE, K1 by stage), and the global solve's stages once
    more under a device-only profiler."""
    from recon3d_tpu_torch.runtime.profiling import finished
    from recon3d_tpu_torch.sfm import global_sfm

    def run(instrument):
        pipe = sparse_pipeline(work)
        probe = instrument([(global_sfm, f) for f in GLOBAL_FUNCTIONS]
                           + [(pipe, m) for m in GLOBAL_METHODS])
        try:
            torch.cuda.synchronize()
            bundle_kernels.counts.reset()
            t0 = time.perf_counter()
            points, colors, poses = pipe.reconstruct_global(str(work / "images"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            probe.restore()
        root = finished()[-1]
        if root["name"] != "sfm.reconstruct_global":
            raise AssertionError(f"global_sfm: the last root trace is {root['name']}")
        ba = bundle_steps(root["counters"], bundle_kernels.counts.kernel, "global_sfm")
        return pipe, probe, wall, points, colors, poses, ba

    cold_pipe, _, cold_wall, *_ = run(_StageClock)
    cold = {k: cold_pipe.stats[k] for k in ("num_cameras", "num_points", "mean_reproj_px",
                                            "global_solve_time", "total_time")}
    del cold_pipe
    pipe, clock, wall, points, colors, poses, ba = run(_StageClock)
    st = pipe.stats
    errs = pose_errors(pipe.poses, scene)
    report = {
        "phase": "global_sfm", "card": card, "views": N_VIEWS,
        "num_cameras": st["num_cameras"], "num_points": st["num_points"],
        "num_pairs": st["num_pairs"], "mean_reproj_px": st["mean_reproj_px"],
        "unregistered": sorted(set(range(N_VIEWS)) - set(pipe.registered)),
        "pose_errors": errs, "wall_s": wall, "wall_cold_s": cold_wall,
        "seconds": {k: st[k] for k in ("load_time", "extract_time", "match_time",
                                       "global_solve_time", "total_time")},
        "cold": cold, "stage_seconds_synced": clock.seconds, "stage_calls": clock.calls,
        "gate": GLOBAL_SFM_GATE, "bundle_kernels": ba,
    }
    print(json.dumps(report), flush=True)
    if not (points.ndim == 2 and points.shape[1] == 3 and np.isfinite(points).all()
            and colors.shape == points.shape and sorted(poses) == sorted(pipe.registered)):
        raise AssertionError("global_sfm: points, colours or poses malformed")
    check_sparse(st, errs, GLOBAL_SFM_GATE, "global_sfm")
    del pipe

    cli = cli_sparse_run(work, scene, card, "global_sfm_cli", ["--global-sfm"])
    print(json.dumps(cli), flush=True)
    check_sparse(cli, cli["pose_errors"], GLOBAL_SFM_GATE, "global_sfm_cli")
    print(f"[global_sfm_cli] dense_mvs.ply {cli['dense_points']} points, median "
          f"{cli['dense_median']:.4f} (gate < {GLOBAL_DENSE_GATE[0]}), share "
          f"{cli['dense_share']:.4f} (gate > {GLOBAL_DENSE_GATE[1]})", flush=True)
    if not (cli["dense_points"] >= 3000 and cli["dense_median"] < GLOBAL_DENSE_GATE[0]
            and cli["dense_share"] > GLOBAL_DENSE_GATE[1]):
        raise AssertionError("global_sfm_cli: dense cloud fails GLOBAL_DENSE_GATE")
    check_k1_shapes(cli["k1_by_stage"], shapes, "global_sfm_cli")
    if cli["k1_by_stage"].get("patchmatch_mvs", {}).get("kernel", 0) == 0:
        raise AssertionError("global_sfm_cli: K1 never launched by PatchMatch")
    report["cli"] = cli

    # The profiled rerun: each stage call of the global solve under its
    # own device-only profile, against the warm run's synced stage times.
    profs = run(_StageProfiles)[1].profs
    report["profile"] = {
        name: summarize_profiles(profs.get(name, []), clock.seconds[name] or 1e-9,
                                 f"global_sfm {name}")
        for name in GLOBAL_FUNCTIONS + GLOBAL_METHODS if profs.get(name)}
    measured = [v for v in report["profile"].values() if v]
    if measured:
        busy = sum(v["device_busy_s"] for v in measured)
        solve = report["seconds"]["global_solve_time"]
        print(f"[profile] global_sfm, the global solve: device busy {busy:.4f} s in "
              f"{sum(v['kernels'] for v in measured)} kernels and copies, "
              f"{100 * busy / solve:.1f}% of the warm run's {solve:.3f} s "
              f"(idle {100 * (1 - busy / solve):.1f}%)", flush=True)
    return report


def lightglue_flops(N: int, D: int, layers: int) -> float:
    """Floating-point operations of LightGlueNet on one pair of N keypoint
    slots (every slot computed, valid or not): per layer and set, four
    attention projections (8 N D^2) and two products (4 N^2 D) for self-
    and for cross-attention, and a message MLP 2D -> 2D -> D (12 N D^2)
    after each; then input_proj and final_proj (2 N D^2 each a set) and the
    similarity (2 N^2 D). Softmax, LayerNorm and GELU are left out."""
    per_set_layer = 2 * (8 * N * D * D + 4 * N * N * D + 12 * N * D * D)
    return 2 * layers * per_set_layer + 2 * 2 * (2 * N * D * D) + 2 * N * N * D


def neural_phase(work: Path, scene: dict, card: str, shapes: list) -> dict:
    """(a) The CLI's `IMAGES --neural --mvs`, K1 counted by stage and shape;
    (b) SfMPipeline(neural_mode=True, matcher="lightglue") on the first
    LIGHTGLUE_VIEWS views, its attention launches counted; (c) one
    match_pairs_batched chunk of 8 pairs of 2,048 keypoint slots with the
    bundled LightGlue at full width; (d) `attention_timing`."""
    import dataclasses

    from recon3d_tpu_torch.config import ReconstructionConfig
    from recon3d_tpu_torch.neural.lightglue import normalize_keypoints
    from recon3d_tpu_torch.sfm.pipeline import SfMPipeline

    cli = cli_sparse_run(work, scene, card, "neural_cli", ["--neural"])
    print(json.dumps(cli), flush=True)
    check_sparse(cli, cli["pose_errors"], NEURAL_SPARSE_GATE, "neural_cli")
    print(f"[neural_cli] dense_mvs.ply {cli['dense_points']} points, median "
          f"{cli['dense_median']:.4f} (gate < {CLI_DENSE_GATE[0]}), share "
          f"{cli['dense_share']:.4f} (gate > {CLI_DENSE_GATE[1]})", flush=True)
    if not (cli["dense_points"] >= 3000 and cli["dense_median"] < CLI_DENSE_GATE[0]
            and cli["dense_share"] > CLI_DENSE_GATE[1]):
        raise AssertionError("neural_cli: dense cloud fails CLI_DENSE_GATE")
    check_k1_shapes(cli["k1_by_stage"], shapes, "neural_cli")
    sp_key = next(sh["shape_key"] for sh in shapes if sh["stage"] == "sparse_sfm")
    sparse_k1 = cli["k1_by_stage"]["sparse_sfm"]
    if sparse_k1["kernel"] != N_VIEWS or sparse_k1["kernel_by_shape"] != {sp_key: N_VIEWS}:
        raise AssertionError(f"neural_cli: SuperPoint launched K1 {sparse_k1}, not once a "
                             f"view at {sp_key}")
    if cli["k1_by_stage"]["patchmatch_mvs"]["kernel"] == 0:
        raise AssertionError("neural_cli: K1 never launched by PatchMatch")

    cfg = ReconstructionConfig()
    cfg = cfg.replace(neural=dataclasses.replace(cfg.neural, matcher="lightglue"))
    pipe = SfMPipeline(calibration_path=str(work / "calibration.npz"), neural_mode=True,
                       config=cfg, device="cuda")
    # every LightGlueNet run of the reconstruction: 4 attention launches a layer
    lightglue_runs = [0]
    run_lightglue = pipe.matcher._lightglue

    def counted_lightglue(*a, **kw):
        lightglue_runs[0] += 1
        return run_lightglue(*a, **kw)

    pipe.matcher._lightglue = counted_lightglue
    attention_kernel.counts.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.reconstruct(str(work / "images"), max_images=LIGHTGLUE_VIEWS)
    torch.cuda.synchronize()
    lg_wall = time.perf_counter() - t0
    pipe.matcher._lightglue = run_lightglue
    attention_launches = attention_kernel.counts.kernel
    st = pipe.stats
    lg = {"views": LIGHTGLUE_VIEWS, "wall_s": lg_wall, "num_cameras": st["num_cameras"],
          "num_points": st["num_points"], "num_pairs": st["num_pairs"],
          "num_candidate_pairs": st["num_candidate_pairs"],
          "mean_reproj_px": st["mean_reproj_px"],
          "unregistered": sorted(set(range(LIGHTGLUE_VIEWS)) - set(pipe.registered)),
          "pose_errors": pose_errors(pipe.poses, scene),
          "seconds": {k: st[k] for k in ("load_time", "extract_time", "match_time",
                                         "init_time", "incremental_time", "final_ba_time",
                                         "total_time")},
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "matcher_kind": pipe.matcher.matcher_kind,
          "lightglue_runs": lightglue_runs[0], "attention_launches": attention_launches}
    print("[neural lightglue] " + json.dumps(lg), flush=True)
    if lg["matcher_kind"] != "lightglue":
        raise AssertionError("neural lightglue: the matcher is not LightGlue")
    a_run = 4 * pipe.matcher.config.lightglue_layers
    if lightglue_runs[0] == 0 or attention_launches != a_run * lightglue_runs[0]:
        raise AssertionError(f"neural lightglue: {attention_launches} attention launches in "
                             f"{lightglue_runs[0]} LightGlue runs, not {a_run} a run")
    check_sparse(st, lg["pose_errors"], LIGHTGLUE_GATE, "neural lightglue")

    # (c) one chunk of 8 pairs at 2,048 keypoint slots
    m = pipe.matcher
    feats = pipe.features
    pairs = pipe._candidate_pairs(LIGHTGLUE_VIEWS)[:8]
    hw = pipe.image_set.gray.shape[1:3]
    N, D, L = feats[0].desc.shape[0], m.config.descriptor_dim, m.config.lightglue_layers
    pi = torch.tensor([p[0] for p in pairs], device="cuda")
    pj = torch.tensor([p[1] for p in pairs], device="cuda")
    desc = torch.stack([f.desc for f in feats])
    xy = torch.stack([f.xy for f in feats])
    valid = torch.stack([f.valid for f in feats])
    args = (desc[pi], desc[pj], normalize_keypoints(xy[pi], hw), normalize_keypoints(xy[pj], hw),
            valid[pi], valid[pj])

    def network():
        with torch.no_grad():
            return m.lg(*args)

    def chunk():
        return m.match_pairs_batched(feats, pairs, torch.Generator(device="cuda").manual_seed(0),
                                     hw=hw)

    network()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    attention_kernel.counts.reset()
    chunk()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if attention_kernel.counts.kernel != a_run:
        raise AssertionError(f"neural chunk: {attention_kernel.counts.kernel} attention "
                             f"launches in one chunk, not {a_run}")
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        chunk()
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / reps
    net_ms = cuda_ms(network, reps, prefill=False)
    flops = lightglue_flops(N, D, L) * len(pairs)
    bound_ms = 1e3 * flops / F32_OPS_PER_S
    bench = {"pairs": len(pairs), "keypoint_slots": N, "dim": D, "layers": L,
             "chunk_ms": chunk_ms, "chunk_ms_per_pair": chunk_ms / len(pairs),
             "network_ms": net_ms, "network_ms_per_pair": net_ms / len(pairs),
             "peak_transient_bytes": peak, "network_flops": flops,
             "network_tflop_s": flops / (net_ms * 1e-3) / 1e12,
             "f32_bound_ms": bound_ms, "share_of_f32_peak": bound_ms / net_ms}
    print("[neural chunk] " + json.dumps(bench), flush=True)
    timing = attention_timing(card)
    return {"phase": "neural", "card": card, "cli": cli, "lightglue": lg, "chunk": bench,
            "attention": timing}


def attention_timing(card: str) -> dict:
    """LightGlue's attention kernel at the neural cell's chunk
    (ATTENTION_SHAPE), self-attention (q, k, v of one set, every key valid)
    and cross-attention (keys of the other set, a tenth padded), q, k and v
    as the projections leave them: its device time back to back (CUDA
    events), its float32 bound (4 B H N^2 Dh operations at 67 TFLOP/s), the
    plain version's time, and scaled_dot_product_attention's math backend
    in float32 (library_ms: a yardstick the port never calls); the kernel's
    and the plain version's largest error against the plain version in
    float64."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, H, N, Dh = ATTENTION_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)

    def heads(x):
        return x.reshape(B, N, H, Dh).transpose(1, 2)

    q, k0, v0, k1, v1 = (heads(torch.randn((B, N, H * Dh), generator=g, device="cuda") * 2.0)
                         for _ in range(5))
    every = torch.ones((B, N), dtype=torch.bool, device="cuda")
    padded = torch.rand((B, N), generator=g, device="cuda") >= 0.1
    bound_ms = 1e3 * 4.0 * B * H * N * N * Dh / F32_OPS_PER_S
    out = {"shape": list(ATTENTION_SHAPE), "bound_ms": bound_ms, "bound_by": "float32 FMAs"}
    for name, kk, vv, valid in (("self", k0, v0, every), ("cross", k1, v1, padded)):
        mask = valid[:, None, None, :]

        def kernel():
            return attention_kernel.launch(q, kk, vv, valid)

        def plain():
            return attention_kernel.attention_plain(q, kk, vv, valid)

        def library():
            with sdpa_kernel(SDPBackend.MATH):
                return torch.nn.functional.scaled_dot_product_attention(q, kk, vv, attn_mask=mask)

        exact = attention_kernel.attention_plain(q.double(), kk.double(), vv.double(), valid)
        err = (kernel().double() - exact).abs().max().item()
        err_plain = (plain().double() - exact).abs().max().item()
        del exact
        attention_kernel.counts.reset()
        ms = cuda_ms(kernel, 20)
        launches = attention_kernel.counts.kernel
        out[name] = {"ms": ms, "share_of_bound": bound_ms / ms, "plain_ms": cuda_ms(plain, 10),
                     "library_ms": cuda_ms(library, 10), "max_abs_err": err,
                     "plain_max_abs_err": err_plain, "launches_timed": launches}
        if launches != 21 or err > 2.0 * err_plain + 1e-7:
            raise AssertionError(f"attention kernel ({name}): {out[name]}")
    print(json.dumps({"phase": "attention", "card": card, **out}), flush=True)
    return out

# SuperPoint's convolutions: name, in, out, kernel, the level's stride.
SP_CONVS = (("conv1a", 1, 64, 3, 1), ("conv1b", 64, 64, 3, 1), ("conv2a", 64, 64, 3, 2),
            ("conv2b", 64, 64, 3, 2), ("conv3a", 64, 128, 3, 4), ("conv3b", 128, 128, 3, 4),
            ("conv4a", 128, 128, 3, 8), ("conv4b", 128, 128, 3, 8), ("convPa", 128, 256, 3, 8),
            ("convPb", 256, 65, 1, 8), ("convDa", 128, 256, 3, 8), ("convDb", 256, 256, 1, 8))


def superpoint_flops(H: int, W: int) -> float:
    """Floating-point operations of SuperPoint's convolutions on one H x W
    image (2 k^2 C_in C_out a pixel of each level); ReLU, pooling and the
    descriptor normalisation are left out."""
    return sum(2.0 * k * k * ci * co * (H // s) * (W // s) for _, ci, co, k, s in SP_CONVS)


def _round_losses(stats: dict) -> np.ndarray:
    return np.concatenate([np.asarray(r["losses"], np.float64) for r in stats["rounds"]])


def _pretrain(args, out: Path, subprocess_run: bool = False) -> dict:
    """The pretraining CLI (`python -m recon3d_tpu_torch.neural.pretrain`),
    in a subprocess or in this process, writing `out` and its --stats-json;
    returns the stats with the host's wall time."""
    stats_path = out.with_suffix(".json")
    argv = [*args, "--out", str(out), "--stats-json", str(stats_path)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if subprocess_run:
        proc = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.neural.pretrain", *argv],
                              cwd=str(REPO), capture_output=True, text=True, timeout=600)
        print(proc.stdout[-2000:], end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"pretrain {args} returned {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
    else:
        from recon3d_tpu_torch.neural.pretrain import main as pretrain_main

        if pretrain_main(argv) != 0:
            raise AssertionError(f"pretrain {args} failed")
    torch.cuda.synchronize()
    st = json.loads(stats_path.read_text())
    st["host_wall_s"] = time.perf_counter() - t0
    losses = _round_losses(st)
    if not np.isfinite(losses).all():
        raise AssertionError(f"pretrain {args}: non-finite losses")
    return st


def _round_times(st: dict) -> dict:
    """A run's host seconds (rendering, pseudo-labels, extraction, ground
    truth) and device seconds (the steps, timed to the loss read-back) over
    its rounds, and the steps' rate."""
    keys = ("render_s", "label_s", "extract_s", "ground_truth_s", "train_s")
    t = {k: sum(r.get(k, 0.0) for r in st["rounds"]) for k in keys}
    t["steps"] = steps = sum(r["steps"] for r in st["rounds"])
    t["ms_a_step"] = 1e3 * t["train_s"] / steps
    t["steps_per_s"] = steps / t["train_s"]
    return t


def train_phase(work: Path, scene: dict, card: str, shapes: list) -> dict:
    """The neural front end's training path at full width: (a) SuperPoint
    from scratch, one round of 12 batches x 16 epochs at batch 32 of
    128x128 (the pretrain CLI in a subprocess); (b) the bundled fine-tune
    recipe, one round of homographic adaptation from the bundled
    checkpoint, whose .npz loads into NeuralMatcher with the trained
    module's forward; (c) LightGlue, one round of 8 x 8 steps at batch 16
    and 256 keypoints from the bundled SuperPoint, K1's counts set to 0
    just before and read just after; (d) one SuperPoint and one LightGlue
    step on the card against the CPU; (e) a public-layout LightGlue .pth
    on the card against the same weights through the .npz path."""
    from recon3d_tpu_torch import convert
    from recon3d_tpu_torch.config import NeuralConfig
    from recon3d_tpu_torch.neural.lightglue import LightGlueNet
    from recon3d_tpu_torch.neural import pretrain
    from recon3d_tpu_torch.neural.matcher import NeuralMatcher
    from recon3d_tpu_torch.neural.weights import load_lightglue_torch, save_params_npz
    from tests.torch_public_weights import lightglue_state_dict
    from tests.torch_train_check import (
        GRAD_TOL, LOSS_RTOL, card_against_cpu, lightglue_batch, lightglue_step, superpoint_step)

    tdir = work / "train"
    tdir.mkdir()
    report = {"phase": "train", "card": card}

    # (a) SuperPoint from scratch, through the module's entry point
    st = _pretrain(TRAIN_SP_ARGS, tdir / "sp_scratch.npz", subprocess_run=True)
    losses = _round_losses(st)[:, 0]
    first, last = losses[:16].mean(), losses[-16:].mean()
    flops = 2 * 32 * 3 * superpoint_flops(128, 128)   # 64 images, forward + backward
    a = {**_round_times(st), "wall_s": st["wall_s"], "process_wall_s": st["host_wall_s"],
         "peak_bytes": st["peak_bytes"], "loss_first16": first, "loss_last16": last,
         "k1": st["k1_calls_by_stage"], "gflop_a_step": flops / 1e9,
         }
    a["tflop_s"] = flops / (a["ms_a_step"] * 1e-3) / 1e12
    a["share_of_f32_peak"] = a["tflop_s"] * 1e12 / F32_OPS_PER_S
    print("[train superpoint] " + json.dumps(a), flush=True)
    if not last < first:
        raise AssertionError(f"train superpoint: the last 16 steps' loss {last:.4f} is not "
                             f"below the first 16 steps' {first:.4f}")
    if st["k1_calls_by_stage"]["train_superpoint"]["kernel"] != 0:
        raise AssertionError("train superpoint: K1 launched (dense descriptors need none)")
    report["superpoint"] = a

    # (b) the bundled fine-tune recipe, one round, through pretrain.run (the
    # CLI's own entry), so that the trained module is at hand
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = pretrain.run(pretrain.build_parser().parse_args(
        [*TRAIN_FINETUNE_ARGS, "--out", str(tdir / "sp_finetune.npz")]), stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(_round_losses(stats)).all():
        raise AssertionError("train finetune: non-finite losses")
    gray = scene["images"][0] @ np.array([0.299, 0.587, 0.114], np.float32)
    x = torch.from_numpy(np.ascontiguousarray(gray))[None, ..., None].cuda()
    nm = NeuralMatcher(NeuralConfig(superpoint_weights=str(out)), device="cuda")
    nm._ensure_params()
    with torch.no_grad():
        lt, dt = state.module(x)
        ln, dn = nm.sp(x)
    rng_l = float(lt.max() - lt.min())
    logit_err = float((ln - lt).abs().max()) / rng_l
    cos = (dn * dt).sum(-1)
    b = {**_round_times(stats), "wall_s": wall, "logit_err_of_range": logit_err,
         "desc_cos_min": float(cos.min()), "desc_cos_share_999": float((cos >= 0.999).float()
                                                                       .mean()),
         "loss_last": _round_losses(stats)[-1].tolist()}
    print("[train finetune] " + json.dumps(b), flush=True)
    if not (logit_err < FP16_LOGIT_TOL and b["desc_cos_share_999"] >= 0.99):
        raise AssertionError(f"train finetune: the written .npz's forward differs from the "
                             f"trained module's beyond float16 storage: {b}")
    report["finetune"] = b

    # (c) LightGlue, one round at full width, K1 counted
    warp.counts.reset()
    st = _pretrain(TRAIN_LG_ARGS, tdir / "lightglue.npz")
    launches, plain, by_shape = warp.counts.kernel, warp.counts.plain, dict(warp.counts.by_shape)
    k1 = st["k1_calls_by_stage"]
    check_k1_shapes(k1, shapes, "train lightglue")
    key = next(sh["shape_key"] for sh in shapes if sh["stage"] == "train_lightglue")
    images = 2 * TRAIN_LG_PAIRS * TRAIN_LG_BATCHES
    if launches != images or plain != 0 or by_shape != {key: images}:
        raise AssertionError(f"train lightglue: K1 launched {launches} times ({by_shape}), plain "
                             f"{plain}; expected {images} at {key}")
    gt = [r["gt_matches_per_pair"] for r in st["rounds"]]
    flops = 3 * TRAIN_LG_PAIRS * lightglue_flops(TRAIN_KEYPOINTS, 256, 9)
    c = {**_round_times(st), "wall_s": st["wall_s"], "peak_bytes": st["peak_bytes"],
         "gt_matches_per_pair": gt, "k1_launches": launches, "k1_plain_calls": plain,
         "k1": k1, "loss_last": _round_losses(st)[-1].tolist(), "gflop_a_step": flops / 1e9}
    c["tflop_s"] = flops / (c["ms_a_step"] * 1e-3) / 1e12
    c["share_of_f32_peak"] = c["tflop_s"] * 1e12 / F32_OPS_PER_S
    print("[train lightglue] " + json.dumps(c), flush=True)
    if not min(gt) > 0:
        raise AssertionError(f"train lightglue: no ground-truth match in a round ({gt})")
    report["lightglue"] = c

    # (d) one step of each on the card against the CPU
    d = {"superpoint": card_against_cpu(superpoint_step, "cuda"),
         "lightglue": card_against_cpu(lightglue_step, "cuda")}
    print("[train card-vs-cpu] " + json.dumps(
        {k: {f: v[f] for f in ("loss_rel_err", "grad_rel_err", "grad_worst")}
         for k, v in d.items()}), flush=True)
    for name, r in d.items():
        if not (r["finite"] and r["loss_rel_err"] < LOSS_RTOL and r["grad_rel_err"] < GRAD_TOL):
            raise AssertionError(f"train card-vs-cpu {name}: losses {r['loss_rel_err']:.2e} "
                                 f"(< {LOSS_RTOL}), gradients {r['grad_rel_err']:.2e} at "
                                 f"{r['grad_worst']} (< {GRAD_TOL})")
    report["card_vs_cpu"] = d

    # (e) a public LightGlue .pth on the card, against the same weights
    # through save_params_npz and the .npz path (the file's values are
    # float16-exact, so both carry identical weights)
    pth = tdir / "lightglue_public.pth"
    torch.save(lightglue_state_dict(seed=3), pth)
    from_pth = load_lightglue_torch(pth, LightGlueNet()).cuda().eval()
    save_params_npz(from_pth, str(tdir / "lightglue_public.npz"))
    from_npz = convert.load_params_npz(tdir / "lightglue_public.npz", LightGlueNet()).cuda().eval()
    data = lightglue_batch(np.random.default_rng(3), 1, 2, TRAIN_KEYPOINTS, 256)
    args = [torch.from_numpy(data[k][0]).cuda()
            for k in ("desc0", "desc1", "xy0n", "xy1n", "valid0", "valid1")]
    with torch.no_grad():
        la, m0, _ = from_pth(*args)
        lb, n0, _ = from_npz(*args)
    torch.cuda.synchronize()
    e = {"identical": bool(torch.equal(la, lb) and torch.equal(m0, n0)),
         "finite": bool(torch.isfinite(la[args[4][..., None] & args[5][:, None]]).all())}
    print("[train pth] " + json.dumps(e), flush=True)
    if not (e["identical"] and e["finite"]):
        raise AssertionError(f"train pth: the .pth and .npz paths differ on the card: {e}")
    report["pth"] = e
    return report


MD_VIEWS = 16   # the multi_device phase's cut of the north star
MD_GRIDS = {"tsdf_128": 2 * 128 ** 3, "tsdf_192": 2 * 192 ** 3}   # numerator + weight


def multi_device_phase(scene: dict, card: str, parts: str = "abc") -> dict:
    """The mesh (recon3d_tpu_torch/parallel/) on the one card, with the
    checks of tests/torch_mesh_check.py on the first MD_VIEWS north-star
    views at PatchMatch's scale and a 16-camera BA problem:
    (a) a world of 1 over NCCL: distributed_patchmatch, distributed_plane_
        sweep, fuse_tsdf(mesh=) and bundle_adjust(mesh=) bit-identical to
        one device;
    (b) a world of 2 sharing the card over gloo: the same four within the
        JAX mesh tests' bounds (PatchMatch's on the north-star cut and on
        that test's scene), match_pairs_batched bit-equal to one device,
        two make_pair_train_step steps (losses 1e-5 then 5e-3 relative,
        the first step's gradients within GRAD_TOL), K1 launched on both
        ranks (its plain version never), and the gloo all_reduce of a
        TSDF grid timed;
    (c) part (b) over NCCL on two cards, when two are visible."""
    from recon3d_tpu_torch.features.frontend import FeatureExtractor
    from recon3d_tpu_torch.parallel import make_mesh
    from recon3d_tpu_torch.parallel.workers import time_all_reduce
    from tests import torch_mesh_check as check

    inp = check.dense_inputs(scene, n_views=MD_VIEWS, scale=0.25)
    small = check.small_inputs()
    prob = check.ba_problem(0)
    gray = np.stack([im.mean(-1) for im in scene["images"][:8]]).astype(np.float32)
    feats = FeatureExtractor(device="cuda").extract_batch(gray)
    pairs = [(i, j) for i in range(8) for j in range(i + 1, min(8, i + 4))]
    out = {}
    if "a" in parts:
        out["a"] = world_of_one(inp, prob)
    else:
        print("[multi_device] (a) not asked for", flush=True)

    def world_of_two(**mesh_kw):
        launches = {}
        t0 = time.perf_counter()
        with make_mesh(devices=2, device="cuda", **mesh_kw) as mesh:
            t_up = time.perf_counter() - t0
            dense = check.check_dense(mesh, inp, "cuda", exact=False, launches=launches)
            dense["patchmatch_small_scene"] = check.check_patchmatch_bound(mesh, small, "cuda")
            ba = check.check_ba(mesh, prob, "cuda", exact=False)
            match = check.check_matching(mesh, feats, pairs, "cuda")
            train = check.check_train_step(mesh, "cuda")
            reduce_ms = {name: mesh.call(time_all_reduce, [{"n": n, "iters": 5}] * 2)[0]
                         for name, n in MD_GRIDS.items()}
            backend = mesh.backend
        by_rank = {stage: [{"kernel": r["kernel"], "plain": r["plain"]}
                           for r in rec["by_rank"]] for stage, rec in launches.items()}
        for stage, ranks in by_rank.items():
            if not all(r["kernel"] > 0 and r["plain"] == 0 for r in ranks):
                raise AssertionError(f"K1 on the mesh's ranks in {stage}: {ranks}")
        step_ms = {k: 1e3 * ba[k]["solve_fetch_s"] / max(ba[k]["iterations"], 1)
                   for k in ("single", "mesh")}
        return {"backend": backend, "wall_s": time.perf_counter() - t0, "spawn_s": t_up,
                "dense": dense, "ba": {k: v for k, v in ba.items() if k.endswith("err")},
                "ba_ms_per_iteration": step_ms, "match": match, "train": train,
                "all_reduce_ms": reduce_ms, "k1_by_rank": by_rank}

    if "b" not in parts:
        print("[multi_device] (b) not asked for", flush=True)
    else:
        out["b"] = world_of_two(share_device=True)
        _print_b(out["b"])
    if "c" not in parts:
        print("[multi_device] (c) not asked for", flush=True)
    elif torch.cuda.device_count() >= 2:
        out["c"] = world_of_two()
        _print_b(out["c"], "(c) world 2 on two cards")
    else:
        out["c"] = None
        print(f"[multi_device] (c) not run: {torch.cuda.device_count()} CUDA device "
              "visible, and part (b) over NCCL needs two cards", flush=True)
    return out


def world_of_one(inp: dict, prob: tuple) -> dict:
    """Part (a) of the multi_device phase: a world of 1 over NCCL."""
    from recon3d_tpu_torch.parallel import make_mesh
    from tests import torch_mesh_check as check

    t0 = time.perf_counter()
    with make_mesh(devices=1, device="cuda") as mesh:
        if mesh.backend != "nccl":
            raise AssertionError(f"(a): a world of 1 on the card runs over {mesh.backend}")
        dense = check.check_dense(mesh, inp, "cuda", exact=True)
        ba = check.check_ba(mesh, prob, "cuda", exact=True)
    out = {"wall_s": time.perf_counter() - t0, "dense": dense,
           "ba_iterations": ba["mesh"]["iterations"]}
    print(f"[multi_device] (a) world 1, NCCL: PatchMatch, sweep, TSDF and BA bit-identical "
          f"to one device ({out['wall_s']:.1f} s)", flush=True)
    return out


def _print_b(b: dict, what: str = "(b) world 2 sharing the card, gloo") -> None:
    print(f"[multi_device] {what} ({b['backend']}): PatchMatch bit-equal "
          f"{b['dense']['patchmatch_bit_equal']}, {b['dense']['patchmatch_agree_2e-3']:.4f} of "
          f"pixels within 2e-3 of the {MD_VIEWS}-view batch, "
          f"{b['dense']['patchmatch_small_scene']['agree_2e-3']:.4f} on the JAX test's scene; "
          f"sweep bit-equal {b['dense']['sweep_bit_equal']}; TSDF "
          f"{b['dense']['tsdf_max_abs_err']:.2e}, BA points {b['ba']['points_max_abs_err']:.2e}, "
          f"matching over {b['match']['pairs']} pairs bit-equal; train losses "
          f"{b['train']['rel_err']} relative (steps 1, 2), gradients "
          f"{b['train']['grad_max_rel_l2']:.2e} (relative L2, worst tensor); "
          f"K1 by rank {b['k1_by_rank']}; "
          f"all_reduce ms {b['all_reduce_ms']}; BA ms/iteration {b['ba_ms_per_iteration']} "
          f"({b['wall_s']:.1f} s, {b['spawn_s']:.1f} s to start the ranks)", flush=True)


# The calibration phase: CALIB_BOARDS chessboards of CALIB_PATTERN inner
# corners rendered at CALIB_SIZE through CALIB_K and the distortion of
# tests/test_calibration.py (DIST_GT), the poses drawn as that test draws
# them (tests/torch_chessboard.board_poses: the test's 240x320 geometry at
# twice the size). Gate of the card's calibrate_camera_robust against the
# truth: fx, fy within 1%, cx, cy within 2 px, k1, k2 within 0.01, overall
# RMS under 0.5 px (the JAX test's bound).
CALIB_PATTERN, CALIB_SIZE, CALIB_BOARDS = (9, 6), (480, 640), 20
CALIB_K = np.array([[600.0, 0, 320.0], [0, 596.0, 240.0], [0, 0, 1]], np.float32)
CALIB_DIST = np.array([-0.12, 0.05, 0.001, -0.0015, 0.0], np.float32)
CALIB_GATE = {"f_rel": 0.01, "c_px": 2.0, "dist_atol": 0.01, "rms_px": 0.5}
# The card against the CPU: corners within 1e-3 px, or within 1.5 times the
# CPU's own spread under a 2^-22 scaling of the board where two peak pixels
# nearly tie (tests/test_torch_calib.py); K within 1e-4 relative.
CALIB_CORNER_TOL, CALIB_K_RTOL = 1e-3, 1e-4


def calibration_phase(work: Path, card: str, shapes: list) -> dict:
    """recon3d_tpu_torch.calib on the card: CALIB_BOARDS rendered boards
    (tests/torch_chessboard.py, no JAX), calibrate_camera_robust with K1's
    counts set to 0 just before and read just after (4 launches a board at
    the refinement shape, none plain), gated at CALIB_GATE; the same call on
    the CPU, K within CALIB_K_RTOL; every board's corners from
    find_chessboard on the card against the CPU's; each step timed on both
    by calibrate_camera_robust's StageTimer; save_calibration ->
    load_calibration -> validate_calibration; the module CLI on the PNGs."""
    from PIL import Image

    from recon3d_tpu_torch.calib import calibrate as cal
    from recon3d_tpu_torch.calib import corners as cor
    from recon3d_tpu_torch.calib.validate import validate_calibration
    from recon3d_tpu_torch.camera import load_calibration
    from recon3d_tpu_torch.runtime.profiling import StageTimer
    from tests.torch_chessboard import board_poses, render_chessboard

    t0 = time.perf_counter()
    poses, truth = board_poses(CALIB_BOARDS, CALIB_K, CALIB_DIST, CALIB_SIZE, CALIB_PATTERN)
    images = [render_chessboard(CALIB_K, CALIB_DIST, r, t, CALIB_SIZE, CALIB_PATTERN)
              for r, t in poses]
    render_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    warp.counts.reset()
    t0 = time.perf_counter()
    res = cal.calibrate_camera_robust(images, CALIB_PATTERN, min_images=10, verbose=False,
                                      device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = warp.counts.kernel, warp.counts.plain
    by_stage = {"calibration": {"kernel": launches, "plain": plain,
                                "kernel_by_shape": dict(warp.counts.by_shape),
                                "kernel_by_variant": dict(warp.counts.by_variant)}}
    timers = {"cuda": StageTimer(), "cpu": StageTimer()}
    t0 = time.perf_counter()
    cal.calibrate_camera_robust(images, CALIB_PATTERN, min_images=10, verbose=False,
                                device="cuda", timer=timers["cuda"])
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_cpu = cal.calibrate_camera_robust(images, CALIB_PATTERN, min_images=10, verbose=False,
                                          device="cpu", timer=timers["cpu"])
    wall_cpu = time.perf_counter() - t0

    if res is None or res_cpu is None:
        raise AssertionError("calibration: no calibration on the card or the CPU")
    K, dist = res["K"], res["dist"]
    failed = []
    for i, name in ((0, "fx"), (1, "fy")):
        if not abs(K[i, i] - CALIB_K[i, i]) / CALIB_K[i, i] < CALIB_GATE["f_rel"]:
            failed.append(f"{name} {K[i, i]:.3f}")
    for i, name in ((0, "cx"), (1, "cy")):
        if not abs(K[i, 2] - CALIB_K[i, 2]) < CALIB_GATE["c_px"]:
            failed.append(f"{name} {K[i, 2]:.3f}")
    if not np.abs(dist[:2] - CALIB_DIST[:2]).max() < CALIB_GATE["dist_atol"]:
        failed.append(f"dist {dist[:2]}")
    if not res["overall_rms"] < CALIB_GATE["rms_px"]:
        failed.append(f"rms {res['overall_rms']:.4f} px")
    k_rel = float(np.abs(K - res_cpu["K"]).max() / np.abs(res_cpu["K"]).max())
    if res["used_indices"] != res_cpu["used_indices"] or not k_rel < CALIB_K_RTOL:
        failed.append(f"card against CPU: used {res['used_indices']} / "
                      f"{res_cpu['used_indices']}, K {k_rel:.2e} relative")
    n_found = len(res["used_indices"])
    key = f"2x{CALIB_SIZE[0]}x{CALIB_SIZE[1]}/1x{CALIB_PATTERN[0] * CALIB_PATTERN[1] * 121}"
    if plain != 0 or by_stage["calibration"]["kernel_by_shape"].get(key, 0) < 4 * n_found:
        failed.append(f"K1: {by_stage['calibration']}, {n_found} boards")
    check_k1_shapes(by_stage, shapes, "calibration")

    corners = {dev: [cor.find_chessboard(img, CALIB_PATTERN, device=dev) for img in images]
               for dev in ("cuda", "cpu")}
    corner_err, spread = [], {}
    for b, (c_card, c_cpu) in enumerate(zip(corners["cuda"], corners["cpu"])):
        if c_card is None or c_cpu is None:
            failed.append(f"board {b}: found on the card {c_card is not None}, "
                          f"on the CPU {c_cpu is not None}")
            continue
        err = float(np.abs(c_card - c_cpu).max())
        corner_err.append(err)
        if err > CALIB_CORNER_TOL:
            spread[b] = max(float(np.abs(cor.find_chessboard(np.float32(images[b] * s),
                                                             CALIB_PATTERN, device="cpu")
                                         - c_cpu).max()) for s in (1 + 2 ** -22, 1 - 2 ** -22))
            if not err <= 1.5 * spread[b]:
                failed.append(f"board {b}: corners {err:.2e} px from the CPU's "
                              f"(its own spread {spread[b]:.2e})")
    truth_err = float(np.median([np.median(np.linalg.norm(c - t, axis=1))
                                 for c, t in zip(corners["cuda"], truth)
                                 if c is not None]))

    out_dir = work / "calibration"
    cal.save_calibration(str(out_dir), res)
    loaded = load_calibration(str(out_dir / "calibration_data.npz"))
    if not np.allclose(loaded.K.cpu().numpy(), K, rtol=1e-6):
        failed.append("load_calibration does not read back K")
    used = [images[i] for i in res["used_indices"]]
    errors = validate_calibration(used, K, dist, res["rvecs"], res["tvecs"], CALIB_PATTERN,
                                  verbose=False, device="cuda")
    valid = errors[~np.isnan(errors)]
    if not (len(valid) >= 10 and np.median(valid) < 1.0):
        failed.append(f"validate_calibration: {errors}")

    png_dir = work / "boards"
    png_dir.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(np.uint8(np.round(img * 255))).save(png_dir / f"board_{i:02d}.png")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.calib.calibrate", str(png_dir),
                        "-o", str(work / "calib_cli")], cwd=str(REPO),
                       capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0 or not (work / "calib_cli" / "calibration_data.npz").exists():
        failed.append(f"the module CLI: exit {r.returncode}: {r.stdout[-2000:]}{r.stderr[-2000:]}")
    cli_K = np.load(work / "calib_cli" / "calibration_data.npz")["mtx"] if r.returncode == 0 \
        else None

    report = {
        "phase": "calibration", "card": card, "boards": CALIB_BOARDS,
        "image_size": list(CALIB_SIZE), "render_s": render_s,
        "wall_s": wall, "wall_warm_s": wall_warm, "wall_cpu_s": wall_cpu, "used": n_found,
        "K": K.tolist(), "dist": dist.tolist(), "overall_rms": res["overall_rms"],
        "K_cpu": res_cpu["K"].tolist(), "K_rel_card_cpu": k_rel,
        "corner_err_card_cpu_px": corner_err, "cpu_spread_px": spread,
        "corner_err_truth_median_px": truth_err,
        "seconds": {dev: t.as_dict() for dev, t in timers.items()},
        "validate_median_px": float(np.median(valid)) if len(valid) else None,
        "cli_s": cli_s, "cli_K": None if cli_K is None else cli_K.tolist(),
        "k1_by_stage": by_stage,
    }
    print(json.dumps(report), flush=True)
    print(f"[calibration] on {card}: {n_found}/{CALIB_BOARDS} boards, fx {K[0, 0]:.3f} fy "
          f"{K[1, 1]:.3f} cx {K[0, 2]:.3f} cy {K[1, 2]:.3f} k1 {dist[0]:.4f} k2 {dist[1]:.4f}, "
          f"rms {res['overall_rms']:.4f} px; card {wall:.2f} s (again: {wall_warm:.2f}), CPU "
          f"{wall_cpu:.2f} s; steps "
          + "; ".join(f"{dev} " + ", ".join(f"{k} {v:.3f}" for k, v in t.as_dict().items())
                      for dev, t in timers.items())
          + f" s; corners card-CPU max {max(corner_err):.2e} px; K1 {launches} launches",
          flush=True)
    if failed:
        raise AssertionError("calibration fails its gate: " + "; ".join(failed))
    return report


def _socket_path() -> str:
    import os
    import uuid

    d = tempfile.gettempdir()
    return os.path.join(d if len(d) <= 60 else "/tmp", f"r3d_{uuid.uuid4().hex[:8]}.sock")


def _pong(sock: str) -> dict:
    import socket

    from recon3d_tpu_torch.runtime import serve

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(600.0)
        s.connect(sock)
        serve._send(s, {"ping": True})
        return json.loads(s.makefile("r").readline())


SERVE_READ_TIMEOUT_S = 3.0


def serve_phase(work: Path, scene: dict, card: str, shapes: list) -> dict:
    """The serve daemon (`python -m recon3d_tpu_torch.serve`) on the card:
    seconds to its first pong; two identical requests of the north-star
    `IMAGES --mvs --calibration K` through serve.request, each gated at
    SFM_SPARSE_GATE and CLI_DENSE_GATE, with K1 at the kernel phase's
    shapes and no plain call, their sparse.ply and dense_mvs.ply equal bit
    for bit; the same argv as a fresh CLI process; a 16-view request
    through ReconstructionWorker, its dense_mvs.ply found and rendered;
    then the faults the daemon must survive: a bad argv, a client that
    closes after sending, a silent connection, and a second daemon started
    on the socket while a request runs (the daemon held stopped until the
    second one exits). Shut down, the socket gone."""
    import filecmp
    import os
    import signal
    import socket
    import threading

    from PIL import Image

    from recon3d_tpu_torch.gui.app import find_result_file
    from recon3d_tpu_torch.gui.viewer import render_turntable
    from recon3d_tpu_torch.runtime import serve
    from recon3d_tpu_torch.runtime.worker import ReconstructionWorker

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sock = _socket_path()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    log = open(work / "serve.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "recon3d_tpu_torch.serve", "--socket", sock,
                             "--quiet", "--read-timeout", str(SERVE_READ_TIMEOUT_S)],
                            cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
    out = {"phase": "serve", "card": card, "socket": sock}
    try:
        while not serve.ping(sock, timeout=1.0):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError(f"serve: the daemon did not come up "
                                     f"({(work / 'serve.log').read_text()[-3000:]})")
            time.sleep(0.05)
        out["first_pong_s"] = time.perf_counter() - t0

        def argv(name):
            d = work / name
            return [str(work / "images"), "--mvs", "--calibration", str(work / "calibration.npz"),
                    "--output", str(d), "--stats-json", str(d / "stats.json")]

        def submit(name):
            logs = []
            t = time.perf_counter()
            rc = serve.request(argv(name), sock, on_log=logs.append)
            wall = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f"serve {name}: exit {rc}: " + "\n".join(logs[-30:]))
            d = work / name
            st = json.loads((d / "stats.json").read_text())
            poses = read_poses(d / "poses.npz")
            errs = pose_errors(poses, scene)
            check_sparse(st, errs, SFM_SPARSE_GATE, f"serve {name}")
            dense, _ = load_ply(str(d / "dense_mvs.ply"))
            med, share = gate(to_scene_frame(dense, poses, scene), *CLI_DENSE_GATE, f"serve {name}")
            k1 = st["k1_calls_by_stage"]
            check_k1_shapes(k1, shapes, f"serve {name}")
            if k1.get("patchmatch_mvs", {}).get("kernel", 0) == 0:
                raise AssertionError(f"serve {name}: K1 never launched by PatchMatch")
            if st["device"] == "cpu":
                raise AssertionError(f"serve {name}: ran on the CPU")
            return {"wall_s": wall, "num_cameras": st["num_cameras"],
                    "mean_reproj_px": st["mean_reproj_px"], "pose_errors": errs,
                    "dense_points": len(dense), "dense_median": med, "dense_share": share,
                    "stage_times_s": st["stage_times_s"], "k1_by_stage": k1,
                    "pointcloud_calls": pointcloud_calls(st, f"serve {name}")}

        out["request1"] = submit("serve_r1")
        out["request2"] = submit("serve_r2")
        same = {f: filecmp.cmp(work / "serve_r1" / f, work / "serve_r2" / f, shallow=False)
                for f in ("sparse.ply", "dense_mvs.ply")}
        out["identical"] = same

        fresh = argv("serve_fresh")
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.cli", *fresh], cwd=str(REPO),
                           env=env, capture_output=True, text=True, timeout=900)
        out["fresh_process_s"] = time.perf_counter() - t
        if r.returncode != 0:
            raise AssertionError(f"serve: the fresh CLI process failed: {r.stdout[-2000:]}"
                                 f"{r.stderr[-2000:]}")
        out["fresh_stage_times_s"] = json.loads(
            (work / "serve_fresh" / "stats.json").read_text())["stage_times_s"]
        print(f"[serve] on {card}: first pong {out['first_pong_s']:.2f} s; request 1 (cold) "
              f"{out['request1']['wall_s']:.2f} s, request 2 (warm) "
              f"{out['request2']['wall_s']:.2f} s, a fresh CLI process "
              f"{out['fresh_process_s']:.2f} s (client-side wall); outputs of the two requests "
              f"identical: {same}", flush=True)

        logs, statuses, done = [], [], []
        w = ReconstructionWorker(on_log=logs.append, on_status=statuses.append,
                                 on_finished=done.append)
        t = time.perf_counter()
        ok = w.run(str(work / "images"), {"mvs": True, "max_images": 16,
                                          "output": str(work / "serve_r3"),
                                          "serve_socket": sock, "serve_autostart": False})
        out["worker_s"] = time.perf_counter() - t
        result = find_result_file(str(work / "serve_r3"))
        if not (ok and done == [True] and "Step 4/4: Dense Reconstruction..." in statuses
                and result and result.endswith("dense_mvs.ply")):
            raise AssertionError(f"serve: the worker's request: ok {ok}, statuses {statuses}, "
                                 f"result {result}: " + "\n".join(logs[-30:]))
        frames = render_turntable(result, str(work / "turntable"), n_frames=4,
                                  image_size=(240, 320))
        background = int(0.08 * 255)
        for f in frames:
            if not (np.asarray(Image.open(f)) != background).any():
                raise AssertionError(f"serve: turntable frame {f} is background only")
        out["worker_statuses"] = statuses

        # the faults: a bad argv
        rc = serve.request(["/nonexistent/images", "--fast"], sock)
        if rc == 0 or not serve.ping(sock):
            raise AssertionError(f"serve: a bad argv returned {rc} or took the daemon down")
        # a client that closes right after sending a short request
        served = _pong(sock)["requests_served"]
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock)
            serve._send(s, {"argv": [str(work / "images"), "--fast", "--max-images", "6",
                                     "--output", str(work / "serve_gone")]})
        pong = _pong(sock)
        while pong["requests_served"] == served:
            time.sleep(0.2)
            pong = _pong(sock)
        if pong["requests_served"] != served + 1 or not (work / "serve_gone" / "sparse.ply").exists():
            raise AssertionError(f"serve: the vanished client's job: {pong}")
        # a connection that sends nothing
        dropped = pong["dropped"]
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(60.0)
            s.connect(sock)
            t = time.perf_counter()
            eof = s.recv(1) == b""
            waited = time.perf_counter() - t
        pong = _pong(sock)
        if not (eof and pong["dropped"] == dropped + 1
                and SERVE_READ_TIMEOUT_S * 0.9 <= waited < SERVE_READ_TIMEOUT_S + 30):
            raise AssertionError(f"serve: the silent connection: eof {eof}, {waited:.2f} s, {pong}")
        out["silent_dropped_after_s"] = waited
        # a second daemon on the socket while request 4 runs. Once request 4
        # holds the daemon, the daemon is stopped (SIGSTOP) until the second
        # daemon has exited, so the request is still running when the second
        # daemon probes, however long its start or the request takes
        r4 = {}
        argv4 = argv("serve_r4") + ["--mesh", "--stereo", "--export-colmap"]
        th = threading.Thread(target=lambda: r4.update(rc=serve.request(argv4, sock)))
        t4 = time.perf_counter()
        th.start()
        t = time.perf_counter()
        while serve.probe(sock, timeout=0.5) != "busy":
            if not th.is_alive() or time.perf_counter() - t > 60:
                raise AssertionError(f"serve: request 4 {r4} never held the daemon")
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGSTOP)
        try:
            if not th.is_alive():
                raise AssertionError(f"serve: request 4 {r4} ended before the daemon was held")
            t = time.perf_counter()
            second = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.serve", "--socket",
                                     sock], cwd=str(REPO), env=env, capture_output=True,
                                    text=True, timeout=300)
            out["second_daemon_s"] = time.perf_counter() - t
        finally:
            os.kill(proc.pid, signal.SIGCONT)
        th.join(timeout=900)
        out["request4_s"] = time.perf_counter() - t4
        if not (second.returncode != 0 and "another server is live" in second.stderr
                and "(busy)" in second.stderr):
            raise AssertionError(f"serve: a second daemon: exit {second.returncode}, "
                                 f"{second.stderr[-2000:]}")
        if r4.get("rc") != 0 or not serve.ping(sock) or not os.path.exists(sock):
            raise AssertionError(f"serve: request 4 {r4} or the daemon after the second daemon")
        out["request4_sparse_identical"] = filecmp.cmp(
            work / "serve_r1" / "sparse.ply", work / "serve_r4" / "sparse.ply", shallow=False)
        out["second_daemon"] = second.stderr.strip().splitlines()[-1]
        out["final_pong"] = _pong(sock)
        if not serve.shutdown(sock):
            raise AssertionError("serve: shutdown not acknowledged")
        rc = proc.wait(timeout=60)
        if rc != 0 or os.path.exists(sock):
            raise AssertionError(f"serve: the daemon exited {rc}; socket left: "
                                 f"{os.path.exists(sock)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    print(json.dumps(out), flush=True)
    print(f"[serve] worker request (16 views) {out['worker_s']:.2f} s; faults survived: a bad "
          f"argv, a vanished client, a silent connection (dropped after "
          f"{out['silent_dropped_after_s']:.2f} s), a second daemon ({out['second_daemon']}); "
          f"request 4 (--mesh --stereo --export-colmap) {out['request4_s']:.2f} s, its sparse.ply "
          f"identical to request 1's: {out['request4_sparse_identical']}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"serve: two identical requests differ: {same}")
    return out


def robustness_phase(work: Path, card: str, shapes: list) -> dict:
    """tests/test_robustness.py's distorted capture on the card
    (tests/torch_robust_check.py): rendered through the lens without JAX,
    written as PNGs, loaded with the lens as calibration (K1's counts set
    to 0 just before the load and read just after: the undistortion's one
    launch, at a kernel-phase shape in the planner's variant, no plain
    call), reconstructed and held to the JAX test's gates."""
    from tests.torch_robust_check import GATE, check_gate, distorted_capture

    out = distorted_capture(work / "robustness", "cuda")
    failed = check_gate(out)
    check_k1_shapes(out["k1_by_stage"], shapes, "robustness")
    load = out["k1_by_stage"]["load"]
    if load["kernel"] != 1:
        failed.append(f"K1 at the load: {load}")
    out["card"] = card
    print(json.dumps({"phase": "robustness", **out}), flush=True)
    sec = out["seconds"]
    print(f"[robustness] distorted capture on {card}: {out['num_cameras']} cameras, "
          f"{out['mean_reproj_px']:.4f} px, median relative rotation error "
          f"{out['median_rel_rot_deg']:.4f} deg (gates >= {GATE['min_cameras']}, < "
          f"{GATE['mean_reproj_px']}, < {GATE['median_rel_rot_deg']}); K1 at the load "
          f"{load['kernel_by_shape']} ({load['kernel_by_variant']}), plain {load['plain']}; "
          f"render {sec['render']:.2f} s, load {sec['load']:.3f} s, SfM {sec['sfm']:.2f} s",
          flush=True)
    if failed:
        raise AssertionError("robustness fails its gate: " + "; ".join(failed))
    return out


def bench_phase(card: str, shapes: list) -> dict:
    """The port's two benchmark scripts in this process: bench_cuda.main at
    1 window of 4 repetitions, the same 4 calls once more under the
    profiler (the device's busy and idle share of the window), and
    scripts/bench_stages_torch.py --quick without its patchmatch stage,
    which would run bench_cuda.main once more at the same settings. Their
    JSON lines are printed; each value must be finite and positive, and
    every K1 launch of the timed windows (bench_cuda) and of each stage
    (warm-up included) at a kernel-phase shape in the planner's variant,
    the plain version never called."""
    import contextlib
    import importlib.util
    import io

    import bench_cuda

    pointcloud.reset_counts()
    row = bench_cuda.main(["--windows", "1", "--reps", "4"])
    run = bench_cuda.make_run(bench_cuda.V, bench_cuda.PATCH, bench_cuda.NUM_ITERATIONS,
                              torch.device("cuda"))
    profile = profile_run(lambda: [run(r + 1) for r in range(4)], row["windows_s"][0],
                          "bench_cuda, 4 calls", "tent_warp", top=6)
    spec = importlib.util.spec_from_file_location(
        "bench_stages_torch", REPO / "scripts" / "bench_stages_torch.py")
    stages = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stages)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = stages.main(["--quick", "--skip", "patchmatch"])
    stages_s = time.perf_counter() - t0
    searches = pointcloud.snapshot()
    print(buf.getvalue(), end="", flush=True)
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    failed = [] if rc == 0 else [f"bench_stages_torch exited {rc}"]
    for r in [row] + lines:
        if not (math.isfinite(r["value"]) and r["value"] > 0):
            failed.append(f"{r['metric']}: {r['value']}")
    metrics = [r["metric"] for r in lines]
    if metrics != ["sift_extract", "match_verify", "plane_sweep", "bundle_adjust_full",
                   "tsdf_integration"]:
        failed.append(f"bench_stages_torch printed {metrics}")
    names = ["patchmatch"] + [n for n in stages.STAGES if n != "patchmatch"]
    by_stage = {f"bench_{name}": {"kernel": r["k1_launches"], "plain": r["k1_plain"],
                                  "kernel_by_shape": r["k1_by_shape"],
                                  "kernel_by_variant": r["k1_by_variant"]}
                for name, r in zip(names, [row] + lines)}
    check_k1_shapes(by_stage, shapes, "bench")
    idle = [k for k in ("bench_patchmatch", "bench_sweep", "bench_tsdf")
            if not by_stage.get(k, {}).get("kernel")]
    if idle:
        failed.append(f"K1 never launched in {idle}")
    if any(c["plain"] for c in searches.values()):
        failed.append(f"the plain versions of K2/K3 ran: {searches}")
    print(f"[bench] on {card}: bench_cuda {row['value']:.4f} {row['unit']} (windows "
          f"{row['windows_s']}), bench_stages_torch --quick {stages_s:.1f} s: "
          + ", ".join(f"{r['metric']} {r['value']:.4g} {r['unit']}" for r in lines)
          + "; K1 launches " + ", ".join(f"{k} {v['kernel']}" for k, v in by_stage.items())
          + f"; K2/K3 launches and plain calls {searches}", flush=True)
    if failed:
        raise AssertionError("bench: " + "; ".join(failed))
    return {"bench_cuda": row, "bench_cuda_profile": profile, "stages": lines,
            "k1_by_stage": by_stage, "pointcloud_calls": searches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, metavar="DIR",
                    help="also time the K2 and K3 of the checkout DIR (pointcloud phase)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # every kernel's library at once, one compiler each (and the host C++)
    from concurrent.futures import ThreadPoolExecutor

    from recon3d_tpu_torch.runtime import native

    t_build = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        builds = [(name, pool.submit(fn)) for name, fn in (
            ("nvcc", warp.build), ("nvcc", pointcloud.build), ("nvcc", bundle_kernels.build),
            ("nvcc", attention_kernel.build), ("g++", native.build))]
        for tool, future in builds:
            lib_path, build_s, log = future.result()
            print(f"[build] {lib_path.name}: {build_s:.2f} s with {tool}"
                  + (" (already built)" if build_s == 0.0 else ""), flush=True)
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "entry function" in line:
                    print(f"[build] {line.strip()}")
    print(f"[build] all libraries in {time.perf_counter() - t_build:.2f} s", flush=True)

    phase_s = {}

    def phase(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    t_start = time.perf_counter()
    shapes = phase("kernels", kernel_phase)
    phase("small_scene", small_scene_check)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        scene = phase("render", render_north_star, work)
        phase("dense_from_colmap", main_path, work, card)
        phase("sfm_front", sfm_front, work, scene, card)
        phase("sfm_sparse", sfm_sparse, work, scene, card)
        images = phase("cli_images", cli_images, work, scene, card)
        stereo = phase("stereo", stereo_run, work, card)
        phase("dense_profile", dense_profile, work, images)
        dsift = phase("dense_sift", dense_sift_phase, work, scene, card)
        searches = phase("pointcloud", pointcloud_phase, images, dsift, card,
                         None if args.against is None else args.against.resolve())
        del images["captured"], dsift["captured"]
        ba = phase("bundle", bundle_phase, card)
        ckpt = phase("checkpoint", checkpoint_phase, work, card)
        gsfm = phase("global_sfm", global_sfm_phase, work, scene, card, shapes)
        neural = phase("neural", neural_phase, work, scene, card, shapes)
        trained = phase("train", train_phase, work, scene, card, shapes)
        md = phase("multi_device", multi_device_phase, scene, card)
        calib = phase("calibration", calibration_phase, work, card, shapes)
        served = phase("serve", serve_phase, work, scene, card, shapes)
        robust = phase("robustness", robustness_phase, work, card, shapes)
    phase("rescue", rescue_phase, card)
    phase("dense_sift_budget", dense_sift_budget, card)
    bench = phase("bench", bench_phase, card, shapes)
    print("[time] phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {time.perf_counter() - t_start:.1f} s", flush=True)

    # Launches at each shape of the kernel phase: on the main path
    # (cli_images), on the neural path (SuperPoint's shape), on the
    # training path (LightGlue's training shape), in calibration (the
    # refinement's shape), at the robustness phase's load (the
    # undistortion's shape) and in the bench phase (its scripts' shapes).
    neural_k1 = neural["cli"]["k1_by_stage"]
    train_k1 = trained["lightglue"]["k1"]
    calib_k1 = calib["k1_by_stage"]
    robust_k1 = robust["k1_by_stage"]
    bench_k1 = bench["k1_by_stage"]
    serve_k1 = {name: served[name]["k1_by_stage"] for name in ("request1", "request2")}
    run_keys = ("launches", "neural_run_launches", "train_run_launches",
                "calibration_run_launches", "robustness_run_launches", "bench_run_launches")
    for sh in shapes:
        for key, by_stage in zip(run_keys, (images["k1_by_stage"], neural_k1, train_k1,
                                            calib_k1, robust_k1, bench_k1)):
            sh[key] = by_stage.get(sh["stage"], {}).get("kernel_by_shape", {}).get(
                sh["shape_key"], 0)
    unseen = [sh["shape_key"] for sh in shapes if not any(sh[k] for k in run_keys)]
    if unseen:
        raise AssertionError(f"the main paths never launched K1 at the kernel phase's "
                             f"shapes {unseen}: {images['k1_by_stage']}, {neural_k1}, "
                             f"{train_k1}, {calib_k1}, {robust_k1}, {bench_k1}")
    # every launch at a kernel-phase shape, in the variant the planner
    # picks there (the neural and training runs' were checked in their phases)
    check_k1_shapes(images["k1_by_stage"], shapes, "cli_images")
    by_variant = {}
    for st in (list(images["k1_by_stage"].values()) + list(neural_k1.values())
               + list(train_k1.values()) + list(calib_k1.values())
               + list(robust_k1.values()) + list(bench_k1.values())
               + [v for k1 in serve_k1.values() for v in k1.values()]):
        for v, n in st["kernel_by_variant"].items():
            by_variant[v] = by_variant.get(v, 0) + n
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
        "launches": (images["k1_launches"] + neural["cli"]["k1_launches"]
                     + trained["lightglue"]["k1_launches"]
                     + calib_k1["calibration"]["kernel"] + robust_k1["load"]["kernel"]
                     + sum(v["kernel"] for k1 in serve_k1.values() for v in k1.values())
                     + sum(v["kernel"] for v in bench_k1.values())),
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "variants": variants, "shapes": shapes,
        "launches_by_stage": images["k1_by_stage"],
        "stereo_run_launches": stereo["k1_by_stage"],
        "dense_sift_run_launches": dsift["k1_by_stage"],
        "checkpoint_run_launches": {name: r["k1_by_shape"]
                                    for name, r in ckpt["runs"].items()},
        "neural_run_launches": neural_k1,
        "global_sfm_run_launches": gsfm["cli"]["k1_by_stage"],
        "train_run_launches": train_k1,
        "multi_device_run_launches_by_rank": md["b"]["k1_by_rank"],
        "calibration_run_launches": calib_k1,
        "serve_run_launches": serve_k1,
        "robustness_run_launches": robust_k1,
        "bench_run_launches": bench_k1,
    }]
    # K2 and K3: launches on the paths that run them (dense SIFT's filter,
    # the main path's mesh colours), none on the others', no plain call.
    # `calls` counts the wrapper's calls, `launches` its kernels' launches:
    # K3's call launches two (the stages, the walks), each timed apart.
    later = {"stereo": stereo["pointcloud_calls"],
             "checkpoint": {name: r["pointcloud_calls"] for name, r in ckpt["runs"].items()},
             "global_sfm": gsfm["cli"]["pointcloud_calls"],
             "neural": neural["cli"]["pointcloud_calls"],
             "serve": {name: served[name]["pointcloud_calls"]
                       for name in ("request1", "request2")},
             "bench": bench["pointcloud_calls"]}
    for name, source, calls, per_call, key in (
            ("knn_mean_dist", K2_SOURCE, dsift["k2_launches"], 1, "dense_sift"),
            ("nearest_index", K3_SOURCE, images["k3_launches"], 2, "cli_images")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": K2_REPLACES if name == "knn_mean_dist" else K3_REPLACES,
            "launches": calls * per_call, "calls": calls, "launches_on": key,
            **{f: searches[name][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "ms_by_kernel")},
            "measured": searches[name],
            "dense_sift_run_calls": dsift["pointcloud_calls"][name],
            "cli_images_run_calls": images["pointcloud_calls"][name],
            "other_runs_calls": later})
    # The bundle adjustment kernels: the launches and LM steps of each SfM
    # run on the main paths (every LM step on the kernels), and one step at
    # DTU's size against the plain version.
    kernels.append({
        "name": "bundle_lm_step", "route": "cuda", "source": BUNDLE_SOURCE,
        "replaces": BUNDLE_REPLACES, "max_abs_err": None,
        "cli_images_run": images["bundle_kernels"], "global_sfm_run": gsfm["bundle_kernels"],
        "global_sfm_cli_run": gsfm["cli"]["bundle_kernels"],
        "neural_cli_run": neural["cli"]["bundle_kernels"],
        "ms": ba["step_ms"], "device_ms": ba["step_device_ms"], "plain_ms": ba["plain_step_ms"],
        "bound_ms": sum(k["bound_us"] * k["launches_a_step"] for k in ba["kernels"].values()) / 1e3,
        "bound_by": "bytes", "library_ms": None, "measured": ba})
    # LightGlue's attention: the LightGlue run's launches (4 a layer of every
    # LightGlueNet run) and the kernel at the neural cell's chunk.
    at = neural["attention"]
    kernels.append({
        "name": "lightglue_attention", "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "max_abs_err": at["cross"]["max_abs_err"],
        "lightglue_run_launches": neural["lightglue"]["attention_launches"],
        "ms": at["self"]["ms"], "plain_ms": at["self"]["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": at["self"]["library_ms"], "measured": at})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
