"""Unified configuration tree for the whole framework.

PyTorch port: a verbatim copy of recon3d_tpu/config.py (pure Python), kept
here so the port never imports the JAX package.

The reference scatters configuration over argparse flags, constructor
defaults, and GUI widget state (SURVEY.md §5; reference
run_reconstruction.py:25-44, mvs_patchmatch.py:43-50, dense_stereo.py:32-37,
features.py:47-109, sfm_pipeline.py:54-62). Here it is one frozen dataclass
tree; every stage takes its config section explicitly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SiftConfig:
    """SIFT extraction (reference features.py:47-90, sfm_pipeline.py:54-59)."""

    max_features: int = 8000          # padded keypoint capacity per image
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma: float = 1.6
    contrast_threshold: float = 0.03
    edge_threshold: float = 15.0
    clahe: bool = True
    clahe_clip: float = 2.0
    clahe_grid: int = 8
    patch_size: int = 16              # descriptor sampling patch (4x4 cells)
    descriptor_max_value: float = 0.2
    # Emit extra keypoints at secondary orientation peaks >= 0.8x the
    # dominant one, like OpenCV (reference features.py:52). Off by default:
    # +~25% descriptor cost, only pays on rotation-rich (high-roll) captures
    # — the arc captures this pipeline targets gain nothing (measured,
    # tests/test_sift.py::test_multi_orientation_rolled_pair).
    multi_orientation: bool = False
    # Start the pyramid one octave below the image (2x bilinear upsample),
    # OpenCV SIFT's default (firstOctave=-1). On REAL photographs this is
    # where most of the detector-count difference vs OpenCV lives: kitchen
    # JPG at 640px measures 323 keypoints without vs 1,089 with (OpenCV:
    # 869) — docs/real_photos.md. Off by default: 4x first-octave pixel
    # cost, and the rendered arc scenes gain nothing from sub-pixel scales.
    upsample: bool = False


@dataclass(frozen=True)
class MatchConfig:
    """Brute-force descriptor matching (replaces FLANN, features.py:92-204)."""

    ratio: float = 0.75
    cross_check: bool = True
    min_matches: int = 20
    ransac_threshold_px: float = 2.0
    ransac_confidence: float = 0.999
    ransac_hypotheses: int = 1024
    max_matches: int = 4096           # padded match capacity per pair
    # Long-span probe pairs that fail at load resolution get ONE selective
    # re-match at rematch_scale x upsampled resolution (Lowe's -1 octave:
    # SIFT on the doubled image sees one octave of finer scales, which
    # recovers weak small-scale features — the binding constraint on the
    # 300-view arc was missing long-range edges, docs/global_sfm.md).
    long_span_rematch: bool = True
    rematch_scale: float = 2.0
    # Upsampled re-extraction only pays when the load resolution is below
    # the feature-scale floor — at >= ~VGA the SIFT pyramid already covers
    # the sensor's information and a 2x pass costs ~30 s of extraction on
    # the 50-view north-star for zero recoveries (measured). Pairs are also
    # budgeted, longest spans first (those anchor the global shape).
    rematch_max_dim: int = 320
    rematch_max_pairs: int = 24


@dataclass(frozen=True)
class NeuralConfig:
    """SuperPoint + LightGlue (reference neural_matcher.py:32-66)."""

    max_keypoints: int = 2048
    detection_threshold: float = 0.0005
    nms_radius: int = 4
    superpoint_weights: Optional[str] = None
    lightglue_weights: Optional[str] = None
    lightglue_layers: int = 9
    descriptor_dim: int = 256
    # Matcher backend: "lightglue" (attention GNN), "nn" (mutual-NN + ratio
    # on SuperPoint descriptors), or "auto" = lightglue only when EXPLICIT
    # lightglue_weights were supplied (converted published checkpoints),
    # else nn. The bundled in-repo synthetic LightGlue measurably
    # under-recalls the NN fallback on photographic texture (46-vs-79
    # correct matches; the round-4 view-pair retrain regressed further to
    # 26 — docs/neural_quality.md), so auto picks the stronger backend;
    # matcher="lightglue" opts into the bundled checkpoint explicitly.
    matcher: str = "auto"
    nn_ratio: float = 0.95
    # Assignment-score gate for LightGlue match extraction. The official
    # torch default is 0.1; the bundled synthetic-trained checkpoint is
    # calibrated sharper, so 0.01 recovers NN-level match counts at higher
    # precision.
    lightglue_match_threshold: float = 0.01
    # Per-pair robustness: when the attention matcher abstains on a hard
    # pair (wide baseline / sparse keypoints can yield near-zero LightGlue
    # matches while plain descriptor NN still finds a consensus set), fall
    # back to mutual-NN matching for that pair and keep whichever survives
    # F-RANSAC with more inliers.
    lightglue_nn_fallback: bool = True


@dataclass(frozen=True)
class SfmConfig:
    """Incremental SfM driver (reference sfm_pipeline.py:28-86)."""

    max_image_size: int = 1600        # resize long side at load (ref :62,103)
    match_window: int = 8             # sequential pair window (ref :164-181)
    loop_closure: bool = True
    min_matches_init: int = 100
    min_parallax_init_deg: float = 1.5
    max_parallax_init_deg: float = 40.0
    # Initial pair: re-estimate a 5-DoF essential matrix directly (known K)
    # instead of reusing the match stage's 7-DoF F via E = K^T F K — more
    # robust at low correspondence counts / thin parallax (SURVEY §7 step 3
    # "5-point-or-8-point E"; tests/test_ransac.py).
    init_essential: bool = True
    init_essential_threshold_px: float = 2.0
    init_essential_hypotheses: int = 512
    pnp_min_correspondences: int = 12  # ref :478-510
    pnp_hypotheses: int = 2048
    pnp_thresholds_px: Tuple[float, ...] = (8.0, 10.0, 12.0)
    # Last-chance rescue of views the match stage starved (never reached
    # pnp_min_correspondences, or sat in a disconnected block): finer-scale
    # re-extraction of the missing views + their window neighbors, merged
    # edges, and relaxed-floor registration waves with a stricter inlier
    # fraction (see SfMPipeline._rescue_unregistered; the reference's
    # recovery loop :778-789 retries but never re-matches, so it cannot
    # recover these).
    rescue_unregistered: bool = True
    rescue_min_correspondences: int = 5  # P3P minimal + 1, see inlier frac
    rescue_min_inlier_frac: float = 0.5
    rescue_scale: float = 2.0
    rescue_max_images: int = 32
    registration_wave_size: int = 16   # images PnP'd per batched dispatch
    max_reproj_error_px: float = 4.0   # triangulation gate (ref geometry.py:61)
    min_parallax_deg: float = 1.0
    max_depth_factor: float = 200.0    # depth < factor * baseline (ref geometry.py:97)
    ba_every_n_cameras: int = 5        # ref :855
    ba_max_iterations: int = 20
    max_points: int = 200_000          # padded track capacity
    normalize_scale: float = 10.0      # ref :884-914
    fast: bool = False
    seed: int = 0


@dataclass(frozen=True)
class PlaneSweepConfig:
    """Plane-sweep stereo (reference dense_stereo.py:26-60)."""

    scale: float = 0.25
    num_depths: int = 64
    patch_size: int = 5
    min_views: int = 3
    ncc_threshold: float = 0.8
    num_neighbors: int = 6
    max_ref_views: int = 20
    voxel_size: float = 0.02


@dataclass(frozen=True)
class PatchMatchConfig:
    """PatchMatch MVS (reference mvs_patchmatch.py:38-71)."""

    scale: float = 0.25
    patch_size: int = 11
    num_iterations: int = 3
    num_refine_samples: int = 8
    num_source_views: int = 4
    # Coarse-to-fine: exploration iterations run at 1/coarse_factor
    # resolution, then fine_iterations short-radius polish rounds at full
    # working resolution (patchmatch.py patchmatch_depth). coarse_factor=1
    # recovers the single-level formulation.
    coarse_factor: int = 4
    fine_iterations: int = 1
    min_views: int = 3
    ncc_confidence_threshold: float = 0.6
    min_triangulation_angle_deg: float = 5.0
    max_triangulation_angle_deg: float = 60.0
    voxel_size: float = 0.01
    seed: int = 0


@dataclass(frozen=True)
class DenseSiftConfig:
    """Dense SIFT triangulation backend (reference dense.py:18-50)."""

    max_features: int = 65536
    contrast_threshold: float = 0.01
    ratio: float = 0.85
    pair_window: int = 8
    min_parallax_deg: float = 0.3
    max_reproj_error_px: float = 6.0
    knn_k: int = 20
    knn_std_factor: float = 2.5


@dataclass(frozen=True)
class BundleConfig:
    """Sparse Gauss-Newton/LM bundle adjustment (upgrade over ref :694-776)."""

    max_iterations: int = 20
    # Mid-reconstruction BAs only need to keep geometry consistent enough
    # for the next registration waves — they start near the previous
    # optimum and the FINAL BA (max_iterations) polishes. Capping them
    # measurably preserves the north-star quality gates while cutting the
    # dominant sparse-stage cost (ba_full) roughly in half.
    intermediate_max_iterations: int = 6
    # Schur-reduced CG converges far faster than the old full-system CG
    # the 40 default was sized for; 24 measured loss-free (LM's accept/
    # reject absorbs occasional under-solves with an extra iteration)
    cg_iterations: int = 24
    init_damping: float = 1e-3
    motion_only: bool = False
    robust_delta_px: float = 3.0       # Huber width


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip runs."""

    data_axis: str = "data"            # views / pairs / hypotheses shard axis
    model_axis: str = "model"          # tensor-parallel axis (neural nets)
    data_parallel: int = -1            # -1: all devices on data axis
    model_parallel: int = 1


@dataclass(frozen=True)
class ReconstructionConfig:
    sift: SiftConfig = field(default_factory=SiftConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    neural: NeuralConfig = field(default_factory=NeuralConfig)
    sfm: SfmConfig = field(default_factory=SfmConfig)
    plane_sweep: PlaneSweepConfig = field(default_factory=PlaneSweepConfig)
    patchmatch: PatchMatchConfig = field(default_factory=PatchMatchConfig)
    dense_sift: DenseSiftConfig = field(default_factory=DenseSiftConfig)
    bundle: BundleConfig = field(default_factory=BundleConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ReconstructionConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def fast(cls) -> "ReconstructionConfig":
        """Fast mode: fewer features, looser ratio (ref sfm_pipeline.py:54-62)."""
        cfg = cls()
        return cfg.replace(
            sift=dataclasses.replace(cfg.sift, max_features=3000),
            match=dataclasses.replace(cfg.match, ratio=0.8),
            sfm=dataclasses.replace(cfg.sfm, fast=True, max_image_size=1024),
        )
