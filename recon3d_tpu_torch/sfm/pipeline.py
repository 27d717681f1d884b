"""Incremental structure-from-motion pipeline.

PyTorch port of recon3d_tpu/sfm/pipeline.py (SfMPipeline): load ->
extract_features -> match_image_pairs (with the long-span rematch, the
match-graph components and their bridging) -> initial pair -> registration
waves -> triangulation -> motion refinement and bundle adjustment ->
normalization -> PLY. The host Python here is O(images) control flow only;
every hot operation is a batched function of recon3d_tpu_torch.ops on the
pipeline's device.

reconstruct_global replaces the registration waves by rotation and
translation averaging (sfm/global_sfm.py); neural_mode swaps the SIFT
front end for SuperPoint + LightGlue (neural/matcher.py). With a mesh
(parallel/mesh.py) pair matching shards its pair rows and bundle
adjustment its observations over the mesh's 'data' axis
(recon3d_tpu/sfm/pipeline.py:290-298,483-490,564,1411-1444,1571).

Dynamic-size state (matches, tracks, observations, keypoint tables) lives
on the host in numpy; device calls are padded to geometric buckets so that
they take few distinct shapes. Random draws come from one torch.Generator
on the device, seeded from config.sfm.seed and consumed in stage order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera, CameraPose, load_calibration, stack_poses
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.features.frontend import (
    FeatureExtractor,
    FeatureMatcher,
    feature_slice,
    match_pairs_batched,
)
from recon3d_tpu_torch.io.dataset import ImageSet, load_image_set
from recon3d_tpu_torch.io.ply import save_cameras_ply, save_ply
from recon3d_tpu_torch.ops.epipolar import essential_from_fundamental, recover_pose
from recon3d_tpu_torch.ops.estimation import (
    estimate_essential_ransac,
    estimate_homography_ransac,
    estimate_pose_pnp_wave_indexed,
)
from recon3d_tpu_torch.ops.image import resize
from recon3d_tpu_torch.ops.linalg import einsum_hp, matmul_hp
from recon3d_tpu_torch.ops.pnp import refine_pose_gn
from recon3d_tpu_torch.ops.triangulate import (
    reprojection_errors,
    triangulate_dlt,
    triangulation_angles,
    validate_triangulation,
)
from recon3d_tpu_torch.runtime.device import resolve_device
from recon3d_tpu_torch.runtime.profiling import count, current, pull, span, traced
from recon3d_tpu_torch.sfm.bundle import bundle_adjust_log, kp_table_of


def _pad_pow2(n: int, lo: int = 256, hi: int = 16384, factor: int = 4) -> int:
    """Pad a data-dependent size to a bucket that holds it, so that
    device-facing batches take few distinct shapes; the padded slots are
    masked. Up to `hi` the buckets grow geometrically from `lo` (default
    x4); past it they are multiples of `hi`, so a larger size pads by less
    than `hi` and never gets a bucket below itself."""
    c = lo
    while c < n and c < hi:
        c *= factor
    if c < n:
        c = -(-n // hi) * hi
    return c


# --------------------------------------------------------------------------
# Batched helpers of the back end (any leading batch dimensions)


def _triangulate_validated(
    K, R1, t1, R2, t2, x1, x2, mask, max_reproj, min_parallax, max_depth_factor
):
    """DLT triangulation of x1, x2 (..., N, 2) between poses R (..., 3, 3),
    t (..., 3), with its validity (masked) and the parallax angle per
    point: (X (..., N, 3), ok (..., N), parallax (..., N))."""
    P1 = matmul_hp(K, torch.cat([R1, t1[..., None]], dim=-1))
    P2 = matmul_hp(K, torch.cat([R2, t2[..., None]], dim=-1))
    X = triangulate_dlt(P1, P2, x1, x2)
    ok = validate_triangulation(
        K, R1, t1, R2, t2, X, x1, x2,
        max_reproj_px=max_reproj,
        min_parallax_deg=min_parallax,
        max_depth_factor=max_depth_factor,
    )
    C1 = -einsum_hp("...ji,...j->...i", R1, t1)
    C2 = -einsum_hp("...ji,...j->...i", R2, t2)
    parallax = triangulation_angles(C1[..., None, :], C2[..., None, :], X)
    return X, ok & (mask > 0), parallax


# every partner pair of a wave in one call: the same function over a
# leading axis of pairs
_triangulate_validated_batch = _triangulate_validated


def _reproj_errors_batch(K, Rs, ts, Xs, xs):
    """Rs (C, 3, 3), ts (C, 3), Xs (C, N, 3), xs (C, N, 2) -> (C, N)."""
    return reprojection_errors(K, Rs[..., None, :, :], ts[..., None, :], Xs, xs)


def _refine_cameras_with_errors(K, Rs, ts, Xs, xs, ws):
    """Motion refinement of all registered cameras (12 GN iterations) with
    the mean reprojection error before and after."""

    def errs(Rb, tb):
        e = _reproj_errors_batch(K, Rb, tb, Xs, xs)
        return (e * ws).sum() / ws.sum().clamp_min(1.0)

    before = errs(Rs, ts)
    Rn, tn = refine_pose_gn(K, Rs, ts, Xs, xs, ws, iterations=12)
    return Rn, tn, before, errs(Rn, tn)


def _reproj_errors_gather(K, Rs, ts, cam_idx, X, x):
    """Per-element reprojection error with a per-element camera (gathered
    from the registered-pose table): link checks against many cameras in
    one call."""
    Xc = einsum_hp("nij,nj->ni", Rs[cam_idx], X) + ts[cam_idx]
    z = Xc[:, 2]
    zs = torch.where(z.abs() < 1e-8, 1e-8, z)
    uv = Xc[:, :2] / zs[:, None]
    u = K[0, 0] * uv[:, 0] + K[0, 1] * uv[:, 1] + K[0, 2]
    v = K[1, 1] * uv[:, 1] + K[1, 2]
    err = torch.linalg.norm(torch.stack([u, v], dim=-1) - x, dim=-1)
    return torch.where(z > 1e-6, err, 1e9)


def _init_candidates_batch(K, Fs, x1s, x2s, masks, max_reproj, max_depth_factor,
                           generator=None, use_essential=False,
                           essential_threshold_px=2.0, essential_hypotheses=512,
                           sample_indices=None):
    """Score every initial-pair candidate in one call: E (direct 5-DoF
    RANSAC on the F-verified correspondences when use_essential, else
    K^T F K from the match stage's F), pose recovery, triangulation +
    validation, per-point parallax. Fs (B, 3, 3), x1s, x2s (B, N, 2), masks
    (B, N) -> (R (B, 3, 3), t (B, 3), ok (B, N), parallax (B, N))."""
    if use_essential:
        E = estimate_essential_ransac(
            generator, K, x1s, x2s, masks, threshold_px=essential_threshold_px,
            num_hypotheses=essential_hypotheses, sample_indices=sample_indices,
        ).E
    else:
        E = essential_from_fundamental(Fs, K)
    R, t, _ = recover_pose(E, x1s, x2s, K, masks)
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand_as(R)
    _, ok, parallax = _triangulate_validated(
        K, eye, torch.zeros_like(t), R, t, x1s, x2s, masks,
        max_reproj, 0.5, max_depth_factor,
    )
    return R, t, ok, parallax


class _PointStore:
    """Growable (N, dim) numpy array: amortized O(1) append, O(1) view."""

    __slots__ = ("_buf", "_n", "_dim", "_dtype")

    def __init__(self, dim: int, dtype, data=None):
        self._dim = dim
        self._dtype = np.dtype(dtype)
        if data is None or len(data) == 0:
            self._buf = np.empty((256, dim), self._dtype)
            self._n = 0
        else:
            arr = np.asarray(data, self._dtype).reshape(-1, dim)
            self._buf = arr.copy()
            self._n = len(arr)

    def __len__(self) -> int:
        return self._n

    def append(self, row) -> int:
        if self._n == len(self._buf):
            grown = np.empty((2 * len(self._buf), self._dim), self._dtype)
            grown[: self._n] = self._buf
            self._buf = grown
        self._buf[self._n] = row
        self._n += 1
        return self._n - 1

    def view(self) -> np.ndarray:
        """Zero-copy (N, dim) view of the live rows (do not mutate)."""
        return self._buf[: self._n]

    def replace(self, data) -> None:
        if data is None or len(data) == 0:
            self._n = 0
            return
        arr = np.asarray(data, self._dtype).reshape(-1, self._dim)
        self._buf = arr.copy()
        self._n = len(arr)


class _LazyFeatureList:
    """Sequence view over stacked (V, ...) features: slices one image's
    tensors only when accessed (match-graph bridging needs a handful)."""

    def __init__(self, stacked, n: int):
        self._stacked = stacked
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return feature_slice(self._stacked, i)


class SfMPipeline:
    """Incremental SfM.

    Args:
      calibration_path: optional .npz (mtx, dist) file.
      fast_mode: fewer features / looser ratio.
      neural_mode: SuperPoint + LightGlue front end instead of SIFT.
      config: full ReconstructionConfig (overrides the fast_mode presets).
      mesh: a parallel.mesh.Mesh (rank 0 on `device`): pair matching and
        bundle adjustment shard over its 'data' axis.
      device: "cuda" (default; an error without a GPU) or "cpu".
    """

    def __init__(
        self,
        calibration_path: Optional[str] = None,
        fast_mode: bool = False,
        neural_mode: bool = False,
        config: Optional[ReconstructionConfig] = None,
        mesh=None,
        prescale_hints: Tuple[float, ...] = (),
        device="cuda",
    ):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.config = config or (
            ReconstructionConfig.fast() if fast_mode else ReconstructionConfig()
        )
        # Dense-stage working scales to prescale at load time
        # (ImageSet.small_color cache).
        self.prescale_hints = tuple(prescale_hints)
        self.camera: Optional[Camera] = (
            load_calibration(calibration_path) if calibration_path else None
        )
        self.neural_mode = neural_mode
        if neural_mode:
            from recon3d_tpu_torch.neural.matcher import NeuralMatcher

            self.extractor = NeuralMatcher(self.config.neural, device=self.device)
            self.matcher = self.extractor
        else:
            self.extractor = FeatureExtractor(self.config.sift, device=self.device)
            self.matcher = FeatureMatcher(self.config.match)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.config.sfm.seed)
        self.reset()

    # -- state ------------------------------------------------------------

    def reset(self):
        self.image_set: Optional[ImageSet] = None
        self.features = []
        self.features_stacked = None
        self.kp_xy: List[np.ndarray] = []
        self._kp_cache = None
        # device copy of the concatenated keypoint table (uploaded once per
        # reconstruction for the indexed PnP wave; again when the table
        # grows, e.g. after a long-span rematch appends keypoints)
        self._kp_flat_dev = None
        self.matches: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self.poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.registered: Set[int] = set()
        self.failed: Set[int] = set()
        self._pts = _PointStore(3, np.float32)
        self._cols = _PointStore(3, np.uint8)
        self.observations: List[List[Tuple[int, int]]] = []
        # Arrival-order (pid, cam, kp) log mirroring `observations`: it
        # feeds the device-resident log of bundle_adjust_log (only rows
        # appended since the previous BA call are uploaded). Kept in sync
        # by _record_obs. Every site that rebuilds `observations` wholesale
        # (drop_invalid_observations, global SfM) bumps _obs_generation, which
        # bundle_adjustment_full compares (besides the total count) to
        # decide whether the log is stale.
        self._obs_log = _PointStore(3, np.int32)
        self._obs_generation = 0
        self._obs_log_generation = 0
        self._ba_log_cache: Dict = {}
        self.kp_to_point: List[np.ndarray] = []
        # Incremental 2D-3D correspondence index: for each UNregistered
        # image, {kp -> point id}, maintained as links are created
        # (_note_kp_link) instead of rebuilt from every match pair per wave.
        self.corr: Dict[int, Dict[int, int]] = {}
        self._kp_links: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
        self.stats: Dict = {}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _K_dev(self) -> torch.Tensor:
        return self.camera.K.to(self.device)

    # -- stage 1: load ------------------------------------------------------

    def load_images(self, image_dir: str, max_images: Optional[int] = None) -> ImageSet:
        """Load + resize + undistort."""
        self.image_set = load_image_set(
            image_dir,
            camera=self.camera,
            max_size=self.config.sfm.max_image_size,
            max_images=max_images,
            device=self.device,
        )
        self.camera = self.image_set.camera
        for s in self.prescale_hints:
            self.image_set.small_color(s)
        return self.image_set

    def set_image_set(self, image_set: ImageSet):
        """Inject a pre-loaded set (synthetic scenes, tests)."""
        self.image_set = image_set
        self.camera = image_set.camera

    # -- stage 2: features ----------------------------------------------------

    def extract_features(self):
        """Feature extraction of every image: SIFT as one two-phase batch,
        SuperPoint image by image."""
        with span("sfm.extract") as stage:
            n = self.image_set.gray.shape[0]
            self.kp_xy = []
            self.kp_to_point = []
            tm: Dict[str, float] = {}
            if self.neural_mode:
                self.features_stacked = None
                self.features = [self.extractor.extract(self.image_set.gray[i])
                                 for i in range(n)]
                with span("extract.kp_pull") as sp:
                    xy_all = pull(torch.stack([f.xy for f in self.features])).numpy()
                    valid_all = pull(torch.stack([f.valid for f in self.features])).numpy()
                count("neural.keypoints", int(valid_all.sum()))
            else:
                # stacked (V, ...) device tensors; per-image views only on demand
                stacked = self.extractor.extract_batch(self.image_set.gray, timings=tm)
                self.features_stacked = stacked
                self.features = _LazyFeatureList(stacked, n)
                # keypoint pull: the one host sync of the stage. It waits for
                # every describe, then downloads (V, K, 2) + (V, K); the
                # descriptors stay on the device, where matching reads them.
                with span("extract.kp_pull") as sp:
                    xy_all = pull(stacked.xy).numpy()
                    valid_all = pull(stacked.valid).numpy()
            tm["kp_pull_sync_s"] = sp.seconds
            self.stats["extract_detail_s"] = {k: round(v, 3) for k, v in tm.items()}
            for r in range(n):
                self.kp_xy.append(xy_all[r])
                self.kp_to_point.append(np.full(xy_all.shape[1], -1, dtype=np.int64))
            counts = valid_all.sum(1).astype(int).tolist()
        self.stats["extract_time"] = stage.seconds
        self.stats["features_per_image"] = counts
        self.stats["selection_capacity"] = int(xy_all.shape[1])
        print(f"[sfm] extracted features: mean {np.mean(counts):.0f}/image "
              f"({self.stats['extract_time']:.1f}s)")

    # -- stage 3: matching ----------------------------------------------------

    def _candidate_pairs(self, n: int) -> List[Tuple[int, int]]:
        """Window + loop-closure + stride probes."""
        w = self.config.sfm.match_window
        pairs = set()
        for i in range(n):
            for j in range(i + 1, min(n, i + 1 + w)):
                pairs.add((i, j))
        if self.config.sfm.loop_closure and n > 2 * w:
            for i in range(w):
                for j in range(n - w, n):
                    if i < j:
                        pairs.add((i, j))
            # Stride probes double until they span the sequence: large
            # scenes need mid-range anchor edges, not just 2w and 4w.
            stride = 2 * w
            while stride < n:
                for i in range(0, n - stride, max(1, stride // 2)):
                    pairs.add((i, i + stride))
                stride *= 2
        return sorted(pairs)

    def match_image_pairs(self):
        """Geometric matching of the candidate pairs, whole chunks of pairs
        at a time (features/frontend.py match_pairs_batched, or the neural
        matcher's match_pairs_batched in neural mode)."""
        with span("sfm.match") as stage:
            n = len(self.features)
            pairs = self._candidate_pairs(n)
            kept = 0
            if pairs:
                if self.neural_mode:
                    results = self.matcher.match_pairs_batched(
                        self.features, pairs, self._generator,
                        hw=self.image_set.gray.shape[1:3], mesh=self.mesh)
                else:
                    tm: Dict[str, float] = {}
                    results = match_pairs_batched(
                        self.features_stacked, pairs, self._generator,
                        self.config.match, timings=tm, mesh=self.mesh,
                    )
                    self.stats["match_detail_s"] = {k: round(v, 3) for k, v in tm.items()}
                mm = self.config.match.min_matches
                for (i, j, idx1, idx2, F, n_inl, n_raw) in results:
                    if n_raw >= mm and n_inl >= mm:
                        self.matches[(i, j)] = dict(idx1=idx1, idx2=idx2, F=F, n=len(idx1))
                        kept += 1
                if self.config.match.long_span_rematch and not self.neural_mode:
                    with span("match.rematch"):
                        kept += self._rematch_long_span(pairs)
            print(f"[sfm] matched {kept}/{len(pairs)} pairs ({stage.seconds:.1f}s)")
            with span("match.graph"):
                self._bridge_components(n)
                self._build_kp_links()
        self.stats["match_time"] = stage.seconds
        self.stats["num_pairs"] = kept
        self.stats["num_candidate_pairs"] = len(pairs)

    def _rematch_long_span(self, pairs) -> int:
        """Selective high-res re-matching of failed long-span probe pairs.

        On window-limited capture arcs the long-range edges are what anchor
        the global shape; at load resolution those pairs mostly fail. One
        2x-upsampled SIFT pass over just the failed pairs' images adds an
        octave of finer scales; recovered keypoints are appended to the
        per-image tables (scaled back to load-resolution pixels), so that
        every downstream stage indexes them like any other keypoint, and
        the pair's F is conjugated back to load-resolution coordinates.
        Returns the number of pairs recovered."""
        w = self.config.sfm.match_window
        mc = self.config.match
        self.stats.update(rematch_attempted=0, rematch_recovered=0, rematch_rejected=0)
        H0, W0 = self.image_set.gray.shape[1:]
        if max(H0, W0) > mc.rematch_max_dim:
            return 0  # load res already covers the feature-scale floor
        failed = sorted(
            ((i, j) for (i, j) in pairs
             if j - i >= 2 * w and (i, j) not in self.matches),
            # Shortest span first: every candidate already spans >= 2x the
            # match window (a real global anchor), and recoverability falls
            # off steeply with viewpoint change.
            key=lambda p: p[1] - p[0],
        )[: mc.rematch_max_pairs]
        self.stats["rematch_attempted"] = len(failed)
        if not failed:
            return 0

        s = float(mc.rematch_scale)
        imgs = sorted({i for p in failed for i in p})
        local = {g: l for l, g in enumerate(imgs)}
        gray = torch.from_numpy(self.image_set.gray[imgs]).to(self.device)
        H, W = gray.shape[1:]
        up = resize(gray, (int(H * s), int(W * s)))
        feats = self.extractor.extract_batch(pull(up).numpy())
        res = match_pairs_batched(
            feats, [(local[i], local[j]) for (i, j) in failed],
            self._generator, mc, mesh=self.mesh,
        )
        xy_up = pull(feats.xy).numpy()       # upscaled-pixel coords
        valid_np = pull(feats.valid).numpy()
        # resize uses half-pixel centers: x_up = s*x + (s-1)/2
        xy_load = (xy_up - (s - 1.0) / 2.0) / s
        # conjugate F back to load coords: F_load = S^T F_up S
        S = np.array(
            [[s, 0.0, (s - 1.0) / 2.0],
             [0.0, s, (s - 1.0) / 2.0],
             [0.0, 0.0, 1.0]], np.float32,
        )
        offset = {}
        remap = {}
        recovered = 0
        degenerate = 0
        mm = mc.min_matches
        Kn = self.camera.K.cpu().numpy().astype(np.float64)

        for r, (i, j) in enumerate(failed):
            (_, _, idx1, idx2, F, n_inl, n_raw) = res[r]
            if n_raw < mm or n_inl < mm:
                continue
            # H/F degeneracy gate: a single homography explaining >= 80% of
            # the F-inliers means the pair carries no parallax signal. On
            # self-similar texture the 2x re-match "verifies" false
            # wide-baseline pairs; those matches are plane-to-plane and
            # H-consistent, genuine wide-baseline pairs of a 3-D scene are
            # not.
            cap2 = _pad_pow2(len(idx1), lo=64)
            ha = np.zeros((cap2, 2), np.float32)
            hb = np.zeros((cap2, 2), np.float32)
            hm = np.zeros(cap2, np.float32)
            ha[: len(idx1)] = xy_up[local[i]][idx1]
            hb[: len(idx2)] = xy_up[local[j]][idx2]
            hm[: len(idx1)] = 1.0
            hres = estimate_homography_ransac(
                self._generator,
                torch.from_numpy(ha).to(self.device),
                torch.from_numpy(hb).to(self.device),
                torch.from_numpy(hm).to(self.device),
                threshold_px=mc.ransac_threshold_px * s,
            )
            if int(pull(hres.num_inliers)) >= 0.8 * n_inl:
                degenerate += 1
                continue
            # Essential-compatibility gate: with K known, a geometrically
            # valid pair's F is (nearly) K^T-conjugate to an essential
            # matrix; project E = K^T F K to equal singular values and
            # require the inlier set to survive the projection. (Host
            # numpy: a 3x3 SVD + Sampson over a few hundred matches.)
            F_load = S.T @ F @ S
            E = Kn.T @ F_load @ Kn
            U, _, Vt = np.linalg.svd(E)
            F_e = np.linalg.inv(Kn).T @ (
                U @ np.diag([1.0, 1.0, 0.0]) @ Vt
            ) @ np.linalg.inv(Kn)
            a1 = np.concatenate(
                [xy_load[local[i]][idx1], np.ones((len(idx1), 1))], axis=1
            )
            b1 = np.concatenate(
                [xy_load[local[j]][idx2], np.ones((len(idx2), 1))], axis=1
            )
            Fx = a1 @ F_e.T
            Ftx = b1 @ F_e
            num = np.abs(np.sum(b1 * Fx, axis=1))
            den = np.sqrt(
                Fx[:, 0] ** 2 + Fx[:, 1] ** 2
                + Ftx[:, 0] ** 2 + Ftx[:, 1] ** 2
            )
            samp = num / np.maximum(den, 1e-12)
            if (samp < mc.ransac_threshold_px).sum() < max(mm, 0.7 * n_inl):
                degenerate += 1
                continue
            for g in (i, j):
                if g not in offset:
                    # Compact to valid slots before appending: the padded
                    # table's invalid slots carry garbage coordinates.
                    # idx1/idx2 remap through the compaction order.
                    keep = np.flatnonzero(valid_np[local[g]])
                    rm = np.full(valid_np.shape[1], -1, np.int64)
                    rm[keep] = np.arange(len(keep))
                    remap[g] = rm
                    offset[g] = len(self.kp_xy[g])
                    self.kp_xy[g] = np.concatenate(
                        [self.kp_xy[g], xy_load[local[g]][keep]]
                    )
                    self.kp_to_point[g] = np.concatenate([
                        self.kp_to_point[g],
                        np.full(len(keep), -1, np.int64),
                    ])
            # aux=True: pose-graph-only edge. Recovered keypoints carry
            # about twice the localization noise of load-resolution ones;
            # as averaging-graph edges they anchor the global shape, which
            # is the thing long spans are uniquely good for.
            self.matches[(i, j)] = dict(
                idx1=remap[i][idx1] + offset[i],
                idx2=remap[j][idx2] + offset[j],
                F=F_load,
                n=len(idx1),
                aux=True,
            )
            recovered += 1
        self.stats["rematch_recovered"] = recovered
        self.stats["rematch_rejected"] = degenerate
        if recovered or degenerate:
            print(f"[sfm] long-span rematch: {recovered}/{len(failed)} "
                  f"failed probe pairs recovered at {s:.0f}x "
                  f"({degenerate} rejected as H-degenerate)")
        return recovered

    def _build_kp_links(self):
        """Per-camera reverse match index: kp -> [(partner image, partner
        kp)] over every kept match."""
        links: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
        for (a, b), m in self.matches.items():
            if m.get("aux"):
                continue  # pose-graph-only edges (see _rematch_long_span)
            la = links.setdefault(a, {})
            lb = links.setdefault(b, {})
            for ka, kb in zip(m["idx1"].tolist(), m["idx2"].tolist()):
                la.setdefault(ka, []).append((b, kb))
                lb.setdefault(kb, []).append((a, ka))
        self._kp_links = links

    def _components(self, n: int) -> List[Set[int]]:
        """Connected components of the match graph, largest first."""
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for (i, j) in self.matches:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
        comps: Dict[int, Set[int]] = {}
        for i in range(n):
            comps.setdefault(find(i), set()).add(i)
        return sorted(comps.values(), key=len, reverse=True)

    def _bridge_components(self, n: int):
        """Try to connect disconnected components of the match graph."""
        comps = self._components(n)
        if len(comps) <= 1:
            return
        print(f"[sfm] match graph fragmented into {len(comps)} components; bridging")
        main = comps[0]
        for other in comps[1:]:
            candidates = sorted(
                ((i, j) if i < j else (j, i))
                for i in list(main)[:6]
                for j in list(other)[:6]
            )[:8]
            for (i, j) in candidates:
                if (i, j) in self.matches:
                    continue
                m, F, n_inl = self.matcher.match_pair_geometric(
                    self.features[i], self.features[j], self._generator
                )
                if n_inl >= self.config.match.min_matches:
                    mask = pull(m.mask).numpy()
                    self.matches[(i, j)] = dict(
                        idx1=pull(m.idx1).numpy()[mask],
                        idx2=pull(m.idx2).numpy()[mask],
                        F=pull(F).numpy(),
                        n=int(mask.sum()),
                    )
                    main |= other
                    break

    # -- stage 4: initialization ------------------------------------------------

    def _pair_xy(self, i: int, j: int):
        m = self.matches[(i, j)]
        return self.kp_xy[i][m["idx1"]], self.kp_xy[j][m["idx2"]]

    def find_best_initial_pair(self, sample_indices=None) -> Optional[Tuple[int, int]]:
        """Score candidate initial pairs by inliers x parallax gate
        (parallax in [min, max]_parallax_init_deg, boost in [3, 20] deg).
        sample_indices: pre-drawn (10, H, 5) samples of the essential
        RANSAC in place of the generator's."""
        cfg = self.config.sfm
        # Parallax-diverse candidate slate: the top pairs by match count
        # are adjacent pairs on dense capture arcs, whose median parallax
        # sits below the init gate. Match count correlates with a small
        # baseline, so half the batch is the global top by count and the
        # other half the best-matched pair per span for increasing spans.
        by_count = sorted(
            (kv for kv in self.matches.items() if not kv[1].get("aux")),
            key=lambda kv: -kv[1]["n"],
        )
        if not by_count:
            return None
        B = 10
        best_per_span: Dict[int, Tuple] = {}
        for (i, j), m in by_count:
            best_per_span.setdefault(j - i, ((i, j), m))
        spans = sorted(best_per_span)
        ranked, seen = [], set()
        for kv in [best_per_span[s] for s in spans[: B // 2]] + by_count:
            if kv[0] not in seen:
                seen.add(kv[0])
                ranked.append(kv)
            if len(ranked) == B:
                break
        # fixed batch of 10, padded with identity-F zero-mask rows
        cap = _pad_pow2(max(len(m["idx1"]) for _, m in ranked))
        Fs = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        Fs[: len(ranked)] = np.stack([m["F"] for _, m in ranked])
        x1p = np.zeros((B, cap, 2), np.float32)
        x2p = np.zeros((B, cap, 2), np.float32)
        maskp = np.zeros((B, cap), np.float32)
        for b, ((i, j), m) in enumerate(ranked):
            x1, x2 = self._pair_xy(i, j)
            x1p[b, : len(x1)] = x1
            x2p[b, : len(x2)] = x2
            maskp[b, : len(x1)] = 1
        Rb, tb, ok_b, par_b = _init_candidates_batch(
            self._K_dev(), self._dev(Fs), self._dev(x1p), self._dev(x2p), self._dev(maskp),
            cfg.max_reproj_error_px, cfg.max_depth_factor,
            generator=self._generator,
            use_essential=cfg.init_essential,
            essential_threshold_px=cfg.init_essential_threshold_px,
            essential_hypotheses=cfg.init_essential_hypotheses,
            sample_indices=sample_indices,
        )
        Rb, tb = pull(Rb).numpy(), pull(tb).numpy()
        ok_b, par_b = pull(ok_b).numpy(), pull(par_b).numpy()

        best, best_score = None, 0.0
        for b, ((i, j), m) in enumerate(ranked):
            okn = ok_b[b]
            if okn.sum() < cfg.min_matches_init // 2:
                continue
            med_par = float(np.median(par_b[b][okn]))
            if not (cfg.min_parallax_init_deg <= med_par <= cfg.max_parallax_init_deg):
                continue
            boost = 2.0 if 3.0 <= med_par <= 20.0 else 1.0
            score = okn.sum() * boost
            if score > best_score:
                best_score = score
                best = (i, j, Rb[b], tb[b])
        if best is None:
            return None
        i, j, R, t = best
        self._init_R, self._init_t = R, t
        print(f"[sfm] initial pair ({i}, {j}), score {best_score:.0f}")
        return (i, j)

    def initialize(self, pair: Tuple[int, int]):
        """Seed the reconstruction from the initial pair."""
        i, j = pair
        self.poses[i] = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.poses[j] = (self._init_R.astype(np.float32), self._init_t.astype(np.float32))
        self.registered = {i, j}
        self.corr.pop(i, None)
        self.corr.pop(j, None)
        self._add_triangulated(i, j)
        print(f"[sfm] initialized with {len(self.points3d)} points")

    # -- stage 5: incremental loop -----------------------------------------------

    def _points_as_array(self) -> np.ndarray:
        """The (P, 3) float32 point table: a zero-copy view of the growable
        store (read-only by convention)."""
        return self._pts.view()

    @property
    def points3d(self) -> np.ndarray:
        """(P, 3) float32 view of the point table. Assignment accepts an
        array or a list of (3,) rows."""
        return self._pts.view()

    @points3d.setter
    def points3d(self, value):
        self._pts.replace(value)

    @property
    def point_colors(self) -> np.ndarray:
        """(P, 3) uint8 view of the per-point colours."""
        return self._cols.view()

    @point_colors.setter
    def point_colors(self, value):
        self._cols.replace(value)

    def _kp_table(self):
        """(kp_flat (sum N, 2) float32, kp_off (V+1,) int64): every image's
        keypoints concatenated, with per-image offsets. kp_xy does not
        change after feature extraction, so this is built once and reused
        by every wave's link checks and by bundle adjustment."""
        if self._kp_cache is None:
            self._kp_cache = kp_table_of(self.kp_xy)
        return self._kp_cache

    def _note_kp_link(self, cam: int, kp: int, pid: int):
        """Record that (cam, kp) now observes point pid, and propagate the
        2D-3D correspondence to every unregistered match partner of that
        keypoint. Every kp_to_point assignment goes through here, keeping
        self.corr current without any per-wave rescan."""
        self.kp_to_point[cam][kp] = pid
        for (j, kpj) in self._kp_links.get(cam, {}).get(int(kp), ()):
            if j not in self.registered:
                self.corr.setdefault(j, {}).setdefault(kpj, pid)

    def _record_obs(self, pid: int, cam: int, kp: int):
        """Append one observation to both the per-point list and the
        arrival-order log."""
        self.observations[pid].append((cam, kp))
        self._obs_log.append((pid, cam, kp))

    def _rebuild_obs_log(self):
        """Reconstruct the arrival-order log from `observations` after a
        wholesale rewrite (point renumbering in drop_invalid_observations)
        and drop the device-side log cache."""
        self._ba_log_cache.clear()
        rows = [(pid, c, k) for pid, obs in enumerate(self.observations) for (c, k) in obs]
        self._obs_log = _PointStore(3, np.int32, data=rows if rows else None)
        self._obs_log_generation = self._obs_generation

    def _correspondences_2d3d(self, i: int):
        """2D-3D correspondences of an unregistered image: matched
        keypoints whose registered partner has a 3D point."""
        return self.corr.get(i, {})

    def _corr_arrays(self, i: int, floor: Optional[int] = None):
        """(kps, pids) int64 arrays for image i, or None if too few."""
        corr = self._correspondences_2d3d(i)
        if len(corr) < (floor or self.config.sfm.pnp_min_correspondences):
            return None
        kps = np.fromiter(corr.keys(), dtype=np.int64)
        pids = np.fromiter(corr.values(), dtype=np.int64)
        return kps, pids

    def find_next_image(self) -> Optional[int]:
        cfg = self.config.sfm
        best, best_n = None, cfg.pnp_min_correspondences - 1
        for i in range(len(self.features)):
            if i in self.registered or i in self.failed:
                continue
            n = len(self._correspondences_2d3d(i))
            if n > best_n:
                best, best_n = i, n
        return best

    @traced("wave.candidates")
    def _wave_candidates(self):
        """Eligible unregistered images, strongest first. Weak candidates
        (< 30% of the best correspondence count) are deferred, not
        attempted: they gain correspondences as triangulation widens and
        register in a later wave."""
        cfg = self.config.sfm
        out = []
        for i in range(len(self.features)):
            if i in self.registered or i in self.failed:
                continue
            c = self._corr_arrays(i)
            if c is not None:
                out.append((i, c[0], c[1]))
        out.sort(key=lambda t: -len(t[1]))
        if out:
            floor = max(cfg.pnp_min_correspondences, int(0.3 * len(out[0][1])))
            out = [t for t in out if len(t[1]) >= floor]
        return out

    def _register_wave(
        self,
        cands,
        min_corr: Optional[int] = None,
        min_inlier_frac: float = 0.25,
        sample_indices=None,
    ) -> List[int]:
        """PnP-register a wave of images in one device call.

        cands: list of (image_id, kps, pids). Every image x every cascade
        threshold solves in a single batched call
        (ops/estimation.py estimate_pose_pnp_wave_indexed); acceptance per
        image picks the tightest passing threshold, like a sequential
        cascade. min_corr/min_inlier_frac override the acceptance floor.
        sample_indices: pre-drawn (idx6, idx3, idx8) samples for the padded
        wave in place of the generator's. Returns the accepted image ids
        (state updated)."""
        cfg = self.config.sfm
        if not cands:
            return []
        det = self.stats.setdefault(
            "register_detail_s",
            {"prep": 0.0, "dispatch": 0.0, "solve_fetch": 0.0,
             "accept": 0.0, "waves": 0, "wave_shapes": []},
        )
        with span("wave.pnp"):
            with span("pnp.prep") as sp:
                # The wave and its correspondences are padded to geometric
                # buckets: a padded image (no valid slot) costs a hypothesis
                # batch and is never accepted.
                B = _pad_pow2(len(cands), lo=1, hi=1024)
                cap = _pad_pow2(max(len(k) for _, k, _ in cands))
                # Index-based wave: upload integer index tables + the small
                # (P, 3) point table instead of dense (B, cap, 3)/(B, cap, 2)
                # operands.
                pid_idx = np.full((B, cap), -1, np.int64)
                kp_idx = np.zeros((B, cap), np.int64)
                kp_flat, kp_off = self._kp_table()
                P_arr = self._points_as_array()
                P_cap = _pad_pow2(len(P_arr), lo=256)
                P_pad = np.zeros((P_cap, 3), np.float32)
                P_pad[: len(P_arr)] = P_arr
                for b, (i, kps, pids) in enumerate(cands):
                    pid_idx[b, : len(pids)] = pids
                    kp_idx[b, : len(kps)] = kp_off[i] + np.asarray(kps)
                thr = self._dev(np.asarray(cfg.pnp_thresholds_px, np.float32))
                # keypoint table: unchanged after extraction, its device copy cached
                kp_dev = self._kp_flat_dev
                if kp_dev is None or kp_dev.shape[0] != len(kp_flat):
                    kp_dev = self._kp_flat_dev = self._dev(kp_flat)
            det["prep"] += sp.seconds
            with span("pnp.dispatch") as sp:
                res = estimate_pose_pnp_wave_indexed(
                    self._generator, self._K_dev(),
                    self._dev(P_pad), kp_dev, self._dev(pid_idx), self._dev(kp_idx), thr,
                    num_hypotheses=cfg.pnp_hypotheses, sample_indices=sample_indices,
                )
            det["dispatch"] += sp.seconds
            with span("pnp.fetch") as sp:
                Rb = pull(res.R).numpy()                 # (B, T, 3, 3)
                tb = pull(res.t).numpy()                 # (B, T, 3)
                n_inl_b = pull(res.num_inliers).numpy()  # (B, T)
                inl_b = pull(res.inliers).numpy()        # (B, T, cap)
            det["solve_fetch"] += sp.seconds
            det["waves"] += 1
            det["wave_shapes"].append([int(B), int(cap)])

            with span("pnp.accept") as sp:
                accepted: List[int] = []
                for b, (i, kps, pids) in enumerate(cands):
                    n = len(kps)
                    need = max(
                        min_corr or cfg.pnp_min_correspondences,
                        int(min_inlier_frac * n),
                    )
                    for ti in range(len(cfg.pnp_thresholds_px)):
                        if int(n_inl_b[b, ti]) < need:
                            continue
                        self.poses[i] = (
                            Rb[b, ti].astype(np.float32), tb[b, ti].astype(np.float32)
                        )
                        self.registered.add(i)
                        self.corr.pop(i, None)  # the index only serves unregistered images
                        # touch only the accepted inlier links (array-side mask)
                        sel = (
                            np.asarray(inl_b[b, ti][:n], bool)
                            & (self.kp_to_point[i][kps] < 0)
                        )
                        for kp, pid in zip(
                            np.asarray(kps)[sel].tolist(),
                            np.asarray(pids)[sel].tolist(),
                        ):
                            self._note_kp_link(i, kp, pid)
                            self._record_obs(pid, i, kp)
                        accepted.append(i)
                        break
            det["accept"] += sp.seconds
            count("wave.count")
            count("wave.tried", len(cands))
            count("wave.accepted", len(accepted))
        return accepted

    def register_image(self, i: int) -> bool:
        """PnP registration of one image with the threshold cascade."""
        c = self._corr_arrays(i)
        if c is None:
            return False
        return i in self._register_wave([(i, c[0], c[1])])

    def _new_point(self, X, a: int, ka: int, b: int, kb: int, xy_a) -> None:
        """A fresh point seen at keypoint ka of image a and kb of image b,
        coloured from image a at xy_a."""
        color_img = self.image_set.color[a]
        Hh, Ww = color_img.shape[:2]
        pid = self._pts.append(X)
        u = int(np.clip(round(float(xy_a[0])), 0, Ww - 1))
        v = int(np.clip(round(float(xy_a[1])), 0, Hh - 1))
        self._cols.append((color_img[v, u] * 255).astype(np.uint8))
        self.observations.append([(a, ka), (b, kb)])
        self._obs_log.append((pid, a, ka))
        self._obs_log.append((pid, b, kb))
        self._note_kp_link(a, ka, pid)
        self._note_kp_link(b, kb, pid)

    def _add_triangulated(self, i: int, j: int):
        """Triangulate unassigned matches of a registered pair. Also links
        matches where one side already has a 3D point."""
        cfg = self.config.sfm
        key = (i, j) if (i, j) in self.matches else (j, i)
        if key not in self.matches or self.matches[key].get("aux"):
            return 0
        m = self.matches[key]
        a, b = key
        kpa, kpb = m["idx1"], m["idx2"]
        pa = self.kp_to_point[a][kpa]
        pb = self.kp_to_point[b][kpb]
        K = self._K_dev()

        # Link matches where one side already has a 3D point, but only if
        # that point reprojects into the other camera within the gate
        # (wrong links poison the track table and BA).
        def _link(from_pts, to_cam, to_kps, sel):
            if sel.sum() == 0:
                return
            pids = from_pts[sel]
            kps = to_kps[sel]
            X = self._points_as_array()[pids]
            x = self.kp_xy[to_cam][kps].astype(np.float32)
            R, t = self.poses[to_cam]
            e = reprojection_errors(K, self._dev(R), self._dev(t),
                                    self._dev(X), self._dev(x))
            e = pull(e).numpy()
            good = e < cfg.max_reproj_error_px
            for kp, pid in zip(kps[good], pids[good]):
                if self.kp_to_point[to_cam][kp] < 0:
                    self._note_kp_link(to_cam, int(kp), int(pid))
                    self._record_obs(int(pid), to_cam, int(kp))

        _link(pa, b, kpb, (pa >= 0) & (pb < 0))
        _link(pb, a, kpa, (pb >= 0) & (pa < 0))

        fresh = (pa < 0) & (pb < 0)
        if fresh.sum() == 0:
            return 0
        ka = kpa[fresh]
        kb = kpb[fresh]
        x1 = self.kp_xy[a][ka].astype(np.float32)
        x2 = self.kp_xy[b][kb].astype(np.float32)
        cap = _pad_pow2(len(x1))
        x1p = np.zeros((cap, 2), np.float32)
        x2p = np.zeros((cap, 2), np.float32)
        maskp = np.zeros(cap, np.float32)
        x1p[: len(x1)] = x1
        x2p[: len(x2)] = x2
        maskp[: len(x1)] = 1

        Ra, ta = self.poses[a]
        Rb, tb = self.poses[b]
        X, ok, _ = _triangulate_validated(
            K, self._dev(Ra), self._dev(ta), self._dev(Rb), self._dev(tb),
            self._dev(x1p), self._dev(x2p), self._dev(maskp),
            cfg.max_reproj_error_px, cfg.min_parallax_deg, cfg.max_depth_factor,
        )
        Xn = pull(X).numpy()
        okn = pull(ok).numpy()[: len(x1)]

        created = 0
        for idx in np.nonzero(okn)[0]:
            if len(self._pts) >= cfg.max_points:
                break
            self._new_point(Xn[idx], a, int(ka[idx]), b, int(kb[idx]), x1[idx])
            created += 1
        return created

    def triangulate_new_points(self, i: int) -> int:
        """Triangulate image i against every registered partner."""
        return self._triangulate_images([i])

    @traced("wave.triangulate")
    def _triangulate_images(self, imgs: List[int]) -> int:
        """Triangulate every match pair touching the given newly registered
        images: all images' link checks and pair triangulations of the
        whole wave run as two batched calls."""
        cfg = self.config.sfm
        keys_set = set()
        for i in imgs:
            for j in self.registered:
                if j == i:
                    continue
                key = (i, j) if (i, j) in self.matches else (j, i)
                if key in self.matches and not self.matches[key].get("aux"):
                    keys_set.add(key)
        partners = sorted(keys_set)
        if not partners:
            return 0
        K = self._K_dev()

        # ---- phase 1: batched link checks (one side already has a point)
        pid_parts, cam_parts, kp_parts = [], [], []
        fresh_sets = []
        for (a, b) in partners:
            m = self.matches[(a, b)]
            kpa, kpb = m["idx1"], m["idx2"]
            pa = self.kp_to_point[a][kpa]
            pb = self.kp_to_point[b][kpb]
            for from_pts, to_cam, to_kps, sel in (
                (pa, b, kpb, (pa >= 0) & (pb < 0)),
                (pb, a, kpa, (pb >= 0) & (pa < 0)),
            ):
                if sel.any():
                    pid_parts.append(from_pts[sel])
                    cam_parts.append(np.full(int(sel.sum()), to_cam, np.int64))
                    kp_parts.append(np.asarray(to_kps[sel], np.int64))
            fresh = (pa < 0) & (pb < 0)
            fresh_sets.append((a, b, kpa[fresh], kpb[fresh]))

        if pid_parts:
            link_pid = np.concatenate(pid_parts)
            link_cam = np.concatenate(cam_parts)
            link_kp = np.concatenate(kp_parts)
            cams = sorted(self.registered)
            Rs = np.stack([self.poses[c][0] for c in cams]).astype(np.float32)
            ts = np.stack([self.poses[c][1] for c in cams]).astype(np.float32)
            n = len(link_pid)
            cap = _pad_pow2(n)
            Xp = np.zeros((cap, 3), np.float32)
            xp = np.zeros((cap, 2), np.float32)
            ci = np.zeros(cap, np.int64)
            Xp[:n] = self._points_as_array()[link_pid]
            kp_flat, kp_off = self._kp_table()
            xp[:n] = kp_flat[kp_off[link_cam] + link_kp]
            row_of = np.full(max(cams) + 1, -1, np.int64)
            row_of[np.asarray(cams, np.int64)] = np.arange(len(cams))
            ci[:n] = row_of[link_cam]
            # every link's camera must be registered (links are only
            # created against registered partners): a -1 here would gather
            # another camera's pose and pass garbage errors
            if not (ci[:n] >= 0).all():
                raise RuntimeError("link references an unregistered camera")
            e = pull(_reproj_errors_gather(
                K, self._dev(Rs), self._dev(ts), self._dev(ci), self._dev(Xp), self._dev(xp),
            )).numpy()[:n]
            for k in np.nonzero(e < cfg.max_reproj_error_px)[0]:
                cam, kp, pid = int(link_cam[k]), int(link_kp[k]), int(link_pid[k])
                if self.kp_to_point[cam][kp] < 0:
                    self._note_kp_link(cam, kp, pid)
                    self._record_obs(pid, cam, kp)

        # ---- phase 2: batched pairwise triangulation of fresh matches
        fresh_sets = [(a, b, ka, kb) for (a, b, ka, kb) in fresh_sets if len(ka)]
        if not fresh_sets:
            return 0
        # pair axis padded to a bucket (identity poses, zero masks)
        P = _pad_pow2(len(fresh_sets), lo=1, hi=4096)
        cap = _pad_pow2(max(len(ka) for _, _, ka, _ in fresh_sets))
        x1p = np.zeros((P, cap, 2), np.float32)
        x2p = np.zeros((P, cap, 2), np.float32)
        maskp = np.zeros((P, cap), np.float32)
        R1s = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        t1s = np.zeros((P, 3), np.float32)
        R2s = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
        t2s = np.zeros((P, 3), np.float32)
        for r, (a, b, ka, kb) in enumerate(fresh_sets):
            x1p[r, : len(ka)] = self.kp_xy[a][ka]
            x2p[r, : len(kb)] = self.kp_xy[b][kb]
            maskp[r, : len(ka)] = 1
            R1s[r], t1s[r] = self.poses[a]
            R2s[r], t2s[r] = self.poses[b]
        X_b, ok_b, _ = _triangulate_validated_batch(
            K, self._dev(R1s), self._dev(t1s), self._dev(R2s), self._dev(t2s),
            self._dev(x1p), self._dev(x2p), self._dev(maskp),
            cfg.max_reproj_error_px, cfg.min_parallax_deg, cfg.max_depth_factor,
        )
        X_b = pull(X_b).numpy()
        ok_b = pull(ok_b).numpy()

        total = 0
        for r, (a, b, ka, kb) in enumerate(fresh_sets):
            x1 = self.kp_xy[a][ka]
            for idx in np.nonzero(ok_b[r][: len(ka)])[0]:
                if len(self._pts) >= cfg.max_points:
                    break
                # a fresh match may have been linked by an earlier pair of
                # this same batch: skip it to keep the tracks consistent
                if (
                    self.kp_to_point[a][ka[idx]] >= 0
                    or self.kp_to_point[b][kb[idx]] >= 0
                ):
                    continue
                self._new_point(X_b[r, idx], a, int(ka[idx]), b, int(kb[idx]), x1[idx])
                total += 1
        return total

    # -- stage 6: motion refinement and bundle adjustment ---------------------------

    def _camera_obs_batch(self):
        """Stack every registered camera's observations into (C, cap, ...)
        arrays for batched refinement and error computation."""
        cams = [i for i in sorted(self.registered)
                if (self.kp_to_point[i] >= 0).sum() >= 6]
        if not cams:
            return None
        obs = []
        P_arr = self._points_as_array()
        for i in cams:
            kps = np.nonzero(self.kp_to_point[i] >= 0)[0]
            pids = self.kp_to_point[i][kps]
            obs.append((P_arr[pids], self.kp_xy[i][kps].astype(np.float32)))
        cap = _pad_pow2(max(len(X) for X, _ in obs))
        # camera axis padded to a bucket (zero-weight identity rows)
        C = _pad_pow2(len(cams), lo=2, hi=4096)
        Xs = np.zeros((C, cap, 3), np.float32)
        xs = np.zeros((C, cap, 2), np.float32)
        ws = np.zeros((C, cap), np.float32)
        for r, (X, x) in enumerate(obs):
            Xs[r, : len(X)] = X
            xs[r, : len(x)] = x
            ws[r, : len(X)] = 1
        Rs = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        ts = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (C, 1))
        Rs[: len(cams)] = np.stack([self.poses[i][0] for i in cams])
        ts[: len(cams)] = np.stack([self.poses[i][1] for i in cams])
        return cams, Rs, ts, Xs, xs, ws

    @traced("ba.light")
    def bundle_adjustment_light(self, iterations: int = 2):
        """Motion-only refinement: re-optimize every camera against its
        observations, with the error before and after, in one batched call
        (`iterations` is kept for API parity; the call runs 12 GN
        iterations)."""
        del iterations
        batch = self._camera_obs_batch()
        if batch is None:
            return
        cams, Rs, ts, Xs, xs, ws = batch
        Rn, tn, e0, e1 = _refine_cameras_with_errors(
            self._K_dev(), self._dev(Rs), self._dev(ts),
            self._dev(Xs), self._dev(xs), self._dev(ws),
        )
        Rn = pull(Rn).numpy()
        tn = pull(tn).numpy()
        for r, i in enumerate(cams):
            self.poses[i] = (Rn[r], tn[r])
        print(f"[sfm] motion refinement: reproj {float(pull(e0)):.3f} -> "
              f"{float(pull(e1)):.3f} px")

    @traced("ba.full")
    def bundle_adjustment_full(self, final: bool = False):
        """Full sparse LM bundle adjustment over all cameras and points
        (sfm/bundle.py).

        final=False caps the LM at config.bundle.intermediate_max_iterations:
        mid-reconstruction BAs start near the previous optimum and only
        need to keep the geometry consistent for the next waves; the
        final=True call runs the full budget."""
        if len(self.points3d) < 8 or len(self.registered) < 2:
            return
        points = self._points_as_array()
        # Predict the final sizes from the registration progress, so that
        # the device-resident log keeps one capacity over the run: points
        # and observations grow roughly linearly with registered views.
        V_total = self.image_set.gray.shape[0] if self.image_set else 0
        V_reg = max(len(self.registered), 1)
        grow = max(V_total, V_reg) / V_reg
        n_obs = sum(len(o) for o in self.observations)
        hint = (V_total, int(len(points) * grow), int(n_obs * grow))
        max_iters = None if final else self.config.bundle.intermediate_max_iterations
        if (
            self._obs_log_generation != self._obs_generation
            or len(self._obs_log) != n_obs
        ):
            self._rebuild_obs_log()  # observations were rewritten
        new_poses, new_points, stats = bundle_adjust_log(
            self.camera.K.cpu().numpy(),
            self.poses,
            points,
            self._obs_log.view(),
            self._kp_table(),
            self.config.bundle,
            size_hint=hint,
            max_iterations=max_iters,
            device_cache=self._ba_log_cache,
            device=self.device,
            mesh=self.mesh,
        )
        self.poses = {c: (np.asarray(R), np.asarray(t)) for c, (R, t) in new_poses.items()}
        self.points3d = new_points.astype(np.float32)
        det = self.stats.setdefault(
            "ba_full_detail_s",
            {"prep": 0.0, "table": 0.0, "upload": 0.0,
             "solve_fetch": 0.0, "calls": 0, "iterations": []},
        )
        # bundle_adjust_log's spans inside this call's ba.full span
        sp = current()
        table, upload = sp.within("ba.prep"), sp.within("ba.upload")
        solve_fetch = sp.within("ba.solve") + sp.within("ba.fetch")
        det["prep"] += table + upload
        det["table"] += table
        det["upload"] += upload
        det["solve_fetch"] += solve_fetch
        det["calls"] += 1
        det["iterations"].append(stats.get("iterations", 0))
        print(f"[sfm] full BA: rms {stats.get('rms_before', 0):.3f} -> "
              f"{stats.get('rms_after', 0):.3f} px over {stats.get('num_obs', 0)} obs "
              f"({stats.get('iterations', 0)} iters, prep {table + upload:.2f}s"
              f" [table {table:.2f} upload {upload:.2f}], solve {solve_fetch:.2f}s)")

    def _mean_reproj_error(self) -> float:
        batch = self._camera_obs_batch()
        if batch is None:
            return 0.0
        cams, Rs, ts, Xs, xs, ws = batch
        e = pull(_reproj_errors_batch(
            self._K_dev(), self._dev(Rs), self._dev(ts), self._dev(Xs), self._dev(xs),
        )).numpy()
        sel = ws > 0
        return float(e[sel].mean()) if sel.any() else 0.0

    # -- stage 7: full run --------------------------------------------------------

    @traced("sfm.recover")
    def try_recover_images(self, rounds: int = 3):
        """Retry previously failed registrations, the whole retry set as
        one batched wave per round. Several rounds with fresh RANSAC draws:
        each acceptance triangulates new points, which can give the
        remaining failures enough 2D-3D correspondences."""
        for _ in range(rounds):
            retry = sorted(self.failed)
            if not retry:
                return
            self.failed.clear()
            cands = []
            for i in retry:
                c = self._corr_arrays(i)
                if c is not None:
                    cands.append((i, c[0], c[1]))
            accepted = self._register_wave(cands)
            if accepted:
                self._triangulate_images(accepted)
                self.bundle_adjustment_light()
                print(f"[sfm] recovered {accepted}")
            self.failed.update(set(retry) - set(accepted))
            if not accepted:
                return

    @traced("sfm.rescue")
    def _rescue_unregistered(self) -> int:
        """Last-chance recovery of views the match stage starved
        (feature-poor views whose pair matches never reached
        pnp_min_correspondences, or blocks cut off from the registered
        component).

        try_recover_images can only retry PnP on existing correspondences;
        these views need new ones. One finer-scale (rescue_scale x)
        extraction of the missing views and their window neighbours
        re-matches the local pairs: registered-registered rescue pairs
        triangulate fresh anchor points from known poses, correspondence
        propagation hands those points to the missing views, and
        relaxed-floor registration waves (lower absolute count, stricter
        inlier fraction) bring the block in. Returns the number of views
        recovered."""
        cfg = self.config
        sfm = cfg.sfm
        if not sfm.rescue_unregistered or self.image_set is None:
            return 0
        n = len(self.features)
        missing = sorted(set(range(n)) - self.registered)
        if not missing or len(missing) > sfm.rescue_max_images:
            return 0
        if len(self.registered) < 2:
            return 0
        w = sfm.match_window
        involved = sorted({
            j
            for m in missing
            for j in range(max(0, m - w), min(n, m + w + 1))
        })
        if len(involved) > 2 * sfm.rescue_max_images:
            return 0
        local = {g: l for l, g in enumerate(involved)}
        pairs = [
            (i, j)
            for ai, i in enumerate(involved)
            for j in involved[ai + 1:]
            if j - i <= w
        ]
        if not pairs:
            return 0

        H0, W0 = self.image_set.gray.shape[1:]
        s = float(sfm.rescue_scale)
        if max(H0, W0) * s > 2600:
            s = 1.0  # load res already near the feature-scale floor
        gray = self.image_set.gray[involved]
        if s != 1.0:
            up = pull(resize(torch.from_numpy(np.ascontiguousarray(gray)).to(self.device),
                             (int(H0 * s), int(W0 * s)))).numpy()
        else:
            up = gray
        # SIFT at the finer scale, in neural mode too
        feats = FeatureExtractor(cfg.sift, device=self.device).extract_batch(up)
        res = match_pairs_batched(
            feats, [(local[i], local[j]) for (i, j) in pairs],
            self._generator, cfg.match, mesh=self.mesh,
        )
        xy_up = pull(feats.xy).numpy()
        valid_np = pull(feats.valid).numpy()
        # resize uses half-pixel centres: x_up = s*x + (s-1)/2
        xy_load = (xy_up - (s - 1.0) / 2.0) / s
        S = np.array(
            [[s, 0.0, (s - 1.0) / 2.0],
             [0.0, s, (s - 1.0) / 2.0],
             [0.0, 0.0, 1.0]], np.float32,
        )
        mm = max(8, cfg.match.min_matches // 2)
        offset: Dict[int, int] = {}
        remap: Dict[int, np.ndarray] = {}
        added = 0
        for r, (i, j) in enumerate(pairs):
            (_, _, idx1, idx2, F, n_inl, n_raw) = res[r]
            if n_inl < mm:
                continue
            for g in (i, j):
                if g not in offset:
                    # compact to valid slots; remap match indices through
                    # the compaction (as _rematch_long_span does)
                    keep = np.flatnonzero(valid_np[local[g]])
                    rm = np.full(valid_np.shape[1], -1, np.int64)
                    rm[keep] = np.arange(len(keep))
                    remap[g] = rm
                    offset[g] = len(self.kp_xy[g])
                    self.kp_xy[g] = np.concatenate(
                        [self.kp_xy[g], xy_load[local[g]][keep]]
                    )
                    self.kp_to_point[g] = np.concatenate([
                        self.kp_to_point[g],
                        np.full(len(keep), -1, np.int64),
                    ])
            i1 = remap[i][idx1] + offset[i]
            i2 = remap[j][idx2] + offset[j]
            key = (i, j)
            if key in self.matches and not self.matches[key].get("aux"):
                m0 = self.matches[key]
                m0["idx1"] = np.concatenate([m0["idx1"], i1])
                m0["idx2"] = np.concatenate([m0["idx2"], i2])
                m0["n"] = len(m0["idx1"])
            else:
                self.matches[key] = dict(
                    idx1=i1, idx2=i2, F=S.T @ F @ S, n=len(i1)
                )
            added += 1
        if not added:
            return 0
        self._kp_cache = None
        self._build_kp_links()
        # Anchor points: fresh finer-scale matches between registered rescue
        # pairs triangulate directly from their known poses; _note_kp_link
        # propagation hands the new points to the missing partners' corr.
        for (i, j) in pairs:
            if i in self.registered and j in self.registered:
                self._add_triangulated(i, j)
        floor = sfm.rescue_min_correspondences
        rescued: List[int] = []
        while True:
            cands = []
            for m in sorted(set(range(n)) - self.registered):
                c = self._corr_arrays(m, floor=floor)
                if c is not None:
                    cands.append((m, c[0], c[1]))
            if not cands:
                break
            accepted = self._register_wave(
                cands, min_corr=floor,
                min_inlier_frac=sfm.rescue_min_inlier_frac,
            )
            if not accepted:
                break
            self.failed.difference_update(accepted)
            self._triangulate_images(accepted)
            self.bundle_adjustment_light()
            rescued.extend(accepted)
        if rescued:
            print(f"[sfm] rescued {len(rescued)} starved views: "
                  f"{sorted(rescued)}")
        return len(rescued)

    def reconstruct(
        self,
        image_dir: Optional[str] = None,
        max_images: Optional[int] = None,
        image_set: Optional[ImageSet] = None,
    ):
        """Full pipeline. Returns (points (P, 3) float32, colors (P, 3)
        uint8, poses {idx: CameraPose})."""
        with span("sfm.reconstruct") as root:
            self._front_end(image_dir, max_images, image_set)
            with span("sfm.init") as stage:
                pair = self.find_best_initial_pair()
                if pair is None:
                    raise RuntimeError("no valid initial pair found")
                self.initialize(pair)
            self.stats["init_time"] = stage.seconds
            with span("sfm.incremental") as stage:
                self._incremental()
            self.stats["incremental_time"] = stage.seconds
            self.stats["incremental_breakdown_s"] = {
                k: round(stage.within(name), 3) for k, name in (
                    ("cands", "wave.candidates"), ("register", "wave.pnp"),
                    ("triangulate", "wave.triangulate"), ("ba_light", "ba.light"),
                    ("ba_full", "ba.full"))}
            with span("sfm.final") as stage:
                self.bundle_adjustment_light()
                self.try_recover_images()
                if self._rescue_unregistered():
                    self.try_recover_images()
                self.bundle_adjustment_full(final=True)
                self.drop_invalid_observations()
                self._normalize_reconstruction()
            self.stats["final_ba_time"] = stage.seconds
            self.stats["num_points"] = len(self.points3d)
            self.stats["num_cameras"] = len(self.registered)
            self.stats["mean_reproj_px"] = self._mean_reproj_error()
        self.stats["total_time"] = root.seconds
        accounted = sum(
            self.stats.get(k, 0.0)
            for k in ("load_time", "extract_time", "match_time", "init_time",
                      "incremental_time", "final_ba_time")
        )
        print(
            f"[sfm] done: {len(self.points3d)} points, "
            f"{len(self.registered)}/{len(self.features)} cameras, "
            f"reproj {self.stats['mean_reproj_px']:.3f} px, {root.seconds:.1f}s "
            f"(stages {accounted:.1f}s; load "
            f"{self.stats.get('load_time', 0.0):.1f}s; waves "
            f"{self.stats.get('incremental_breakdown_s')})"
        )

        return self._result()

    def _incremental(self):
        """The registration loop after the initial pair, in WAVES: every
        eligible image PnPs in one batched call and all accepted images
        triangulate together, so the number of rounds drops from O(images)
        to O(waves). Two guards keep wave registration as accurate as a
        sequential one: (1) the wave size ramps with the number of
        registered cameras, so early images, whose PnP points all come from
        the thin initial-pair geometry, register nearly one by one while
        late images batch wide; (2) motion refinement runs after every
        wave, so the next wave's PnP sees polished poses."""
        since_ba = 0
        wave_cap = max(1, self.config.sfm.registration_wave_size)
        while True:
            with span("sfm.wave"):
                cands = self._wave_candidates()
                if not cands:
                    break
                # The ramp doubles but never exceeds 20% of the scene per
                # wave: registering a large fraction of a small scene
                # against stale geometry degrades it.
                n_total = max(len(self.features), 1)
                ramp = min(
                    max(1, len(self.registered) - 1),
                    max(1, int(np.ceil(0.2 * n_total))),
                )
                wave = cands[: min(wave_cap, ramp)]
                accepted = self._register_wave(wave)
                for i, _, _ in wave:
                    if i not in self.registered:
                        self.failed.add(i)
                        print(f"[sfm] failed to register image {i}")
                if accepted:
                    n_new = self._triangulate_images(accepted)
                    since_ba += len(accepted)
                    print(f"[sfm] registered wave {accepted} "
                          f"({len(self.registered)}/{len(self.features)}), +{n_new} points")
                    self.bundle_adjustment_light()
                    # Periodic full BA (points + poses): wave registration
                    # defers the between-image geometry updates of a
                    # sequential order, so drifted points must be re-solved,
                    # not just re-posed.
                    if since_ba >= self.config.sfm.ba_every_n_cameras:
                        self.bundle_adjustment_full()
                        since_ba = 0

    # -- stage 8: normalization + output ------------------------------------------

    @traced("sfm.normalize")
    def _normalize_reconstruction(self):
        """Median-center; scale so that the 90th-percentile radius is
        normalize_scale. Applied to points and camera centers."""
        if len(self.points3d) < 10:
            return
        P = self.points3d
        center = np.median(P, axis=0)
        r = np.linalg.norm(P - center, axis=1)
        p90 = np.percentile(r, 90)
        if p90 < 1e-9:
            return
        s = self.config.sfm.normalize_scale / p90
        self.points3d = ((P - center) * s).astype(np.float32)
        for i, (R, t) in self.poses.items():
            C = -R.T @ t
            Cn = (C - center) * s
            self.poses[i] = (R, (-R @ Cn).astype(np.float32))

    @traced("sfm.sweep")
    def drop_invalid_observations(self, max_px: float = 50.0):
        """Final sweep: drop observations that are behind their camera or
        grossly off (> max_px reprojection), then points left with < 2
        observations. The last full BA can push a tiny-parallax track
        behind its cameras (its depth is unconstrained); one such point
        poisons every mean-reprojection statistic."""
        K = self.camera.K.cpu().numpy().astype(np.float64)
        new_points, new_obs, new_colors = [], [], []
        self.kp_to_point = [np.full(len(k), -1, np.int64) for k in self.kp_xy]
        # Point ids are renumbered below; rebuild the unregistered-image
        # correspondence index too.
        self.corr = {}
        dropped = 0
        for pid, obs in enumerate(self.observations):
            X = np.asarray(self.points3d[pid], np.float64)
            kept = []
            for c, k in obs:
                if c not in self.poses:
                    continue
                R, t = self.poses[c]
                Xc = np.asarray(R, np.float64) @ X + np.asarray(t, np.float64).reshape(3)
                if Xc[2] <= 1e-9:
                    continue
                uv = np.array([
                    K[0, 0] * Xc[0] / Xc[2] + K[0, 2],
                    K[1, 1] * Xc[1] / Xc[2] + K[1, 2],
                ])
                if np.linalg.norm(uv - self.kp_xy[c][k]) <= max_px:
                    kept.append((c, k))
            dropped += len(obs) - len(kept)
            if len(kept) >= 2:
                new_pid = len(new_points)
                new_points.append(self.points3d[pid])
                new_obs.append(kept)
                new_colors.append(self.point_colors[pid])
                for c, k in kept:
                    self._note_kp_link(c, k, new_pid)
        n_pts = len(self.points3d) - len(new_points)
        self.points3d = new_points
        self.observations = new_obs
        self._obs_generation += 1
        self.point_colors = new_colors
        if dropped or n_pts:
            print(f"[sfm] final sweep: -{dropped} obs, -{n_pts} points")

    def save_ply(self, path: str):
        """Write the sparse cloud."""
        save_ply(path, self.points3d.copy(), self.point_colors.copy())

    def save_cameras_ply(self, path: str):
        poses = [
            CameraPose(R=torch.from_numpy(np.array(R)), t=torch.from_numpy(np.array(t)))
            for _, (R, t) in sorted(self.poses.items())
        ]
        if poses:
            save_cameras_ply(path, stack_poses(poses))

    def reconstruct_global(
        self,
        image_dir: Optional[str] = None,
        max_images: Optional[int] = None,
        image_set: Optional[ImageSet] = None,
    ):
        """Global SfM (sfm/global_sfm.py): rotation and translation
        averaging over the whole pose graph instead of incremental
        registration. Same return contract as reconstruct()."""
        from recon3d_tpu_torch.sfm.global_sfm import run_global_sfm

        with span("sfm.reconstruct_global") as root:
            self._front_end(image_dir, max_images, image_set)
            with span("sfm.global") as stage:
                run_global_sfm(self)
            self.stats["global_solve_time"] = stage.seconds
            self.stats["num_points"] = len(self.points3d)
            self.stats["num_cameras"] = len(self.registered)
            self.stats["mean_reproj_px"] = self._mean_reproj_error()
        self.stats["total_time"] = root.seconds
        print(
            f"[sfm] global: {len(self.points3d)} points, "
            f"{len(self.registered)}/{len(self.features)} cameras, "
            f"reproj {self.stats['mean_reproj_px']:.3f} px, "
            f"{self.stats['total_time']:.1f}s"
        )
        return self._result()

    def _front_end(self, image_dir, max_images, image_set) -> None:
        """Stages 1-3 of either reconstruction: take or load the images,
        extract, match."""
        with span("sfm.load") as stage:
            if image_set is not None:
                self.set_image_set(image_set)
            elif image_dir is not None:
                self.load_images(image_dir, max_images)
            elif self.image_set is None:
                raise ValueError("need image_dir or image_set")
        self.stats["load_time"] = stage.seconds
        self.extract_features()
        self.match_image_pairs()

    def _result(self):
        """(points (P, 3) float32, colors (P, 3) uint8, poses {idx:
        CameraPose}): copies of the current reconstruction."""
        poses = {
            i: CameraPose(R=torch.from_numpy(np.array(R)), t=torch.from_numpy(np.array(t)))
            for i, (R, t) in sorted(self.poses.items())
        }
        return self.points3d.copy(), self.point_colors.copy(), poses

    def save_colmap(self, out_dir: str):
        """Export the sparse model as a COLMAP text model (cameras.txt /
        images.txt / points3D.txt) with full 2D-3D tracks."""
        from recon3d_tpu_torch.io.colmap import save_colmap_text

        iset = self.image_set
        save_colmap_text(
            out_dir,
            K=self.camera.K.cpu().numpy(),
            image_size=iset.gray.shape[1:3] if iset is not None else (0, 0),
            poses=self.poses,
            points=self.points3d.copy(),
            colors=self.point_colors.copy(),
            observations=self.observations,
            kp_xy=self.kp_xy,
            names=iset.names if iset is not None else None,
        )
