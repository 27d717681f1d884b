"""Incremental structure-from-motion pipeline: the front end.

PyTorch port of the first three stages of recon3d_tpu/sfm/pipeline.py
(SfMPipeline: load -> extract_features -> match_image_pairs, with the
long-span rematch, the match-graph components and their bridging). The
host Python here is O(images) control flow only; every hot operation is a
batched function of recon3d_tpu_torch.ops on the pipeline's device.

The stages behind the match graph (initial pair, registration waves,
triangulation, bundle adjustment, normalization, export) are not ported
yet and raise NotImplementedError (ROADMAP.md, section 1, item 6); the
neural front end likewise (item 11) and sharding over several devices
(item 12).

Dynamic-size state (matches, keypoint tables) lives on the host in numpy.
Random draws come from one torch.Generator on the device, seeded from
config.sfm.seed and consumed in stage order.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera, load_calibration
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.features.frontend import (
    FeatureExtractor,
    FeatureMatcher,
    feature_slice,
    match_pairs_batched,
)
from recon3d_tpu_torch.io.dataset import ImageSet, load_image_set
from recon3d_tpu_torch.ops.estimation import estimate_homography_ransac
from recon3d_tpu_torch.ops.image import resize
from recon3d_tpu_torch.runtime.device import resolve_device

_BACK_END = ("the SfM back end is not ported yet "
             "(ROADMAP.md, section 1, item 6): {}")


def _pad_pow2(n: int, lo: int = 256, hi: int = 16384, factor: int = 4) -> int:
    """Pad a data-dependent size to a geometric bucket (default x4
    growth), so that device-facing batches take few distinct shapes; the
    padded slots are masked."""
    c = lo
    while c < n and c < hi:
        c *= factor
    return c


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
    """Incremental SfM, stages 1-3.

    Args:
      calibration_path: optional .npz (mtx, dist) file.
      fast_mode: fewer features / looser ratio.
      neural_mode: SuperPoint+LightGlue front end (not ported yet).
      config: full ReconstructionConfig (overrides the fast_mode presets).
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
        if neural_mode:
            raise NotImplementedError(
                "the neural front end is not ported yet (ROADMAP.md, section 1, item 11)")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device matching is not ported yet (ROADMAP.md, section 1, item 12)")
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
        self.matches: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        self.kp_to_point: List[np.ndarray] = []
        self._kp_links: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
        self.stats: Dict = {}

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
        """Feature extraction of every image, as one two-phase batch."""
        t0 = time.time()
        n = self.image_set.gray.shape[0]
        self.kp_xy = []
        self.kp_to_point = []
        # stacked (V, ...) device tensors; per-image views only on demand
        tm: Dict[str, float] = {}
        stacked = self.extractor.extract_batch(self.image_set.gray, timings=tm)
        self.features_stacked = stacked
        self.features = _LazyFeatureList(stacked, n)
        # keypoint pull: the one host sync of the stage. It waits for every
        # describe, then downloads (V, K, 2) + (V, K); the descriptors stay
        # on the device, where matching reads them.
        t_pull = time.time()
        xy_all = stacked.xy.cpu().numpy()
        valid_all = stacked.valid.cpu().numpy()
        tm["kp_pull_sync_s"] = time.time() - t_pull
        self.stats["extract_detail_s"] = {k: round(v, 3) for k, v in tm.items()}
        for r in range(n):
            self.kp_xy.append(xy_all[r])
            self.kp_to_point.append(np.full(xy_all.shape[1], -1, dtype=np.int64))
        counts = valid_all.sum(1).astype(int).tolist()
        self.stats["extract_time"] = time.time() - t0
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
        at a time (features/frontend.py match_pairs_batched)."""
        t0 = time.time()
        n = len(self.features)
        pairs = self._candidate_pairs(n)
        kept = 0
        if pairs:
            tm: Dict[str, float] = {}
            results = match_pairs_batched(
                self.features_stacked, pairs, self._generator,
                self.config.match, timings=tm,
            )
            self.stats["match_detail_s"] = {k: round(v, 3) for k, v in tm.items()}
            mm = self.config.match.min_matches
            for (i, j, idx1, idx2, F, n_inl, n_raw) in results:
                if n_raw >= mm and n_inl >= mm:
                    self.matches[(i, j)] = dict(idx1=idx1, idx2=idx2, F=F, n=len(idx1))
                    kept += 1
            if self.config.match.long_span_rematch:
                kept += self._rematch_long_span(pairs)
        print(f"[sfm] matched {kept}/{len(pairs)} pairs "
              f"({time.time() - t0:.1f}s)")
        self._bridge_components(n)
        self._build_kp_links()
        self.stats["match_time"] = time.time() - t0
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
        feats = self.extractor.extract_batch(up.cpu().numpy())
        res = match_pairs_batched(
            feats, [(local[i], local[j]) for (i, j) in failed],
            self._generator, mc,
        )
        xy_up = feats.xy.cpu().numpy()       # upscaled-pixel coords
        valid_np = feats.valid.cpu().numpy()
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
            if int(hres.num_inliers) >= 0.8 * n_inl:
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
                    mask = m.mask.cpu().numpy()
                    self.matches[(i, j)] = dict(
                        idx1=m.idx1.cpu().numpy()[mask],
                        idx2=m.idx2.cpu().numpy()[mask],
                        F=F.cpu().numpy(),
                        n=int(mask.sum()),
                    )
                    main |= other
                    break

    # -- stages 4 and later: not ported yet ---------------------------------

    def reconstruct(
        self,
        image_dir: Optional[str] = None,
        max_images: Optional[int] = None,
        image_set: Optional[ImageSet] = None,
    ):
        """Stages 1-3, then the back end (which is not ported yet and
        raises NotImplementedError)."""
        t0 = time.time()
        if image_set is not None:
            self.set_image_set(image_set)
        elif image_dir is not None:
            self.load_images(image_dir, max_images)
        elif self.image_set is None:
            raise ValueError("need image_dir or image_set")
        self.stats["load_time"] = time.time() - t0
        self.extract_features()
        self.match_image_pairs()
        return self.find_best_initial_pair()


def _not_ported(name: str):
    def stage(self, *args, **kwargs):
        raise NotImplementedError(_BACK_END.format(f"SfMPipeline.{name}"))

    stage.__name__ = name
    stage.__doc__ = "Not ported yet: raises NotImplementedError."
    return stage


for _name in (
    "find_best_initial_pair", "initialize", "find_next_image", "register_image",
    "triangulate_new_points", "bundle_adjustment_light", "bundle_adjustment_full",
    "try_recover_images", "reconstruct_global", "drop_invalid_observations",
    "save_ply", "save_cameras_ply", "save_colmap",
):
    setattr(SfMPipeline, _name, _not_ported(_name))
del _name
