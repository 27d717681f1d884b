"""Dense SIFT triangulation backend in PyTorch.

Port of recon3d_tpu/dense/sift_dense.py: extract a very large SIFT keypoint
budget per view, match windowed + loop-closure pairs with a relaxed ratio,
triangulate each pair with vectorized cheirality/parallax/reprojection
gates, merge, then k-NN statistical outlier removal and bbox-relative voxel
dedup (reference dense.py:18-315).

What changes against the JAX version:
  - the match stage's random draws come from a torch.Generator seeded
    from `seed` in place of jax.random.PRNGKey(seed);
  - `reconstruct` is `match` followed by `triangulate_and_filter`, which
    takes match_pairs_batched's (a, b, idx1, idx2, F, n_inl, n_raw) list,
    so a test can hand it the JAX package's matches;
  - pairs are triangulated together at one padded capacity (the JAX
    function pads each pair to its own power of 2 and jits one call per
    pair), and the points stay on the device through the k-NN filter (K2)
    and the voxel dedup until one pull at the end; `stats["knn_path"]` is
    the route K2's counters show ran ("cuda", "plain", or "none" where the
    cloud held k points or fewer) and `stats["knn_launches"]` its launches;
  - on the card the number of pairs a match chunk holds comes from the
    free device memory (`pair_chunk`): at the profile's 65,536 keypoints a
    view, the JAX chunk of 64 pairs needs about 200 GB. The chunks draw
    their RANSAC samples in order, so a smaller chunk changes which draws
    a pair gets, not their distribution.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.camera import Camera, projection_from_KRt
from recon3d_tpu_torch.config import DenseSiftConfig, MatchConfig, SiftConfig
from recon3d_tpu_torch.dense.filters import bbox_voxel_downsample, knn_statistical_filter
from recon3d_tpu_torch.features.frontend import (
    FeatureExtractor,
    FeatureMatcher,
    match_capacity,
    match_pairs_batched,
)
from recon3d_tpu_torch.kernels import pointcloud
from recon3d_tpu_torch.ops.triangulate import triangulate_dlt, validate_triangulation
from recon3d_tpu_torch.runtime.device import resolve_device

# Device bytes a pair of a match chunk holds per (RANSAC hypothesis,
# keypoint slot) at its peak: the Sampson residuals of every hypothesis with
# their (H, 3, C) products (ops/epipolar.sampson_distance_batch), about 11
# float32 values a slot; the streaming matcher's (C, 1024) block distances
# need less. scripts/dense_memory_batch_probe.py measures it.
MATCH_BYTES_PER_SLOT = 48
# Share of the free device memory a match chunk may take.
MATCH_MEMORY_SHARE = 0.5
# Keypoint slots a triangulation batch holds (pairs x padded capacity).
TRIANGULATE_SLOTS = 1 << 20


def dense_pairs(n: int, window: int) -> List[Tuple[int, int]]:
    """Sequential window + loop-closure pair policy (reference dense.py:88-95):
    |i - j| <= window, or |i - j| >= n - window (ends meet)."""
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            if j - i <= window or j - i >= n - window:
                out.append((i, j))
    return out


def pair_chunk(capacity: int, num_hypotheses: int, device, default: int = 64) -> int:
    """Pairs a match_pairs_batched chunk holds: the JAX chunk of `default`
    on the CPU; on the card as many as fit MATCH_MEMORY_SHARE of the free
    device memory (what cudaMemGetInfo reports free and what torch's
    allocator holds unused) at MATCH_BYTES_PER_SLOT, at least 1 and at most
    `default`."""
    device = torch.device(device)
    if device.type != "cuda":
        return default
    free = (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    per_pair = MATCH_BYTES_PER_SLOT * num_hypotheses * capacity
    return max(1, min(default, int(MATCH_MEMORY_SHARE * free) // per_pair))


class DenseSiftReconstructor:
    """Dense reconstruction by exhaustive SIFT triangulation (reference
    DenseReconstructor dense.py:18-51), on `device` ("cuda" unless the
    caller asks for "cpu").

    reconstruct(images, poses) -> (points (N,3) float32, colors (N,3) uint8).
    `images`: (V, H, W, 3) float32 [0,1]; `poses`: {idx: (R, t)} numpy.
    `stats` holds the last run's stage times (seconds, each ending in a
    device sync), the match capacity, the pair and chunk counts and which
    k-NN path the filter took.
    """

    def __init__(self, camera: Camera, config: Optional[DenseSiftConfig] = None,
                 device="cuda"):
        self.camera = camera
        self.config = config or DenseSiftConfig()
        self.device = resolve_device(device)
        self.stats: Dict = {}
        cfg = self.config
        # Dense profile of the SIFT/matcher configs (reference dense.py:35-40:
        # huge feature budget, low contrast threshold, CLAHE clip 3.0,
        # relaxed ratio 0.85 :126-130).
        self._extractor = FeatureExtractor(
            SiftConfig(
                max_features=cfg.max_features,
                contrast_threshold=cfg.contrast_threshold,
                edge_threshold=20.0,
                sigma=1.4,
                clahe=True,
                clahe_clip=3.0,
            ),
            device=self.device,
        )
        self._matcher = FeatureMatcher(MatchConfig(ratio=cfg.ratio, cross_check=True))

    def match(self, images: np.ndarray, ids: Sequence[int],
              pair_window: Optional[int] = None, seed: int = 0):
        """Extract the views `ids` of `images` and match their dense pairs.
        Returns (keypoints (V, K, 2) numpy, match_pairs_batched's list)."""
        from recon3d_tpu_torch.io.hostimg import rgb_to_gray_np

        dev = self.device
        t0 = time.perf_counter()
        # gray on the host: extract_batch ships uint8 gray
        feats = self._extractor.extract_batch(rgb_to_gray_np(images[list(ids)]))
        xy_all = feats.xy.cpu().numpy()
        valid = feats.valid.cpu().numpy()
        t1 = time.perf_counter()
        pairs = dense_pairs(len(ids), pair_window or self.config.pair_window)
        C = match_capacity(valid)
        chunk = pair_chunk(C, self._matcher.config.ransac_hypotheses, dev)
        generator = torch.Generator(device=dev).manual_seed(seed)
        results = match_pairs_batched(feats, pairs, generator, self._matcher.config,
                                      chunk=chunk)
        self.stats.update(extract_s=t1 - t0, match_s=time.perf_counter() - t1,
                          keypoints_max=int(valid.sum(1).max()), capacity=C,
                          pairs=len(pairs), pair_chunk=chunk)
        return xy_all, results

    def triangulate_and_filter(self, results, ids: Sequence[int], xy_all: np.ndarray,
                               images: np.ndarray, poses):
        """Triangulate the geometric inliers of every matched pair with at
        least 8 of them, gate them (_triangulate_pair_xy), colour them from
        the pair's first view, then the k-NN filter and the bbox voxel
        dedup. `results`: (a, b, idx1, idx2, F, n_inl, n_raw) with a, b
        positions in `ids` and idx1, idx2 keypoint indices into xy_all[a],
        xy_all[b]."""
        cfg = self.config
        dev = self.device
        t0 = time.perf_counter()
        kept = [r for r in results if r[5] >= 8]
        # one padded capacity for all pairs (the JAX function pads each pair
        # to its own power of 2; padding slots are masked either way)
        cap = 1 << max(8, int(np.ceil(np.log2(max([1] + [len(r[2]) for r in kept])))))
        K = self.camera.K.to(dev, torch.float32)
        Rs = torch.from_numpy(np.stack([poses[i][0] for i in ids]).astype(np.float32)).to(dev)
        ts = torch.from_numpy(np.stack([poses[i][1] for i in ids]).astype(np.float32)).to(dev)
        x1 = np.zeros((len(kept), cap, 2), np.float32)
        x2 = np.zeros((len(kept), cap, 2), np.float32)
        mask = np.zeros((len(kept), cap), bool)
        for k, (a, b, idx1, idx2, *_) in enumerate(kept):
            x1[k, : len(idx1)] = xy_all[a][idx1]
            x2[k, : len(idx2)] = xy_all[b][idx2]
            mask[k, : len(idx1)] = True
        xs = []
        step = max(1, TRIANGULATE_SLOTS // cap)
        for g0 in range(0, len(kept), step):
            sl = slice(g0, g0 + step)
            a_t = torch.tensor([r[0] for r in kept[sl]], device=dev)
            b_t = torch.tensor([r[1] for r in kept[sl]], device=dev)
            xs.append(_triangulate_pair_xy(
                K, Rs[a_t], ts[a_t], Rs[b_t], ts[b_t],
                torch.from_numpy(x1[sl]).to(dev), torch.from_numpy(x2[sl]).to(dev),
                torch.from_numpy(mask[sl]).to(dev),
                max_reproj_px=cfg.max_reproj_error_px,
                min_parallax_deg=cfg.min_parallax_deg,
            ))
        points = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        colors = np.zeros((0, 3), np.uint8)
        if kept:
            X = torch.cat(xs)
            keep = X[..., 0] != torch.inf
            points = X[keep]
            cols = np.stack([_keypoint_colors(images[ids[r[0]]], x1[k])
                             for k, r in enumerate(kept)])
            colors = (cols[keep.cpu().numpy()] * 255).clip(0, 255).astype(np.uint8)
        t1 = time.perf_counter()
        n_raw = len(points)
        before = pointcloud.snapshot()
        if n_raw:
            # on the device: K2's distances, then the voxel dedup
            points, colors = knn_statistical_filter(
                points, colors, k=cfg.knn_k, std_factor=cfg.knn_std_factor
            )
            points, colors = bbox_voxel_downsample(points, colors)
        points = points.cpu().numpy()  # the one pull of the points
        knn = pointcloud.since(before)["knn_mean_dist"]
        self.stats.update(triangulate_s=t1 - t0, filter_s=time.perf_counter() - t1,
                          triangulated_pairs=len(kept), triangulated_points=n_raw,
                          knn_path=("cuda" if knn["kernel"] else "plain" if knn["plain"]
                                    else "none"),
                          knn_launches=knn["kernel"])
        return points, colors

    def reconstruct(
        self,
        images: np.ndarray,
        poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
        pair_window: Optional[int] = None,
        seed: int = 0,
    ):
        t0 = time.perf_counter()
        self.stats = {}
        ids = sorted(poses.keys())
        if len(ids) < 2:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
        xy_all, results = self.match(images, ids, pair_window, seed)
        points, colors = self.triangulate_and_filter(results, ids, xy_all, images, poses)
        self.stats["total_s"] = time.perf_counter() - t0
        print(
            f"[dense-sift] {len(points)} points from {self.stats['pairs']} pairs "
            f"({self.stats['total_s']:.1f}s)"
        )
        return points, colors


def _keypoint_colors(ref_image: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """Colour of the reference image at the rounded keypoints (reference
    dense.py:242-246): (H, W, 3), (N, 2) -> (N, 3)."""
    H, W = ref_image.shape[:2]
    u = np.clip(np.round(x1[:, 0]).astype(np.int32), 0, W - 1)
    v = np.clip(np.round(x1[:, 1]).astype(np.int32), 0, H - 1)
    return ref_image[v, u]


def _triangulate_pair_xy(
    K, R1, t1, R2, t2, x1, x2, mask,
    max_reproj_px: float = 6.0,
    min_parallax_deg: float = 0.3,
):
    """Triangulate matched pairs with the reference's validity gates
    (dense.py:177-248: cheirality 0.1 < z < 50 handled by the generic depth
    gate, parallax, reprojection). Poses (..., 3, 3), (..., 3), pixels
    (..., N, 2), mask (..., N); invalid slots are marked +inf for host-side
    compaction. The colours are _keypoint_colors'."""
    P1 = projection_from_KRt(K, R1, t1)
    P2 = projection_from_KRt(K, R2, t2)
    X = triangulate_dlt(P1, P2, x1, x2)
    ok = mask & validate_triangulation(
        K, R1, t1, R2, t2, X, x1, x2,
        max_reproj_px=max_reproj_px,
        min_parallax_deg=min_parallax_deg,
        max_depth_factor=500.0,
    )
    return torch.where(ok[..., None], X, torch.inf)
