"""Classical feature front end: SIFT extraction + geometric matching.

PyTorch port of recon3d_tpu/features/frontend.py: FeatureExtractor (CLAHE
preprocessing + SIFT, per image or as a two-phase batch) and FeatureMatcher
(ratio + cross-check + F-RANSAC), and the batched match stage
`match_pairs_batched`. The compute is the batched functions of
recon3d_tpu_torch.ops on the extractor's device; this layer owns the
chunking, the host syncs (one per window of detections, one pull of the
match results) and the host-facing API. The view axis and the pair axis
are tensor dimensions throughout: no Python loop runs over images,
keypoints, pairs or hypotheses.

With a mesh (parallel/mesh.py), match_pairs_batched shards the pair rows
of each chunk over its 'data' axis, the features replicated on every
rank. Each shard returns what one device returns for its rows alone; on
the CPU that is the whole chunk's result bit for bit, on a GPU a pair's
F-RANSAC may round otherwise in a smaller batch (ROADMAP.md, section 3).

Each segment of the extraction and of the match stage is a span
(runtime/profiling.py), and every device->host read goes through its
`pull`; the `timings=` dicts hold the segments' span durations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.config import MatchConfig, SiftConfig
from recon3d_tpu_torch.ops.clahe import clahe
from recon3d_tpu_torch.ops.estimation import estimate_fundamental_ransac
from recon3d_tpu_torch.ops.ransac import indices_from_uniform
from recon3d_tpu_torch.ops.match import (
    MatchResult,
    gather_matched_points,
    match_descriptors,
    match_descriptors_streaming,
)
from recon3d_tpu_torch.ops.sift import (
    SiftFeatures,
    describe_sift,
    detect_sift,
    extract_sift,
)
from recon3d_tpu_torch.runtime.device import resolve_device
from recon3d_tpu_torch.runtime.profiling import pull, span


class FeatureExtractor:
    """SIFT extractor with optional CLAHE preprocessing, on `device`
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, config: Optional[SiftConfig] = None, device="cuda"):
        self.config = config or SiftConfig()
        self.device = resolve_device(device)

    def _preproc(self, img: torch.Tensor) -> torch.Tensor:
        """CLAHE over the largest top-left region divisible by the tile
        grid; the remaining border keeps its pixels. img (..., H, W)."""
        cfg = self.config
        if not cfg.clahe:
            return img
        h, w = img.shape[-2:]
        g = cfg.clahe_grid
        hh, ww = (h // g) * g, (w // g) * g
        eq = clahe(img[..., :hh, :ww], cfg.clahe_clip, g)
        if (hh, ww) == (h, w):
            return eq
        out = img.clone()
        out[..., :hh, :ww] = eq
        return out

    def _detect_kwargs(self) -> dict:
        cfg = self.config
        return dict(
            max_features=cfg.max_features,
            num_octaves=cfg.num_octaves,
            scales=cfg.scales_per_octave,
            sigma0=cfg.sigma,
            contrast_threshold=cfg.contrast_threshold,
            edge_threshold=cfg.edge_threshold,
            upsample=cfg.upsample,
        )

    def extract(self, image) -> SiftFeatures:
        """image: (H, W) grayscale float32 in [0, 1] (numpy or tensor) ->
        SiftFeatures on the extractor's device."""
        img = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        return extract_sift(
            self._preproc(img),
            descriptor_max_value=self.config.descriptor_max_value,
            multi_orientation=self.config.multi_orientation,
            **self._detect_kwargs(),
        )

    def extract_batch(
        self,
        images: np.ndarray,
        chunk: int = 16,
        max_inflight_chunks: int = 4,
        timings: Optional[Dict[str, float]] = None,
    ) -> SiftFeatures:
        """Batched extraction: (V, H, W) float32 in [0, 1] -> one stacked
        SiftFeatures whose tensors have a leading view axis (V, ...).

        Two phases: detection runs at the worst-case candidate capacity
        (max_features slots), then the host fetches only the per-octave
        counts of valid candidates and the describe phase runs at
        selection capacities bucketed to powers of two. Orientation and
        descriptor cost grows with slots, not keypoints, and typical scenes
        fill a small part of the budget.

        Detections are bounded at `max_inflight_chunks` chunks before
        their describes run, so peak device memory is O(window) Gaussian
        pyramids, not O(V): each window launches its detects, fetches its
        counts with one sync, describes, and drops its pyramids before the
        next window starts. Selection capacities are chosen per window;
        windows whose buckets differ are padded to the largest capacity
        when they are joined (padding slots carry valid=False).

        Images ship as uint8 and are divided by 255 on the device. Use
        feature_slice(feats, i) for a single image's view."""
        tm = timings if timings is not None else {}
        for k in ("host_prep_s", "detect_dispatch_s", "counts_sync_s",
                  "describe_dispatch_s", "concat_s"):
            tm.setdefault(k, 0.0)
        cfg = self.config
        images = np.asarray(images)
        V = images.shape[0]
        with span("extract.host_prep") as sp:
            u8 = np.clip(images * 255.0, 0, 255).astype(np.uint8)
        tm["host_prep_s"] += sp.seconds
        window = chunk * max(1, max_inflight_chunks)
        win_feats: List[SiftFeatures] = []
        for w0 in range(0, V, window):
            wu8 = u8[w0: w0 + window]
            det_chunks = []
            with span("extract.detect_dispatch") as sp:
                for c0 in range(0, wu8.shape[0], chunk):
                    batch = torch.from_numpy(wu8[c0: c0 + chunk]).to(self.device)
                    det_chunks.append(detect_sift(
                        self._preproc(batch.to(torch.float32) / 255.0),
                        **self._detect_kwargs()))
            tm["detect_dispatch_s"] += sp.seconds
            # fetch the counts only after the window's chunks have all been
            # launched: a fetch inside the loop would put a sync between them
            with span("extract.counts_sync") as sp:
                counts = pull(torch.cat([c for _, _, c in det_chunks])).numpy()  # (Vw, O)
            tm["counts_sync_s"] += sp.seconds
            caps_det = tuple(int(d["valid"].shape[-1]) for d in det_chunks[0][1])
            # pow-2 buckets with 25% headroom, clipped to the detection
            # caps; one caps_sel per window, so its chunks share a capacity
            caps_sel = tuple(
                min(cap, max(128, 1 << int(np.ceil(np.log2(
                    max(counts[:, o].max(), 1) * 1.25 + 16
                )))))
                for o, cap in enumerate(caps_det)
            )
            chunks = []
            with span("extract.describe_dispatch") as sp:
                while det_chunks:
                    # pop: release each chunk's pyramid as soon as its
                    # describe has been launched
                    pyr, dets, _ = det_chunks.pop(0)
                    chunks.append(describe_sift(
                        pyr, dets, caps_sel,
                        scales=cfg.scales_per_octave,
                        descriptor_max_value=cfg.descriptor_max_value,
                        multi_orientation=cfg.multi_orientation,
                    ))
                    del pyr, dets
            tm["describe_dispatch_s"] += sp.seconds
            with span("extract.concat") as sp:
                win_feats.append(chunks[0] if len(chunks) == 1
                                 else SiftFeatures.cat(chunks, dim=0))
            tm["concat_s"] += sp.seconds
        if len(win_feats) == 1:
            return win_feats[0]
        kmax = max(int(f.valid.shape[1]) for f in win_feats)

        def _pad(a: torch.Tensor) -> torch.Tensor:
            if a.shape[1] == kmax:
                return a
            fill = a.new_zeros((a.shape[0], kmax - a.shape[1]) + a.shape[2:])
            return torch.cat([a, fill], dim=1)

        with span("extract.concat") as sp:
            out = SiftFeatures.cat([f.map(_pad) for f in win_feats], dim=0)
        tm["concat_s"] += sp.seconds
        return out


def feature_slice(stacked: SiftFeatures, i: int) -> SiftFeatures:
    """One image's SiftFeatures view from a stacked (V, ...) batch."""
    return stacked.index(i)


class FeatureMatcher:
    """Descriptor matching + geometric verification.

    match():                ratio test + mutual cross-check.
    match_pair_geometric(): match + fundamental RANSAC; returns matches whose
                            mask marks geometric inliers, and the F matrix.
    """

    def __init__(self, config: Optional[MatchConfig] = None):
        self.config = config or MatchConfig()

    def match(self, f1: SiftFeatures, f2: SiftFeatures) -> MatchResult:
        return match_descriptors(
            f1.desc,
            f2.desc,
            f1.valid.to(torch.float32),
            f2.valid.to(torch.float32),
            ratio=self.config.ratio,
            cross_check=self.config.cross_check,
        )

    def match_pair_geometric(
        self,
        f1: SiftFeatures,
        f2: SiftFeatures,
        generator: Optional[torch.Generator],
        min_matches: Optional[int] = None,
    ):
        """Returns (match_result_with_inlier_mask, F, num_inliers).

        If fewer than min_matches raw matches survive, the mask is all
        false and num_inliers is 0 (the caller drops the pair)."""
        min_matches = min_matches or self.config.min_matches
        m = self.match(f1, f2)
        x1, x2 = gather_matched_points(f1.xy, f2.xy, m)
        res = estimate_fundamental_ransac(
            generator, x1, x2, m.mask.to(torch.float32),
            threshold_px=self.config.ransac_threshold_px,
            num_hypotheses=self.config.ransac_hypotheses,
        )
        enough = int(pull(m.num_matches)) >= min_matches
        inlier_mask = res.inliers & m.mask if enough else torch.zeros_like(m.mask)
        out = MatchResult(idx1=m.idx1, idx2=m.idx2, distance=m.distance, mask=inlier_mask)
        return out, res.F, (int(pull(res.num_inliers)) if enough else 0)


def _match_verify_batch(
    desc: torch.Tensor,      # (V, K, D)
    valid: torch.Tensor,     # (V, K) float
    xy: torch.Tensor,        # (V, K, 2)
    pi: torch.Tensor,        # (P,) pair first-image indices
    pj: torch.Tensor,        # (P,)
    generator: Optional[torch.Generator],
    threshold_px: float,
    ratio: float = 0.75,
    cross_check: bool = True,
    num_hypotheses: int = 1024,
    rows: Optional[Tuple[int, int, int]] = None,
):
    """Match + F-RANSAC for a whole batch of image pairs at once: the pair
    axis is the leading tensor dimension of every step. Uses the streaming
    matcher, so the (K, K) distance matrices never materialize whole.

    rows: (lo, hi, n) when the batch is rows lo:hi of a chunk of n pairs
    (one shard of it): the generator draws the whole chunk's uniforms and
    the batch samples from its rows of them.

    Returns per-pair (idx2 (P, K), inlier_mask (P, K), F (P, 3, 3),
    num_inliers (P,), num_raw (P,))."""
    m = match_descriptors_streaming(
        desc[pi], desc[pj], valid[pi], valid[pj],
        ratio=ratio, cross_check=cross_check,
    )
    x1, x2 = gather_matched_points(xy[pi], xy[pj], m)
    draws = None
    if rows is not None:
        lo, hi, n = rows
        g = torch.rand((n, num_hypotheses, desc.shape[1]), generator=generator,
                       device=desc.device)[lo:hi]
        draws = indices_from_uniform(g, m.mask.to(torch.float32), 8)
    res = estimate_fundamental_ransac(
        generator, x1, x2, m.mask.to(torch.float32),
        threshold_px=threshold_px, num_hypotheses=num_hypotheses, sample_indices=draws,
    )
    return m.idx2, m.mask & res.inliers, res.F, res.num_inliers, m.num_matches


def match_capacity(valid: np.ndarray) -> int:
    """The capacity C that match_pairs_batched compacts (V, K) features to:
    the smallest power of 2, at least 256, that holds every image's valid
    keypoints, and at most K."""
    n = int(valid.sum(1).max()) if valid.size else 0
    return min(1 << max(8, int(np.ceil(np.log2(max(1, n))))), valid.shape[1])


def match_pairs_batched(
    features,                 # stacked SiftFeatures or a list of per-image ones
    pairs: Sequence[Tuple[int, int]],
    generator: Optional[torch.Generator],
    config: Optional[MatchConfig] = None,
    chunk: int = 64,
    timings: Optional[Dict[str, float]] = None,
    mesh=None,
):
    """Host-facing batched pair matching: stacks the per-image features once
    and runs _match_verify_batch over chunks of pairs, drawing each chunk's
    RANSAC samples from `generator` in chunk order.

    mesh: a parallel.mesh.Mesh. The chunk is rounded to a multiple of its
    'data' size (as the JAX function does) and each chunk's pair rows shard
    over 'data'; the compacted features go to every rank. Every rank draws
    each whole chunk's uniforms from a copy of `generator`'s state and
    samples from its rows of them, so each shard's result is one device's
    for those rows (bit for bit; on a GPU the whole chunk in one batch may
    round otherwise, module docstring), and `generator` ends where one
    device leaves it.

    Features are first compacted to the smallest power-of-2 capacity that
    holds every image's valid keypoints: the extraction capacity is a
    worst-case budget while typical images yield far fewer keypoints, and
    matching cost is quadratic in the padded size. idx1/idx2 in the
    returned tuples are translated back to original keypoint indices.

    Returns (i, j, idx1, idx2, F, n_inliers, n_raw) numpy tuples with
    idx1/idx2 the original keypoint indices of the geometric inliers; the
    caller applies the min_matches gates."""
    tm = timings if timings is not None else {}
    cfg = config or MatchConfig()
    with span("match.valid_fetch") as sp:
        if isinstance(features, (list, tuple)):
            features = features[0].map(lambda *a: torch.stack(a), *features[1:])
        dev = features.valid.device
        # the one synchronous fetch of the prep: (V, K) validity bits
        valid_np = pull(features.valid).numpy()
    tm["valid_fetch_s"] = sp.seconds
    with span("match.compact") as sp:
        C = match_capacity(valid_np)
        # stable compaction: valid entries first, remember original indices
        order = np.argsort(~valid_np, axis=1, kind="stable")[:, :C]  # (V, C)
        od = torch.from_numpy(order).to(dev)

        # one gathered compaction per field, on the device
        row = torch.arange(od.shape[0], device=dev)[:, None]
        desc = features.desc[row, od]
        valid = features.valid[row, od].to(torch.float32)
        xy = features.xy[row, od]
    tm["compact_s"] = sp.seconds
    if mesh is not None:
        with span("match.dispatch") as sp:
            n_data = mesh.shape["data"]
            chunk = max(chunk, n_data) // n_data * n_data
            idx2, inl, F, n_inl, n_raw = _match_sharded(
                mesh, desc, valid, xy, pairs, generator, cfg, chunk)
        tm["dispatch_s"] = sp.seconds
        return _translate(pairs, order, C, idx2, inl, F, n_inl, n_raw, tm)
    # Launch every chunk, keep the outputs on the device, then pull each
    # field once: one sync for the whole stage.
    with span("match.dispatch") as sp:
        chunk_out = []
        for c0 in range(0, len(pairs), chunk):
            batch = np.asarray(pairs[c0: c0 + chunk], np.int64).reshape(-1, 2)
            pij = torch.from_numpy(batch).to(dev)
            chunk_out.append(_match_verify_batch(
                desc, valid, xy, pij[:, 0], pij[:, 1], generator,
                float(cfg.ransac_threshold_px),
                ratio=cfg.ratio,
                cross_check=cfg.cross_check,
                num_hypotheses=cfg.ransac_hypotheses,
            ))
    tm["dispatch_s"] = sp.seconds
    with span("match.result_pull") as sp:
        idx2, inl, F, n_inl, n_raw = (
            pull(torch.cat(field, dim=0)).numpy() for field in zip(*chunk_out)
        )
    tm["result_pull_s"] = sp.seconds
    return _translate(pairs, order, C, idx2, inl, F, n_inl, n_raw, tm)


def _translate(pairs, order, C, idx2, inl, F, n_inl, n_raw, tm):
    """The per-pair result tuples, compacted positions translated back to
    the original keypoint ids."""
    with span("match.translate") as sp:
        out = []
        for r, (i, j) in enumerate(pairs):
            # translate compacted positions back to original keypoint ids
            sel = np.flatnonzero(inl[r])
            idx1_orig = order[i][sel]
            idx2_orig = order[j][np.clip(idx2[r][sel], 0, C - 1)]
            out.append((i, j, idx1_orig, idx2_orig, F[r], int(n_inl[r]), int(n_raw[r])))
    tm["translate_s"] = sp.seconds
    return out


def _match_shard(mesh, p: dict):
    """One rank's rows of every chunk (see match_pairs_batched's mesh)."""
    from recon3d_tpu_torch.parallel.mesh import shard_rows

    dev = mesh.device
    desc, valid, xy = (torch.as_tensor(p[k]).to(dev) for k in ("desc", "valid", "xy"))
    gen = torch.Generator(device=dev)
    gen.set_state(p["generator_state"])
    pairs, chunk, cfg = p["pairs"], p["chunk"], p["config"]
    d, n_data = mesh.data_index, mesh.shape["data"]
    out = []
    for c0 in range(0, len(pairs), chunk):
        batch = np.asarray(pairs[c0: c0 + chunk], np.int64).reshape(-1, 2)
        lo, hi = shard_rows(len(batch), n_data)[d]
        if hi == lo:   # no rows here: still draw the chunk, as every rank does
            torch.rand((len(batch), cfg.ransac_hypotheses, desc.shape[1]), generator=gen,
                       device=dev)
            continue
        pij = torch.from_numpy(batch[lo:hi]).to(dev)
        out.append(_match_verify_batch(
            desc, valid, xy, pij[:, 0], pij[:, 1], gen, float(cfg.ransac_threshold_px),
            ratio=cfg.ratio, cross_check=cfg.cross_check,
            num_hypotheses=cfg.ransac_hypotheses, rows=(lo, hi, len(batch))))
    if mesh.model_index:
        return None
    if not out:
        return None if mesh.rank else ([], gen.get_state())
    res = [torch.cat(field, dim=0) for field in zip(*out)]
    if mesh.rank == 0:
        return res, gen.get_state()
    return [pull(r).numpy() for r in res]


def _match_sharded(mesh, desc, valid, xy, pairs, generator, cfg, chunk):
    """match_pairs_batched's chunks with their pair rows sharded over the
    mesh's 'data' axis; returns the fields (idx2, inliers, F, n_inliers,
    n_raw) of all pairs on the host, in pair order, and leaves
    `generator` where the one-device loop leaves it."""
    if generator is None:
        raise ValueError("match_pairs_batched(mesh=...) needs a torch.Generator: every rank "
                         "draws from a copy of its state")
    common = dict(pairs=[tuple(map(int, q)) for q in pairs], chunk=chunk, config=cfg,
                  generator_state=generator.get_state())
    rank0 = dict(desc=desc, valid=valid, xy=xy, **common)
    host = dict(desc=pull(desc), valid=pull(valid), xy=pull(xy), **common)
    res = mesh.call(_match_shard, [rank0] + [host] * (mesh.world - 1))
    (own, state), rest = res[0], res[1:]
    generator.set_state(state)
    from recon3d_tpu_torch.parallel.mesh import chunk_rows_in_order

    fields = [[pull(o).numpy() for o in own]] + rest
    # the ranks of model index 0, in data order, each with its rows of every chunk
    return tuple(chunk_rows_in_order(fields[::mesh.shape["model"]], len(pairs), chunk))
