"""NeuralMatcher: SuperPoint extraction and LightGlue matching behind the
API of the classical front end.

PyTorch port of recon3d_tpu/neural/matcher.py: `extract(image) ->
NeuralFeatures`, `match`, `match_pair_geometric(f1, f2, generator)` with
the contract of features/frontend.FeatureMatcher (matches with an F-RANSAC
inlier mask), and `match_pairs_batched` with the contract of
features/frontend.match_pairs_batched, so that SfMPipeline swaps front
ends without other changes.

Weights: NeuralConfig.superpoint_weights / lightglue_weights may name a
.npz checkpoint of the JAX package's format (either package's
save_params_npz) or a public torch .pth, told apart by the suffix as the
JAX matcher does (convert.read_params_npz, neural/weights.py).
Without them SuperPoint reads the JAX package's bundled checkpoint in
place (recon3d_tpu/neural/pretrained/, resolved from the repository root:
a data file, not an import), and matcher="auto" resolves to mutual-NN
descriptor matching; matcher="lightglue" loads the bundled LightGlue
checkpoint. Sharding pair chunks over several devices (`mesh=`) is not
ported yet (item 12).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.config import MatchConfig, NeuralConfig
from recon3d_tpu_torch.convert import flax_to_state_dict, read_params_npz
from recon3d_tpu_torch.neural.lightglue import (
    LightGlueNet,
    extract_matches,
    normalize_keypoints,
)
from recon3d_tpu_torch.neural.superpoint import (
    NeuralFeatures,
    SuperPointNet,
    detect_keypoints,
    scores_from_logits,
)
from recon3d_tpu_torch.neural.weights import flax_init_
from recon3d_tpu_torch.ops.estimation import estimate_fundamental_ransac
from recon3d_tpu_torch.ops.match import MatchResult, match_descriptors
from recon3d_tpu_torch.runtime.device import resolve_device

# The JAX package's bundled checkpoints, read in place.
PRETRAINED_DIR = Path(__file__).resolve().parents[2] / "recon3d_tpu" / "neural" / "pretrained"
BUNDLED_SUPERPOINT = PRETRAINED_DIR / "superpoint_synthetic.npz"
BUNDLED_LIGHTGLUE = PRETRAINED_DIR / "lightglue_synthetic.npz"


@functools.lru_cache(maxsize=4)
def _read_cached(path: str, mtime: float) -> Dict[str, np.ndarray]:
    """The arrays of a checkpoint, read once per file version (the pipeline
    builds a NeuralMatcher per run; the LightGlue file is 44 MB)."""
    del mtime
    return read_params_npz(path)


def _load(path: Path, module: torch.nn.Module) -> None:
    if path.suffix == ".npz":
        flat = _read_cached(str(path), path.stat().st_mtime if path.exists() else 0.0)
    else:
        flat = read_params_npz(path, module)   # a torch .pth, converted for the module
    module.load_state_dict(flax_to_state_dict(flat, module), strict=True)


class NeuralMatcher:
    """SuperPoint + LightGlue (or mutual-NN) front end on `device`
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, config: Optional[NeuralConfig] = None,
                 match_config: Optional[MatchConfig] = None, device="cuda"):
        self.config = config or NeuralConfig()
        self.match_config = match_config or MatchConfig()
        self.device = resolve_device(device)
        # built without storage (no draw from the global generator); the
        # parameters come from the checkpoints or flax_init_
        with torch.device("meta"):
            self.sp = SuperPointNet(descriptor_dim=self.config.descriptor_dim)
            self.lg = LightGlueNet(dim=self.config.descriptor_dim,
                                   num_layers=self.config.lightglue_layers)
        self._loaded = False
        # "auto": LightGlue only when explicit trained weights are given.
        # The bundled synthetic checkpoint under-recalls its own mutual-NN
        # fallback on photographic texture (docs/neural_quality.md), so
        # auto resolves to the stronger backend; matcher="lightglue" opts
        # into the bundled checkpoint explicitly.
        m = self.config.matcher
        has_lg = bool(self.config.lightglue_weights)
        self.matcher_kind = m if m in ("lightglue", "nn") else ("lightglue" if has_lg else "nn")

    # -- parameters ---------------------------------------------------------

    def _ensure_params(self) -> None:
        if self._loaded:
            return
        gen = torch.Generator().manual_seed(0)
        for module in (self.sp, self.lg):
            module.to_empty(device="cpu")
            flax_init_(module, gen)
        cfg = self.config
        if cfg.superpoint_weights:
            _load(Path(cfg.superpoint_weights), self.sp)
        elif BUNDLED_SUPERPOINT.exists():
            try:
                _load(BUNDLED_SUPERPOINT, self.sp)
            except (KeyError, ValueError):
                pass  # another model configuration: the bundled file does not apply
        if self.matcher_kind == "lightglue":
            if cfg.lightglue_weights:
                _load(Path(cfg.lightglue_weights), self.lg)
            elif BUNDLED_LIGHTGLUE.exists():
                try:
                    _load(BUNDLED_LIGHTGLUE, self.lg)
                except (KeyError, ValueError) as e:
                    if cfg.matcher == "auto":
                        self.matcher_kind = "nn"
                    else:
                        # a network of random weights would match noise
                        raise RuntimeError(
                            "matcher='lightglue' requested but the bundled "
                            f"checkpoint does not fit this model config: {e}. "
                            "Pass lightglue_weights= or use matcher='auto'.") from e
            else:
                raise RuntimeError(
                    "matcher='lightglue' requested but no weights are available "
                    "(no lightglue_weights path and no bundled checkpoint).")
        self.sp.to(self.device).eval()
        self.lg.to(self.device).eval()
        self._loaded = True

    # -- extraction ----------------------------------------------------------

    @torch.no_grad()
    def extract(self, image) -> NeuralFeatures:
        """image: (H, W) grayscale float32 in [0, 1] (numpy or tensor) ->
        padded NeuralFeatures on the matcher's device."""
        self._ensure_params()
        img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image, np.float32))
        img = img.to(self.device, torch.float32)
        h8 = (img.shape[0] // 8) * 8
        w8 = (img.shape[1] // 8) * 8
        logits, desc = self.sp(img[:h8, :w8][None, ..., None])
        cfg = self.config
        return detect_keypoints(
            scores_from_logits(logits)[0], desc[0],
            max_keypoints=cfg.max_keypoints,
            detection_threshold=cfg.detection_threshold,
            nms_radius=cfg.nms_radius,
        )

    # -- matching ------------------------------------------------------------

    def _nn(self, d1, d2, v1, v2) -> MatchResult:
        return match_descriptors(d1, d2, v1, v2, ratio=self.config.nn_ratio)

    @torch.no_grad()
    def _lightglue(self, desc0, desc1, xy0, xy1, v0, v1, hw) -> MatchResult:
        """LightGlue matches of a batch of pairs (B, N, ...)."""
        log_assign, _, _ = self.lg(desc0, desc1, normalize_keypoints(xy0, hw),
                                   normalize_keypoints(xy1, hw), v0, v1)
        m = extract_matches(log_assign, v0, v1,
                            threshold=self.config.lightglue_match_threshold)
        rows = torch.arange(m.idx2.shape[-1], device=m.idx2.device)
        return MatchResult(idx1=rows.expand(m.idx2.shape), idx2=m.idx2,
                           distance=1.0 - m.score, mask=m.mask)

    def match(self, f1: NeuralFeatures, f2: NeuralFeatures,
              hw: Optional[Tuple[int, int]] = None) -> MatchResult:
        self._ensure_params()
        if self.matcher_kind == "nn":
            return self._nn(f1.desc, f2.desc, f1.valid, f2.valid)
        m = self._lightglue(f1.desc[None], f2.desc[None], f1.xy[None], f2.xy[None],
                            f1.valid[None], f2.valid[None], hw or (1024, 1024))
        return MatchResult(*(a[0] for a in m))

    def match_pair_geometric(self, f1: NeuralFeatures, f2: NeuralFeatures,
                             generator: Optional[torch.Generator],
                             min_matches: Optional[int] = None):
        """Matches + fundamental RANSAC: (matches with the inlier mask, F,
        number of inliers), 0 inliers when fewer than min_matches matches."""
        min_matches = min_matches or self.match_config.min_matches

        def run(m):
            _, inl, F, n_inl, n_raw = self._verify(m, f1.xy, f2.xy, generator)
            enough = int(n_raw) >= min_matches
            out = MatchResult(idx1=m.idx1, idx2=m.idx2, distance=m.distance,
                              mask=inl if enough else torch.zeros_like(inl))
            return out, F, (int(n_inl) if enough else 0)

        best = run(self.match(f1, f2))
        if (self.matcher_kind == "lightglue" and self.config.lightglue_nn_fallback
                and best[2] < min_matches):
            # The attention matcher abstained on this pair: try plain
            # mutual-NN matching and keep the better verdict.
            alt = run(self._nn(f1.desc, f2.desc, f1.valid, f2.valid))
            if alt[2] > best[2]:
                best = alt
        return best

    # -- batched pair matching -------------------------------------------------

    def _verify(self, m: MatchResult, xy1, xy2, generator, draws=None):
        """F-RANSAC of the matches of a pair, or of a batch of pairs (leading
        dimensions of m and xy): (idx2, inliers, F, num_inliers, num_raw)."""
        mc = self.match_config
        mask = m.mask
        x1 = torch.where(mask[..., None], xy1, 0.0)
        idx = m.idx2.clamp_min(0)[..., None].expand(m.idx2.shape + (2,))
        x2 = torch.where(mask[..., None], torch.gather(xy2, -2, idx), 0.0)
        res = estimate_fundamental_ransac(
            generator, x1, x2, mask.to(torch.float32),
            threshold_px=mc.ransac_threshold_px, num_hypotheses=mc.ransac_hypotheses,
            sample_indices=draws)
        return m.idx2, mask & res.inliers, res.F, res.num_inliers, mask.sum(dim=-1)

    @torch.no_grad()
    def match_pairs_batched(self, features: Sequence[NeuralFeatures], pairs,
                            generator: Optional[torch.Generator], chunk: int = 8,
                            hw=None, mesh=None, sample_indices: Optional[List[Dict]] = None):
        """All candidate pairs matched (LightGlue or mutual-NN) and
        F-verified, `chunk` pairs a batch. Same return contract as
        features.frontend.match_pairs_batched: (i, j, idx1, idx2, F,
        n_inliers, n_raw) numpy tuples, idx1/idx2 the keypoint indices of
        the geometric inliers.

        Each chunk draws its RANSAC samples from `generator` in chunk
        order: LightGlue's matches first, then, with lightglue_nn_fallback,
        the mutual-NN matches of the same pairs, and per pair the verdict
        with more inliers wins. sample_indices: pre-drawn samples instead,
        one dict per chunk, {"lightglue": (B, H, 8), "nn": (B, H, 8)} int64
        (the tests pass the JAX draws)."""
        if mesh is not None:
            raise NotImplementedError(
                "sharding pair chunks over several devices is not ported yet "
                "(ROADMAP.md, section 1, item 12)")
        self._ensure_params()
        hw = hw or (1024, 1024)
        dev = self.device
        desc = torch.stack([f.desc for f in features]).to(dev)
        xy = torch.stack([f.xy for f in features]).to(dev)
        valid = torch.stack([f.valid for f in features]).to(dev)
        kind = self.matcher_kind
        fallback = kind == "lightglue" and self.config.lightglue_nn_fallback
        chunk_out = []
        for c, c0 in enumerate(range(0, len(pairs), chunk)):
            pij = torch.as_tensor(np.asarray(pairs[c0: c0 + chunk], np.int64).reshape(-1, 2),
                                  device=dev)
            pi, pj = pij[:, 0], pij[:, 1]
            draws = sample_indices[c] if sample_indices is not None else {}
            m_nn = None
            if kind == "nn" or fallback:
                m_nn = self._nn(desc[pi], desc[pj], valid[pi], valid[pj])
            if kind == "nn":
                chunk_out.append(self._verify(m_nn, xy[pi], xy[pj], generator, draws.get("nn")))
                continue
            m = self._lightglue(desc[pi], desc[pj], xy[pi], xy[pj], valid[pi], valid[pj], hw)
            out = self._verify(m, xy[pi], xy[pj], generator, draws.get("lightglue"))
            if fallback:
                alt = self._verify(m_nn, xy[pi], xy[pj], generator, draws.get("nn"))
                take_nn = alt[3] > out[3]
                out = tuple(
                    torch.where(take_nn.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                    for a, b in zip(alt, out))
            chunk_out.append(out)
        idx2, inl, F, n_inl, n_raw = (
            torch.cat(field, dim=0).cpu().numpy() for field in zip(*chunk_out))
        res = []
        for r, (i, j) in enumerate(pairs):
            sel = np.flatnonzero(inl[r])
            res.append((i, j, sel, idx2[r][sel], F[r], int(n_inl[r]), int(n_raw[r])))
        return res
