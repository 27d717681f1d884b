"""Two measurements behind the checkpoint branch and dense SIFT's chunking,
on the card.

    python3 scripts/dense_memory_batch_probe.py

1. Does a PatchMatch view's map depend on the other views of its batch?
   PatchMatchMVS's batches of a full run, then some of their views run as
   a batch of another size: per view, bit-equal or not, the largest depth
   difference and the share of pixels within 1e-3 relative (the small
   scene of tests/test_torch_checkpoint.py, then 8 views of 480x640 at the
   CLI's settings).
2. The device memory match_pairs_batched holds per (RANSAC hypothesis,
   keypoint slot) at dense SIFT's budget: 16 views of 65,536 random unit
   descriptors, chunks of 1, 2 and 4 pairs, the peak of allocated memory
   above what the inputs hold, over chunk x 1,024 x 65,536
   (dense/sift_dense.MATCH_BYTES_PER_SLOT).

Prints one JSON line each.
"""

from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
_tests = types.ModuleType("tests")  # as chip_smoke.py binds it
_tests.__path__ = [str(REPO / "tests")]
sys.modules["tests"] = _tests

from recon3d_tpu_torch.camera import Camera  # noqa: E402
from recon3d_tpu_torch.config import MatchConfig, PatchMatchConfig  # noqa: E402
from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS  # noqa: E402
from recon3d_tpu_torch.features.frontend import match_pairs_batched  # noqa: E402
from tests.render import render_views  # noqa: E402


def batch_dependence(scene, cfg, part):
    """Maps of the views `part` run as one batch against the same views in
    the batches of a full run."""
    n = len(scene["Rs"])
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(n)}
    rec = PatchMatchMVS(Camera.from_matrix(scene["K"]), cfg, device="cuda")
    inner, seen = rec._depth_batches, {}

    def spy(positions, *args):
        seen["args"] = args
        return inner(positions, *args)

    rec._depth_batches = spy
    rec.reconstruct(scene["images"], poses)
    full = {}
    for pos, out in inner(list(range(n)), *seen["args"]):
        for r, v in enumerate(pos):
            full[v] = out.depth[r].cpu().numpy()
    rows = []
    for pos, out in inner(part, *seen["args"]):
        for r, v in enumerate(pos):
            d = out.depth[r].cpu().numpy()
            rows.append({"view": v, "batch": len(pos), "bit_equal": bool(np.array_equal(d, full[v])),
                         "max_abs": float(np.abs(d - full[v]).max()),
                         "share_within_1e-3": float((np.abs(d - full[v]) / full[v] < 1e-3).mean())})
    return rows


def match_bytes_per_slot(V=16, C=65536, chunks=(1, 2, 4)):
    gen = torch.Generator(device="cuda").manual_seed(0)
    desc = torch.randn(V, C, 128, device="cuda", generator=gen)
    desc /= torch.linalg.norm(desc, dim=-1, keepdim=True)
    feats = types.SimpleNamespace(
        desc=desc, valid=torch.ones(V, C, dtype=torch.bool, device="cuda"),
        xy=torch.rand(V, C, 2, device="cuda", generator=gen) * 500)
    cfg = MatchConfig(ratio=0.85, cross_check=True)
    base = torch.cuda.memory_allocated()
    rows = []
    for chunk in chunks:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        match_pairs_batched(feats, [(i, i + 1) for i in range(chunk)],
                            torch.Generator(device="cuda").manual_seed(0), cfg, chunk=chunk)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        rows.append({"chunk": chunk, "peak_bytes": peak, "seconds": time.perf_counter() - t0,
                     "bytes_per_slot": peak / (chunk * cfg.ransac_hypotheses * C)})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = render_views(n_views=5, image_size=(96, 128), arc_step=0.12)
    cfg = PatchMatchConfig(scale=1.0, num_iterations=2, patch_size=7, min_views=3,
                           voxel_size=0.01)
    print(json.dumps({"batch_dependence_small": batch_dependence(small, cfg, [3, 4])}))
    big = render_views(n_views=8, image_size=(480, 640), arc_step=0.035)
    print(json.dumps({"batch_dependence_480x640": batch_dependence(big, PatchMatchConfig(),
                                                                   [6, 7])}))
    print(json.dumps({"match_bytes_per_slot": match_bytes_per_slot()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
