"""neural.match_mfu: 100 x LightGlue's operations in the window's scenes of
the neural SfM job / (their `neural.match` seconds x the card's float32
peak), the share of the peak that matching reaches.

The operations are benchmark/lightglue_ops.py's count for the network's
shape (the scenes' stats["network"]: slots N, width D, layers L) times the
pairs the scene ran through LightGlue (the `neural.lightglue_pairs`
counter). The time is the `neural.match` span, which ends on the host read
of the results, so it holds all of the network's device work; the
`neural.lightglue` spans only launch it. The scenes are those of
neural.match_s. None where the program keeps no such record."""

from benchmark.lightglue_ops import lightglue_ops
from benchmark.roofline import F32_OPS_PER_S


def _window(rec):
    try:
        from recon3d_tpu_torch.runtime.profiling import finished
    except ImportError:
        return []
    n = len(rec["stats"])
    roots = [r for r in finished() if r["name"] == "sfm.reconstruct" and r["ok"]]
    return roots[-n - 1:-1] if rec["job"] == "sfm_neural" and n and len(roots) > n else []


def read(rec):
    scenes = _window(rec)
    if not scenes:
        return None
    ops = seconds = 0.0
    for r, st in zip(scenes, rec["stats"]):
        pairs = r["counters"].get("neural.lightglue_pairs")
        if pairs is None or "neural.match" not in r["seconds"]:
            return None
        net = st["network"]
        ops += lightglue_ops(net["N"], net["D"], net["L"]) * pairs
        seconds += r["seconds"]["neural.match"]
    return 100.0 * ops / (seconds * F32_OPS_PER_S) if seconds > 0 else None
