"""Per-stage throughput of the PyTorch/CUDA port on one GPU.

The port's counterpart of scripts/bench_stages.py, with its six stages and
sizes: bench_cuda.py prints the PatchMatch throughput alone; this script
measures every hot stage, so that a change is seen stage by stage.

- sift_extract      batched SIFT on rendered 480x640 views, ms an image
                    (and on saturated noise)
- match_verify      the batched matcher with F-RANSAC over all pairs, pairs/s
- plane_sweep       64-plane sweep of 4 reference views, depth-map MP/s
- patchmatch_mvs    bench_cuda.py's metric (with --quick: 1 window of 4 reps;
                    on the CPU, bench_cuda.py's tiny CPU size)
- bundle_adjust_full  full BA, ms an LM iteration
- tsdf_integration  TSDF fusion of 8 views, million voxel observations/s

Usage: python3 scripts/bench_stages_torch.py [--quick] [--skip STAGE ...]
           [--repeat N] [--md PATH] [--device cpu]

Prints one JSON line per metric. Every timed call ends at a
torch.cuda.synchronize() (on the CPU, at its return); a stage's value is
its best window, after one warm-up call. Each line carries K1's launches
and plain calls in its stage, warm-up included, with the launches by shape
and by variant. Exits non-zero without a GPU unless --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
# tests/ has no __init__.py, so an installed package named `tests` would win
# over it: bind the name to the repository's directory (for tests.render).
if "tests" not in sys.modules:
    _tests = types.ModuleType("tests")
    _tests.__path__ = [str(REPO / "tests")]
    sys.modules["tests"] = _tests

STAGES = ("sift", "match", "sweep", "patchmatch", "bundle", "tsdf")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _steady(fn, dev, windows=3, reps=4):
    """Best-window seconds a call, after one warm-up call."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        outs = [fn() for _ in range(reps)]
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)
        del outs
    return best


def _segments(run, reps=3):
    """Seconds a call of run(timings) over reps calls after one warm-up
    call, and each segment's seconds in every call."""
    run({})
    seg_reps = []
    t0 = time.perf_counter()
    for _ in range(reps):
        seg_reps.append({})
        run(seg_reps[-1])
    dt = (time.perf_counter() - t0) / reps
    return dt, {k: [r[k] for r in seg_reps] for k in seg_reps[0]}


def _rendered_grays(n: int) -> np.ndarray:
    from tests.render import render_views

    scene = render_views(n_views=n, image_size=(480, 640), arc_step=0.08)
    return np.stack([im.mean(-1) for im in scene["images"]]).astype(np.float32)


def bench_sift(dev, quick=False):
    """Batched SIFT on rendered views (a few hundred keypoints against the
    budget); on value noise, which fills every octave's cap, as
    saturated_ms_per_image."""
    from recon3d_tpu_torch.features.frontend import FeatureExtractor

    B = 4 if quick else 8
    imgs = _rendered_grays(B)
    ex = FeatureExtractor(device=dev)
    dt = _steady(lambda: ex.extract_batch(imgs), dev)
    noise = np.random.default_rng(0).random((B, 480, 640), np.float32)
    dt_max = _steady(lambda: ex.extract_batch(noise), dev)
    return {"metric": "sift_extract", "value": dt / B * 1e3, "unit": "ms/image",
            "saturated_ms_per_image": dt_max / B * 1e3}


def bench_match(dev, quick=False):
    import torch

    from recon3d_tpu_torch.features.frontend import FeatureExtractor, match_pairs_batched

    n = 6 if quick else 10
    feats = FeatureExtractor(device=dev).extract_batch(_rendered_grays(n))
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]

    def run(tm):
        match_pairs_batched(feats, pairs, torch.Generator(device=dev).manual_seed(0),
                            chunk=len(pairs), timings=tm)
        _sync(dev)

    dt, segments = _segments(run)
    return {"metric": "match_verify", "value": len(pairs) / dt, "unit": "pairs/s",
            "segments_s": segments}


def bench_plane_sweep(dev, quick=False):
    """4 reference views swept as one batch, 5 sources each, 16 calls a
    window (bench_stages.py's vmapped batch)."""
    import torch

    from recon3d_tpu_torch.dense.plane_sweep import sweep_depth_maps

    rng = np.random.default_rng(0)
    Hs, Ws, J, V = 120, 160, 5, 4
    K = np.array([[125.0, 0, Ws / 2], [0, 125.0, Hs / 2], [0, 0, 1]], np.float32)
    refs = rng.random((V, Hs, Ws), np.float32)
    srcs = rng.random((V, J, Hs, Ws), np.float32)
    tsrc = np.broadcast_to(np.stack([[0.3 * (i + 1), 0, 0] for i in range(J)]).astype(np.float32),
                           (V, J, 3))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        refs, srcs, K, np.broadcast_to(np.eye(3, dtype=np.float32), (V, 3, 3)),
        np.zeros((V, 3), np.float32),
        np.broadcast_to(np.eye(3, dtype=np.float32), (V, J, 3, 3)), tsrc,
        np.float32([0.5, 10.0]))]
    dt = _steady(lambda: sweep_depth_maps(*args), dev, reps=16)
    return {"metric": "plane_sweep", "value": Hs * Ws * V / 1e6 / dt, "unit": "MP/s"}


def bench_patchmatch(dev, quick=False):
    import bench_cuda

    argv = ["--device", dev.type]
    if quick and dev.type == "cpu":
        argv += ["--windows", "1", "--reps", "1", "--views", "2", "--patch", "5",
                 "--iterations", "1"]
    elif quick:
        argv += ["--windows", "1", "--reps", "4"]
    with contextlib.redirect_stdout(io.StringIO()):
        row = bench_cuda.main(argv)
    return {"metric": "patchmatch_mvs", "value": row["value"], "unit": row["unit"],
            "vs_baseline": row["vs_baseline"], "windows_s": row["windows_s"],
            "views": row["views"], "reps": row["reps"]}


def make_problem(nC, nP, obs_per_pt=5, seed=0):
    """scripts/tpu_ba_ab.py::make_problem: nC cameras on an arc, nP points
    seen by obs_per_pt of them each with 1 px of noise, points perturbed by
    0.05."""
    rng = np.random.default_rng(seed)
    K = np.array([[500., 0, 320], [0, 500., 240], [0, 0, 1]], np.float32)
    poses = {}
    for c in range(nC):
        th = 0.6 * np.pi * c / nC
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]], np.float32)
        poses[c] = (R, np.float32([0.1 * c, 0, 6]))
    X = rng.uniform(-2, 2, (nP, 3)).astype(np.float32)
    obs, kp = [], [[] for _ in range(nC)]
    for p in range(nP):
        cams = rng.choice(nC, size=obs_per_pt, replace=False)
        o = []
        for c in cams:
            R, t = poses[c]
            Xc = R @ X[p] + t
            if Xc[2] < 0.1:
                continue
            uv = K @ (Xc / Xc[2])
            o.append((int(c), len(kp[c])))
            kp[c].append(uv[:2] + rng.normal(0, 1.0, 2))
        obs.append(o)
    kp = [np.asarray(k, np.float32).reshape(-1, 2) for k in kp]
    Xn = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return K, poses, Xn, obs, kp


def bench_bundle(dev, quick=False):
    """Full BA (LM with robust reweighting, Schur-CG solves), ms an LM
    iteration, after one warm-up solve."""
    from recon3d_tpu_torch.config import BundleConfig
    from recon3d_tpu_torch.sfm.bundle import bundle_adjust

    nC, nP = (12, 1200) if quick else (40, 4000)
    problem = make_problem(nC, nP)
    cfg = BundleConfig()
    bundle_adjust(*problem, cfg, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    _, _, st = bundle_adjust(*problem, cfg, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    iters = max(st.get("iterations", 1), 1)
    return {"metric": "bundle_adjust_full", "value": dt / iters * 1e3,
            "unit": f"ms/LM-iter ({nC}cam/{nP}pt)", "iterations": iters}


def bench_tsdf(dev, quick=False):
    """TSDF integration: one view's contribution to every voxel counts as
    resolution^3 observations."""
    from recon3d_tpu_torch.dense.tsdf import fuse_tsdf

    res = 64 if quick else 128
    V, H, W = 8, 120, 160
    rng = np.random.default_rng(0)
    K = np.array([[130.0, 0, W / 2], [0, 130.0, H / 2], [0, 0, 1]], np.float32)
    depths = (rng.random((V, H, W)) * 2 + 2).astype(np.float32)
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (V, 3, 3)).copy()
    ts = np.stack([np.float32([0.1 * i, 0, 0]) for i in range(V)])
    bounds = (np.float32([-2, -2, 1]), np.float32([2, 2, 5]))

    def run(tm):
        fuse_tsdf(depths, None, K, Rs, ts, bounds=bounds, resolution=res, timings=tm,
                  device=dev)
        _sync(dev)

    dt, segments = _segments(run)
    return {"metric": "tsdf_integration", "value": V * res ** 3 / dt / 1e6,
            "unit": f"Mvoxel-obs/s (res {res})", "segments_s": segments}


BENCHES = dict(zip(STAGES, (bench_sift, bench_match, bench_plane_sweep, bench_patchmatch,
                            bench_bundle, bench_tsdf)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--md", type=str, default=None, help="also write a markdown table here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip", nargs="*", default=[], choices=STAGES)
    ap.add_argument("--repeat", type=int, default=1,
                    help="run each selected stage N times in-process and report the "
                         "spread of its values")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_stages_torch: no CUDA device visible; pass --device cpu for a CPU run",
              file=sys.stderr)
        return 1
    from recon3d_tpu_torch.kernels import warp
    from recon3d_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import bench_cuda

        where = bench_cuda.card_line()
    else:
        where = "cpu"

    rows = []
    for name, fn in BENCHES.items():
        if name in args.skip:
            continue
        vals = []
        for _ in range(max(1, args.repeat)):
            by_stage = {}
            with warp.record_launches(by_stage, name):
                row = fn(dev, quick=args.quick)
            k1 = by_stage[name]
            row.update(device=where, k1_launches=k1["kernel"], k1_plain=k1["plain"],
                       k1_by_shape=k1["kernel_by_shape"],
                       k1_by_variant=k1["kernel_by_variant"])
            vals.append(row["value"])
            print(json.dumps(row), flush=True)
        if len(vals) > 1:
            lo, hi = min(vals), max(vals)
            print(json.dumps({"metric": f"{row['metric']}_stability", "runs": vals,
                              "spread_pct": 100 * (hi - lo) / max(abs(hi), 1e-9),
                              "device": where}), flush=True)
        rows.append(row)

    if args.md:
        lines = ["# Per-stage benchmarks of the PyTorch/CUDA port", "",
                 f"Device: {where}; best window after one warm-up call; every timed "
                 "call ends at a device synchronisation. Regenerate with "
                 "scripts/bench_stages_torch.py.", "",
                 "| stage | value | unit |", "|---|---|---|"]
        lines += [f"| {r['metric']} | {r['value']:.4g} | {r['unit']} |" for r in rows]
        lines += ["", f"Generated {time.strftime('%Y-%m-%d')}.", ""]
        Path(args.md).write_text("\n".join(lines))
        print(f"wrote {args.md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
