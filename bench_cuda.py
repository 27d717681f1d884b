"""PatchMatch depth-map throughput of the PyTorch/CUDA port, MP/s on one GPU.

The port's counterpart of bench.py: the same scene, configuration and
method, run through recon3d_tpu_torch/dense/patchmatch.py::
patchmatch_depth_batch (and so K1's `plane` variant) on the card.

    python3 bench_cuda.py                       # on a GPU
    python3 bench_cuda.py --device cpu --views 2 --windows 1 --reps 1 \\
        --patch 5 --iterations 1                # a tiny run on the CPU

Scene (bench.py:57-103): V=16 random 120x160 views (480x640 at scale 0.25)
from np.random.default_rng(0), K at scale 0.25, camera i at (0.3 i, 0, 0),
J=3 source views (i+1..i+3 mod V), depth range 0.5-10. Configuration:
NUM_ITERATIONS=3, NUM_SAMPLES=8, PATCH=11. Method: one warm-up call, then
the best of 3 windows of 32 repetitions, each repetition with fresh
generators seeded by its number (view b's from (rep, b), as
dense/patchmatch.py::view_generator makes them). A window is host-clock
time from its first call to a torch.cuda.synchronize() after its last,
which is what bench.py measures up to its host fetch.

Prints one JSON line, last: {"metric", "value", "unit", "vs_baseline"}
against bench.py's BASELINE_MP_S, with every window's seconds, the card
(nvidia-smi's name and power limit) and K1's launches and plain calls in
the timed windows, with the launches by shape and by variant. Exits non-zero without a GPU unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

BASELINE_MP_S = 0.0167  # bench.py: the reference's torch-CPU PatchMatch
METRIC = "patchmatch_mvs_depthmap_throughput"
H, W, V = 480, 640, 16
SCALE = 0.25
J = 3
NUM_ITERATIONS = 3
NUM_SAMPLES = 8
PATCH = 11
WINDOWS = 3
REPS = 32


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def scene(views: int, device):
    """bench.py's inputs for `views` reference views, on `device`."""
    import torch

    rng = np.random.default_rng(0)
    Hs, Ws = int(H * SCALE), int(W * SCALE)
    K = np.array([[500.0 * SCALE, 0, Ws / 2], [0, 500.0 * SCALE, Hs / 2], [0, 0, 1]],
                 np.float32)
    grays = rng.random((views, Hs, Ws), np.float32)
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (views, 3, 3)).copy()
    ts = np.stack([np.array([0.3 * i, 0.0, 0.0], np.float32) for i in range(views)])
    srcs = [[(i + k + 1) % views for k in range(J)] for i in range(views)]
    arrays = (grays, np.stack([grays[s] for s in srcs]), K, Rs, ts,
              np.stack([Rs[s] for s in srcs]), np.stack([ts[s] for s in srcs]),
              np.tile(np.float32([0.5, 10.0]), (views, 1)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--views", type=int, default=V)
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--patch", type=int, default=PATCH)
    ap.add_argument("--iterations", type=int, default=NUM_ITERATIONS)
    return ap.parse_args(argv)


def make_run(views: int, patch: int, iterations: int, dev):
    """The benchmark's call on `views` reference views: run(rep) returns
    the depth maps of repetition `rep`, its generators fresh from (rep,
    view)."""
    from recon3d_tpu_torch.dense.patchmatch import patchmatch_depth_batch, view_generator

    base = scene(views, dev)

    def run(rep):
        gens = [view_generator(rep, b, dev) for b in range(views)]
        return patchmatch_depth_batch(*base, generators=gens, num_iterations=iterations,
                                      num_samples=NUM_SAMPLES, patch=patch).depth

    return run


def main(argv=None) -> dict:
    """Run the benchmark, print its JSON line and return it."""
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_cuda: no CUDA device visible; pass --device cpu for a CPU run",
              file=sys.stderr)
        raise SystemExit(1)

    from recon3d_tpu_torch.kernels import warp
    from recon3d_tpu_torch.runtime.device import resolve_device

    dev = resolve_device(args.device)
    run = make_run(args.views, args.patch, args.iterations, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    first = run(0)
    sync()
    Hs, Ws = int(H * SCALE), int(W * SCALE)
    if first.shape != (args.views, Hs, Ws) or not bool(torch.isfinite(first).all()):
        raise AssertionError(f"bench_cuda: depth maps of shape {tuple(first.shape)} "
                             "are malformed or not finite")
    windows_s, k1 = [], {}
    with warp.record_launches(k1, "windows"):
        for w in range(args.windows):
            t0 = time.perf_counter()
            depths = [run(w * args.reps + r + 1) for r in range(args.reps)]
            sync()
            windows_s.append(time.perf_counter() - t0)
            del depths
    k1 = k1["windows"]

    mp_s = Hs * Ws * args.views * args.reps / 1e6 / min(windows_s)
    row = {
        "metric": METRIC, "value": mp_s,
        "unit": f"MP/s/{'gpu' if dev.type == 'cuda' else 'cpu'}",
        "vs_baseline": mp_s / BASELINE_MP_S,
        "windows_s": windows_s,
        "device": card_line() if dev.type == "cuda" else "cpu",
        "k1_launches": k1["kernel"], "k1_plain": k1["plain"],
        "k1_by_shape": k1["kernel_by_shape"], "k1_by_variant": k1["kernel_by_variant"],
        "views": args.views, "map": [Hs, Ws], "reps": args.reps,
        "iterations": args.iterations, "samples": NUM_SAMPLES, "patch": args.patch,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
