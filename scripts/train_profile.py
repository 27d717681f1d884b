"""Where a training step's time goes on the card: SuperPoint (batch 32 of
128x128 pairs) and LightGlue (16 pairs of 256 keypoints, 9 layers x dim
256) steps as chip_smoke.py's `train` phase runs them, timed to a device
sync and once more under torch.profiler: the device's busy share of the
steps' wall time, the kernels and copies launched a step, and the leading
device operations.

    python3 scripts/train_profile.py [--steps 8]    # needs one GPU
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
# tests/ has no __init__.py: bind the name to the repository's directory
# (an installed package named `tests` would win over it).
_tests = types.ModuleType("tests")
_tests.__path__ = [str(REPO / "tests")]
sys.modules["tests"] = _tests

from recon3d_tpu_torch.neural import synthetic  # noqa: E402
from recon3d_tpu_torch.neural.lightglue import LightGlueNet  # noqa: E402
from recon3d_tpu_torch.neural.superpoint import SuperPointNet  # noqa: E402
from recon3d_tpu_torch.neural.train import (  # noqa: E402
    Adam, TrainState, make_epoch_train_fn, make_lightglue_train_fn,
    warmup_cosine_decay_schedule)
from recon3d_tpu_torch.neural.weights import flax_init_  # noqa: E402
from tests.torch_train_check import lightglue_batch  # noqa: E402


def superpoint_run(steps: int):
    net = flax_init_(SuperPointNet(), torch.Generator().manual_seed(0)).cuda()
    tx = Adam(1e-3)
    state = TrainState(net, tx.init(net.parameters()))
    rng = np.random.default_rng(0)
    batches = [synthetic.make_pair_batch_compact(rng, 32, (128, 128)) for _ in range(2)]
    data = {k: torch.from_numpy(np.stack([b[k] for b in batches])).cuda() for k in batches[0]}
    run = make_epoch_train_fn(net, tx, epochs=steps // 2)
    return lambda: run(state, data)


def lightglue_run(steps: int):
    net = flax_init_(LightGlueNet(), torch.Generator().manual_seed(0)).cuda()
    tx = Adam(warmup_cosine_decay_schedule(0.0, 2e-4, 1, 64, 2e-5), clip_norm=1.0)
    state = TrainState(net, tx.init(net.parameters()))
    data = {k: torch.from_numpy(v).cuda()
            for k, v in lightglue_batch(np.random.default_rng(0), 2, 16, 256, 256).items()}
    run = make_lightglue_train_fn(net, tx, epochs=steps // 2)
    return lambda: run(state, data)


def profile(name: str, make, steps: int) -> dict:
    fn = make(steps)
    fn()                                   # warm-up: cuDNN and cuBLAS choose their kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device kernels and copies; not the ranges that annotate the device's
    # timeline (Optimizer.step#Adam.step spans the optimizer's kernels)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = {"run": name, "steps": steps, "ms_a_step": 1e3 * wall / steps,
           "device_busy_ms_a_step": busy_us / 1e3 / steps,
           "busy_share": busy_us / 1e6 / wall if wall else None,
           "kernels_a_step": launches / steps,
           "top": [{"name": e.key[:90], "ms_a_step": e.self_device_time_total / 1e3 / steps,
                    "calls_a_step": e.count / steps} for e in top]}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8, help="steps a timed window (even)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for name, make in (("superpoint", superpoint_run), ("lightglue", lightglue_run)):
        profile(name, make, a.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
