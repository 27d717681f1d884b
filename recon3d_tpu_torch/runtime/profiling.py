"""Stage timing + device tracing.

PyTorch port of recon3d_tpu/runtime/profiling.py: a per-stage timer with a
report, and `maybe_trace`, the trace behind the CLI's --profile: a
torch.profiler trace of the wrapped block (in place of jax.profiler.trace)
written as a Chrome trace that chrome://tracing and Perfetto open.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

TRACE_NAME = "trace.json"


class StageTimer:
    """Accumulates named wall-clock stage timings."""

    def __init__(self):
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self):
        if not self.stages:
            return
        total = sum(dt for _, dt in self.stages)
        print("[timing]")
        for name, dt in self.stages:
            print(f"  {name:<20s} {dt:8.2f}s  ({100 * dt / max(total, 1e-9):4.1f}%)")
        print(f"  {'total':<20s} {total:8.2f}s")


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], device="cuda"):
    """torch.profiler trace over the wrapped block when trace_dir is given,
    written to trace_dir/TRACE_NAME. On a CUDA device it records CPU and
    CUDA activity, and raises if it recorded no CUDA kernel or copy; on the
    CPU it records CPU activity only (the CPU build of torch refuses CUDA
    activity)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        yield
        if on_cuda:
            torch.cuda.synchronize()
    if on_cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError("--profile: the trace holds no CUDA activity")
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))
    print(f"[profile] device trace written to {trace_dir}")
