"""Stage timing.

PyTorch port of recon3d_tpu/runtime/profiling.py: `StageTimer` only. The
device trace behind `--profile` is not ported yet.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple


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
