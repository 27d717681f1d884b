"""One scene under torch.profiler, reduced to what the per-layer metrics
and the result's `breakdown` read.

The profiler slows the host several times, so its wall time is not the
scene's: the device's idle share is taken against the unprofiled wall
time of the same scene in the same run (the method of chip_smoke.py's
`profile_run`). Device time is the union of the intervals in which a
kernel, copy or set ran on the card.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

TOP = 10          # entries of each breakdown list
GAPS_LABELLED = 400


def profile_call(fn: Callable, span: str, device) -> Tuple[object, dict]:
    """(fn's result, summary) of fn() run once under the profiler inside a
    record_function range named `span`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        with record_function(span):
            out = fn()
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, summarize(prof, wall, span)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (K, 2) intervals of (N, 2) intervals."""
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = np.append(ends[idx[1:] - 1], ends[-1])
    return np.stack([starts, stops], 1)


def summarize(prof, wall: float, span: str) -> dict:
    """busy_s, device_ops, window_s, ops ({name: [seconds, count]}) and
    breakdown (device_ops and idle_gaps, TOP entries each); busy_s None
    where the profiler recorded no device activity. Reads the raw
    activity records (kineto's), never the profiler's event tree, whose
    building takes minutes for the 10^5-10^6 operations of a scene."""
    from torch.autograd import DeviceType

    dev_iv: List[Tuple[float, float]] = []
    cpu_iv: List[Tuple[float, float]] = []
    cpu_names: List[str] = []
    ops: Dict[str, List[float]] = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name == span:                        # the harness's range, on both timelines
            continue
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            dev_iv.append((start, start + dur))
            op = ops.setdefault(name, [0.0, 0])
            op[0] += dur / 1e6
            op[1] += 1
        elif dur > 0:
            cpu_iv.append((start, start + dur))
            cpu_names.append(name)
    out = {"window_s": wall, "busy_s": None, "device_ops": len(dev_iv), "ops": ops,
           "breakdown": None}
    if not dev_iv:
        return out
    merged = _union(np.asarray(dev_iv, np.float64))
    out["busy_s"] = float((merged[:, 1] - merged[:, 0]).sum()) / 1e6
    gaps = np.stack([merged[:-1, 1], merged[1:, 0]], 1) if len(merged) > 1 else np.zeros((0, 2))
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:GAPS_LABELLED]]
    idle: Dict[str, float] = {}
    if len(cpu_iv):
        cpu = np.asarray(cpu_iv, np.float64)
        for a, b in longest:
            mid = 0.5 * (a + b)
            cover = np.flatnonzero((cpu[:, 0] <= mid) & (cpu[:, 1] >= mid))
            label = (cpu_names[cover[np.argmax(cpu[cover, 0])]] if len(cover)
                     else "host between operations")
            idle[f"{span}: {label}"] = idle.get(f"{span}: {label}", 0.0) + (b - a) / 1e6
    ranked_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]
    out["breakdown"] = {
        "device_ops": [[k[:120], v[0]] for k, v in ranked_ops],
        "idle_gaps": [[k[:120], v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }
    return out
