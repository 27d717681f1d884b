"""Spans, counters, stage timing and the device trace: the port's one
tracing facility.

PyTorch port of recon3d_tpu/runtime/profiling.py (a per-stage timer with a
report, and `maybe_trace`, the trace behind the CLI's --profile), grown into
the spans and counters that every layer of the SfM path records:

- `span(name)` is a context manager that records a named interval on
  `time.time_ns()`, which is the clock of torch.profiler's events, with its
  parent span and its trace. The first span opened while no span is active
  starts a root trace, which every span below it shares. The current span
  is context-local (`contextvars`), so each thread keeps its own.
- `count(name, n)` adds to a counter of the current trace.
- `pull(t)` is the device->host read of the SfM path: `t.cpu()` under a
  `host.pull` span, counted in `host.reads` and `host.read_bytes`.
- `finished()` is the record of the last FINISHED_KEPT root traces, oldest
  first: per span name its seconds, self seconds and count, and the
  counters; the last SPANS_KEPT keep their whole span lists.

With no profiler recording, a span costs two clock reads and an append.
While a torch.profiler session records, a span also enters a
`_RecordFunctionFast` range of its name: a plain CPU operation in the
profiler's trace, never a user annotation, which kineto would copy onto the
device timeline as a CUDA-typed event. So kernels and idle gaps in a trace
fall inside the spans of the layer that caused them.

`StageTimer` (the CLI's stage times) records its stages as spans; the CLI
opens a root span over a run, writes its aggregate to --stats-json as
`stats["trace"]`, and --profile's Chrome trace shows the spans.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

TRACE_NAME = "trace.json"
FINISHED_KEPT = 256      # root traces in finished()
SPANS_KEPT = 8           # of them, the newest that keep their span lists

_current: contextvars.ContextVar = contextvars.ContextVar("recon3d_span", default=None)
_trace_ids = itertools.count(1)
_finished: collections.deque = collections.deque(maxlen=FINISHED_KEPT)
_finished_lock = threading.Lock()


class Trace:
    """The spans (in the order they ended) and counters of one root."""

    __slots__ = ("id", "name", "spans", "counters")

    def __init__(self, name: str):
        self.id = next(_trace_ids)
        self.name = name
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    def aggregate(self) -> dict:
        """{"seconds", "self_seconds", "count"} by span name, and the counters."""
        seconds: Dict[str, float] = {}
        self_seconds: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for s in self.spans:
            d = s.end_ns - s.start_ns
            seconds[s.name] = seconds.get(s.name, 0.0) + d / 1e9
            self_seconds[s.name] = self_seconds.get(s.name, 0.0) + (d - s.child_ns) / 1e9
            counts[s.name] = counts.get(s.name, 0) + 1
        return {"seconds": seconds, "self_seconds": self_seconds, "count": counts,
                "counters": dict(self.counters)}


class Span:
    """One named interval; see `span`."""

    __slots__ = ("name", "parent", "trace", "start_ns", "end_ns", "child_ns", "_first",
                 "_token", "_range")

    def __init__(self, name: str):
        self.name = name
        self.end_ns: Optional[int] = None
        self.child_ns = 0

    def __enter__(self) -> "Span":
        parent = _current.get()
        self.parent = parent
        self.trace = parent.trace if parent is not None else Trace(self.name)
        self._first = len(self.trace.spans)   # every descendant ends after this index
        self._token = _current.set(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _current.reset(self._token)
        self.trace.spans.append(self)
        if self.parent is not None:
            self.parent.child_ns += self.end_ns - self.start_ns
        else:
            _finish(self.trace, ok=exc_type is None)

    @property
    def seconds(self) -> float:
        """The span's duration; up to now while it is open."""
        end = self.end_ns if self.end_ns is not None else time.time_ns()
        return (end - self.start_ns) / 1e9

    def within(self, name: str) -> float:
        """Seconds of the finished spans named `name` below this one."""
        total = 0
        for s in itertools.islice(self.trace.spans, self._first, None):
            if s.name != name or s is self:
                continue
            p = s.parent
            while p is not None and p is not self:
                p = p.parent
            if p is self:
                total += s.end_ns - s.start_ns
        return total / 1e9


def span(name: str) -> Span:
    """A span named `name` (a context manager; `with span(n) as s`)."""
    return Span(name)


def traced(name: str):
    """Decorator: every call of the function runs inside a span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with Span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def current() -> Optional[Span]:
    """The innermost open span of this context, or None."""
    return _current.get()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the current trace (none open: dropped)."""
    s = _current.get()
    if s is not None:
        c = s.trace.counters
        c[name] = c.get(name, 0) + int(n)


def pull(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`, the same read at the same point, under a `host.pull` span
    and counted in `host.reads` and `host.read_bytes`. Every explicit
    device->host read of the SfM path goes through here. A value that is
    not a tensor is on the host already and comes back as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    with Span("host.pull"):
        out = t.cpu()
        count("host.reads")
        count("host.read_bytes", t.numel() * t.element_size())
    return out


def _finish(trace: Trace, ok: bool) -> None:
    entry = {"seq": trace.id, "name": trace.name, "ok": ok, **trace.aggregate()}
    index = {id(s): i for i, s in enumerate(trace.spans)}
    entry["spans"] = [
        {"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
         "parent": index.get(id(s.parent)) if s.parent is not None else None}
        for s in trace.spans
    ]
    with _finished_lock:
        _finished.append(entry)
        if len(_finished) > SPANS_KEPT:
            _finished[-SPANS_KEPT - 1].pop("spans", None)


def finished() -> List[dict]:
    """The finished root traces, oldest first (at most FINISHED_KEPT): each
    {"seq", "name", "ok", "seconds", "self_seconds", "count", "counters"},
    and "spans" ([{"name", "start_ns", "end_ns", "parent"}], parent an
    index into the list) on the newest SPANS_KEPT."""
    with _finished_lock:
        return list(_finished)


class StageTimer:
    """Named stage timings, each stage a span."""

    def __init__(self):
        self._spans: List[Span] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        s = Span(name)
        try:
            with s:
                yield s
        finally:
            self._spans.append(s)

    @property
    def stages(self) -> List[Tuple[str, float]]:
        """(name, seconds) of every finished stage, in the order they ended."""
        return [(s.name, s.seconds) for s in self._spans]

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self):
        stages = self.stages
        if not stages:
            return
        total = sum(dt for _, dt in stages)
        print("[timing]")
        for name, dt in stages:
            print(f"  {name:<20s} {dt:8.2f}s  ({100 * dt / max(total, 1e-9):4.1f}%)")
        print(f"  {'total':<20s} {total:8.2f}s")


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], device="cuda"):
    """torch.profiler trace over the wrapped block when trace_dir is given,
    written to trace_dir/TRACE_NAME. On a CUDA device it records CPU and
    CUDA activity, and raises if it recorded no CUDA kernel or copy; on the
    CPU it records CPU activity only (the CPU build of torch refuses CUDA
    activity). The spans opened inside show as CPU operations."""
    if not trace_dir:
        yield
        return
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
