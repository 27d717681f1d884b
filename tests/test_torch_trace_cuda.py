"""The port's spans on the card: a small SfM scene under torch.profiler
(the benchmark's dtu49.sfm job on 6 views of 192x256, rendered on the card).

- No CUDA-typed event of the trace bears a span's name: a span enters a
  plain CPU range (`_RecordFunctionFast`), never a user annotation, which
  kineto would copy onto the device timeline.
- benchmark/profiler_summary.py counts as many device operations in the
  scene as in the same scene with the spans' profiler ranges stubbed out.
- The census of synchronizing calls under
  `torch.cuda.set_sync_debug_mode("warn")`: by call site, inside and
  outside `host.pull` (boolean masks, `nonzero` and the like are the
  implicit reads). The test checks that the census runs and prints it.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -s tests/test_torch_trace_cuda.py
"""

import collections
import json
import os
import traceback
import warnings

import pytest
import torch

from benchmark import profiler_summary
from benchmark import run as bench
from benchmark.tests._tiny import SMALL, files
from recon3d_tpu_torch.runtime import profiling

pytestmark = pytest.mark.cuda

PKG = os.sep + "recon3d_tpu_torch" + os.sep


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (traces the card)")
    f = files("dtu49.sfm", SMALL)
    job = bench.load_module(bench.BENCH / "jobs" / "sfm.py", "job_sfm_trace")
    state = job.setup(f["config"], f["traffic"], 2**31 + 29, "cuda")

    def run():
        job.run(state, 0)
        torch.cuda.synchronize()

    run()                                      # warm-up: every kernel built and loaded
    return run


def _profiled(run):
    return profiler_summary.profile_call(run, "scene.sfm", "cuda")


def test_no_device_event_bears_a_span_name(cuda_scene):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_scene()
    names = set(profiling.finished()[-1]["count"])
    assert {"sfm.reconstruct", "ba.lm_step", "host.pull"} <= names
    device, host = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        side = device if e.device_type() == torch.autograd.DeviceType.CUDA else host
        side[e.name()] += 1
    assert sum(device.values()) > 0
    assert not names & set(device), sorted(names & set(device))
    assert names <= set(host)


def test_spans_add_no_device_operation(cuda_scene, monkeypatch):
    # stubbed: no span enters a profiler range, as before the spans existed
    monkeypatch.setattr(profiling, "_autograd_profiler",
                        type("off", (), {"_is_profiler_enabled": False}))
    stubbed = _profiled(cuda_scene)[1]
    monkeypatch.undo()
    traced = _profiled(cuda_scene)[1]
    spans = set(profiling.finished()[-1]["count"])
    differ = {k: traced["ops"].get(k, [0, 0])[1] - stubbed["ops"].get(k, [0, 0])[1]
              for k in set(traced["ops"]) | set(stubbed["ops"])}
    print(f"\n[trace] device_ops stubbed {stubbed['device_ops']} traced "
          f"{traced['device_ops']} ({len(spans)} span names); counts that differ "
          f"{ {k[:60]: v for k, v in differ.items() if v} }; "
          f"idle gaps {traced['breakdown']['idle_gaps']}")
    assert not spans & set(traced["ops"])
    # Two runs of the scene in one process can differ by an operation
    # (54,323 against 54,324 on the H100); spans on the device timeline
    # would add one operation for each of the scene's hundreds of spans.
    assert abs(traced["device_ops"] - stubbed["device_ops"]) <= 1e-4 * stubbed["device_ops"]
    assert stubbed["device_ops"] > 0


def test_sync_census(cuda_scene):
    """Every synchronizing call of a scene by call site (the innermost
    frame in the port outside runtime/profiling.py), inside or outside a
    `host.pull` span."""
    census = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        site = next((f"{os.path.relpath(f.filename)}:{f.lineno} {f.name}"
                     for f in reversed(traceback.extract_stack()[:-1])
                     if PKG in f.filename and not f.filename.endswith("profiling.py")),
                    "outside the port")
        span = profiling.current()
        inside = any(s.name == "host.pull" for s in _ancestry(span))
        census[("host.pull" if inside else "implicit", site)] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cuda_scene()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rows = sorted(census.items(), key=lambda kv: -kv[1])
    out = {"pulled": sum(n for (k, _), n in rows if k == "host.pull"),
           "implicit": [[site, n] for (k, site), n in rows if k == "implicit"]}
    print("\n[census] " + json.dumps(out, indent=1))
    assert rows and out["pulled"] > 0


def _ancestry(span):
    while span is not None:
        yield span
        span = span.parent
