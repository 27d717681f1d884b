"""What the port's spans cost: the wall time of the benchmark's dtu49.sfm
scene with the spans and with them stubbed out, with torch.profiler off
and on, on the card.

    python scripts/span_overhead.py [--seed N] [--repeats 2] [--out FILE]

The scene is the benchmark's own (benchmark/jobs/sfm.py on the dtu49
configuration, one capture from the seed), warmed up once. A stubbed span
keeps the context variable, so `current()` and the stage views still work,
but reads no clock, records nothing and enters no profiler range. For each
profiler mode the runs go in turns (stubbed, spans, spans, stubbed) x
repeats. With the profiler on the scene runs as the benchmark's traced
scene does (benchmark/profiler_summary.py), whose idle-gap labels are
printed too; for each mode, the spans (seconds, self seconds and count by
name) and counters of its last scene with spans. Prints one JSON object;
--out writes it to a file as well.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def stubbed_spans():
    """Spans that only keep the context variable."""
    from recon3d_tpu_torch.runtime import profiling

    Span = profiling.Span
    saved = Span.__enter__, Span.__exit__
    null = profiling.Trace("stubbed")

    def enter(self):
        self.parent, self.trace, self._first = profiling._current.get(), null, 0
        self.start_ns = self.end_ns = 0
        self._token = profiling._current.set(self)
        return self

    def exit(self, *exc):
        profiling._current.reset(self._token)

    Span.__enter__, Span.__exit__ = enter, exit
    try:
        yield
    finally:
        Span.__enter__, Span.__exit__ = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import profiler_summary, run as bench
    from recon3d_tpu_torch.runtime import profiling

    if not torch.cuda.is_available():
        print("span_overhead: needs a CUDA device", file=sys.stderr)
        return 2
    files = bench.cell_files("dtu49.sfm")
    job = bench.load_module(bench.BENCH / "jobs" / "sfm.py", "job_sfm")
    state = job.setup(files["config"], files["traffic"], args.seed, "cuda")
    job.run(state, 0)
    torch.cuda.synchronize()

    def scene(profiled: bool):
        if profiled:
            _, prof = profiler_summary.profile_call(lambda: job.run(state, 0), "scene.sfm",
                                                    "cuda")
            return prof["window_s"], prof
        t0 = time.perf_counter()
        job.run(state, 0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, None

    out = {"device": torch.cuda.get_device_name(0), "seed": args.seed, "modes": {}}
    for mode, profiled in (("profiler_off", False), ("profiler_on", True)):
        walls = {"stubbed": [], "spans": []}
        gaps = {}
        for _ in range(args.repeats):
            for variant in ("stubbed", "spans", "spans", "stubbed"):
                ctx = stubbed_spans() if variant == "stubbed" else contextlib.nullcontext()
                with ctx:
                    wall, prof = scene(profiled)
                walls[variant].append(wall)
                if prof is not None and prof["breakdown"]:
                    gaps[variant] = prof["breakdown"]["idle_gaps"]
        med = {k: statistics.median(v) for k, v in walls.items()}
        root = [r for r in profiling.finished() if r["name"] == "sfm.reconstruct"][-1]
        out["modes"][mode] = {"walls_s": walls, "median_s": med,
                              "spans_over_stubbed": med["spans"] / med["stubbed"] - 1.0,
                              "idle_gaps": gaps,
                              "scene": {k: root[k] for k in ("seconds", "self_seconds", "count",
                                                             "counters")}}
        print(f"[span_overhead] {mode}: {json.dumps(out['modes'][mode]['median_s'])}",
              file=sys.stderr, flush=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
