"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (benchmark/workloads/<cell>.json) names a configuration
(configs/<config>.json: the scene's sizes and the settings the program runs
with) and a traffic mix (traffic/<mix>.json: the job and its parameters;
the job's code is jobs/<job>.py). The window is a closed loop with one
client, a user who reconstructs one capture after another: scenes run
whole, back to back, each on a fresh pipeline object, from a pool of
captures rendered on the card from the seed; the window closes at the end
of the turn through the pool that crosses `--seconds`, so every capture
runs as often as the others. Set-up (imports, the kernels' build or load,
the render, one warm-up scene at the cell's shapes) is `setup_s`. Each
scene's wall time is in the result line too (`scene_walls_s`, scene k on
capture k mod the pool). After the window, a sample of the scenes drawn
from the seed is checked against the plain reference
(benchmark/reference/) and the result is `correct` only if every number
compared is within its limit.

With --trace 1 the metrics are the cell's per-layer metrics: after the
window one more scene runs under torch.profiler, and each per-layer
metric's reader (metrics/<metric>.py) takes its number from the window's
stage records and that scene's trace.

The last line of standard output is one JSON object; without a CUDA card
(or with fewer than the cell asks for), or if jax, jaxlib, flax or the JAX
package recon3d_tpu is loaded once the window has closed, the run prints
no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "recon3d_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(workload: str) -> dict:
    """The cell's own file, its configuration and its traffic mix."""
    cell = load_json(BENCH / "workloads" / f"{workload}.json")
    return {"cell": cell,
            "config": load_json(BENCH / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json")}


def loaded_forbidden() -> list:
    """Top-level names of sys.modules, compared whole, that the port must
    never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _worst(values, limit: dict) -> float:
    return max(values) if "max" in limit else min(values)


def _within(value: float, limit: dict) -> bool:
    if "max" in limit:
        return value <= limit["max"]
    return value >= limit["min"]


class Sample:
    """A uniform sample of at most `size` of the window's scene outputs,
    drawn from the seed as they come (reservoir sampling), so the outputs
    held on the device stay bounded however long the window runs."""

    def __init__(self, size: int, seed: int):
        import numpy as np

        self.size, self.seen, self.kept = size, 0, []
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))

    def offer(self, out) -> None:
        if len(self.kept) < self.size:
            self.kept.append(out)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = out
        self.seen += 1


def correctness(job, state, sample: list, limits: dict) -> dict:
    """The compared numbers of the sampled scenes, each the worst over the
    sample: {name: {value, limit, ok}}."""
    per_scene = [job.check(state, out) for out in sample]
    checks = {}
    for name, limit in limits["numbers"].items():
        vals = [p[name] for p in per_scene]
        value = _worst(vals, limit) if vals else float("nan")
        checks[name] = {"value": value, "limit": limit.get("max", limit.get("min")),
                        "ok": bool(vals) and _within(value, limit)}
    return checks


def per_layer(rec: dict, workload: str, bench: dict) -> dict:
    """The per-layer metrics of this cell that their readers find."""
    metrics = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             files: dict = None, t_start: float = None) -> dict:
    """One run of a cell on `device`; the result line's object."""
    import torch

    t_start = T_START if t_start is None else t_start
    files = files or cell_files(workload)
    cell, config, traffic = files["cell"], files["config"], files["traffic"]
    bench = load_json(ROOT / "BENCHMARK.json")
    job = load_module(BENCH / "jobs" / f"{traffic['job']}.py", f"job_{traffic['job']}")
    cuda = torch.device(device).type == "cuda"

    with contextlib.redirect_stdout(sys.stderr):
        state = job.setup(config, traffic, seed, device)
        job.run(state, 0)                       # warm-up: the cell's own shapes
        _sync(device)
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        sample = Sample(cell["limits"]["scenes"], seed)
        cycle = traffic.get("pool", 1)          # whole turns of the pool: each capture as often
        stats, walls, failed = [], [], 0
        gc.collect()
        gc.freeze()                             # set-up's objects: never traversed again
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            gc.collect()                        # every scene starts from the same heap
            try:
                out = job.run(state, len(walls))
                stats.append(out["stats"])
                sample.offer(out)
                del out
            except Exception:                   # a failed scene counts; the window goes on
                traceback.print_exc()
                failed += 1
            _sync(device)
            walls.append(time.perf_counter() - ts)
            if time.perf_counter() - t0 >= seconds and len(walls) % cycle == 0:
                break
        window_s = time.perf_counter() - t0
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

        result = {"correct": None, "attempted": len(walls), "failed": failed, "metrics": {},
                  "device": {"platform": "gpu" if cuda else "cpu",
                             "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                             "count": cell["chips"], "memory_peak_bytes": memory_peak}}
        e2e = {m["name"]: m for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
        if not trace:
            result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
            for name in e2e:
                if name != "setup_s":
                    result["metrics"][name] = {"value": window_s / len(walls),
                                               "unit": e2e[name]["unit"]}
        else:
            from benchmark import profiler_summary
            from recon3d_tpu_torch.kernels import warp

            last = len(walls) - 1               # the last scene's capture once more
            by_stage = {}
            with warp.record_launches(by_stage, "scene"):
                prof_out, prof = profiler_summary.profile_call(
                    lambda: job.run(state, last), f"scene.{traffic['job']}", device)
            del prof_out
            rec = {"job": traffic["job"], "stats": stats,
                   "unprofiled_wall_s": walls[last], "profile": prof,
                   "k1_by_shape": by_stage["scene"]["kernel_by_shape"]}
            result["metrics"] = per_layer(rec, workload, bench)
            if prof["busy_s"] is not None:
                result["device"]["busy_s"] = prof["busy_s"]
                result["device"]["window_s"] = prof["window_s"]
                result["breakdown"] = prof["breakdown"]

        _sync(device)
        if cuda:
            torch.cuda.empty_cache()
        checks = correctness(job, state, sample.kept, cell["limits"])
    result["correct"] = failed == 0 and all(c["ok"] for c in checks.values())
    result["scene_walls_s"] = walls
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHES.items():             # fixed paths inside the checkout
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    files = cell_files(args.workload)
    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import recon3d_tpu_torch

    if ROOT not in Path(recon3d_tpu_torch.__file__).resolve().parents:
        print(f"[bench] the port was imported from {recon3d_tpu_torch.__file__}, "
              f"outside the checkout {ROOT}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", files)
    leaked = loaded_forbidden()
    if leaked:
        print(f"[bench] the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)                     # the checkout, not benchmark/, on the path
    sys.exit(main())
