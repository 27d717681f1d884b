"""The readings that a cell's limits are set from: the compared numbers of
the program as the configuration states it, of the control (`bf16`: the
reference's own answer in bfloat16 in the program's place, the job's
`control`), of the program in TF32 (controls.tf32) and of each planted
fault (controls.FAULTS), at the cell's own size, one scene a seed and
capture, all in one process.

    python benchmark/readings.py --workload dtu49.sfm --seeds 1 2 3 \
        --variants clean bf16 half_batch [--captures 2] [--out readings.jsonl]

Prints one JSON line a seed, capture and variant: the numbers, the
scene's wall time and the seconds the reference took. Not run by the
benchmark's runs.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def variant_context(job: str, name: str):
    from benchmark import controls

    if name == "clean":
        return contextlib.nullcontext()
    if name in controls.CONTROLS:
        return controls.CONTROLS[name]()
    return controls.FAULTS[job][name]()


def readings(workload: str, seeds, variants, device="cuda", files=None, captures=1):
    """Yield one record a seed, capture and variant: the seed's first
    `captures` captures of the pool, as a run renders them."""
    import torch

    from benchmark import run

    files = files or run.cell_files(workload)
    traffic = dict(files["traffic"], pool=captures)
    job_name = traffic["job"]
    job = run.load_module(run.BENCH / "jobs" / f"{job_name}.py", f"job_{job_name}")
    for seed in seeds:
        state = job.setup(files["config"], traffic, seed, device)
        for k in range(captures):
            for name in variants:
                head = {"workload": workload, "seed": seed, "capture": k, "variant": name}
                t0 = time.perf_counter()
                try:
                    if name == "bf16":
                        out = job.control(state, k, torch.bfloat16)
                    else:
                        with variant_context(job_name, name):
                            out = job.run(state, k)
                    if torch.device(device).type == "cuda":
                        torch.cuda.synchronize()
                except Exception as e:          # a crash is a failed run: no number
                    yield dict(head, failed=f"{type(e).__name__}: {e}"[:300])
                    continue
                wall = time.perf_counter() - t0
                t1 = time.perf_counter()
                nums = job.check(state, out)
                yield dict(head, scene_s=wall, check_s=time.perf_counter() - t1, numbers=nums)
                del out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["clean", "bf16"])
    ap.add_argument("--captures", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sink = open(args.out, "a") if args.out else None
    for rec in readings(args.workload, args.seeds, args.variants, captures=args.captures):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
