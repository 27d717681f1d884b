"""Small versions of the cells for the CPU tests: the cell's own files
with the scene cut to a few views. SIZES are where the unbroken program
passes the cell's limits (test_bench_faults.py); SMALL is for tests that
need only a run."""

import copy
import time

from benchmark import run

SIZES = {"mvs": {"views": 8, "height": 1200, "width": 1600},
         "sfm": {"views": 12, "height": 480, "width": 640}}
SMALL = {"mvs": {"views": 6, "height": 192, "width": 256},
         "sfm": {"views": 6, "height": 192, "width": 256}}


def files(workload: str, sizes=SIZES) -> dict:
    f = copy.deepcopy(run.cell_files(workload))
    f["config"].update(sizes[f["traffic"]["job"]])
    if "sparse_points" in f["traffic"]:
        f["traffic"]["sparse_points"] = 500
    return f


def run_tiny(workload: str, seed: int = 2**31 + 11, trace: bool = False, sizes=SIZES) -> dict:
    import torch

    torch.set_num_threads(2)
    return run.run_cell(workload, seed, 0.1, trace, "cpu", files(workload, sizes),
                        t_start=time.perf_counter())
