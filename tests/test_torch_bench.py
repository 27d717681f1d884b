"""The port's benchmark scripts at tiny sizes on the CPU: bench_cuda.py
(--device cpu, 2 views, 1 window of 1 repetition, patch 5, 1 iteration)
and scripts/bench_stages_torch.py (--quick --device cpu with its stages
that take seconds on a CPU: match, patchmatch at bench_cuda.py's tiny
size, bundle and tsdf), run as a user runs them; the shape of every JSON
line each prints; and both refusing to run without a GPU unless asked for
the CPU."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "windows_s", "device", "k1_launches",
              "k1_plain", "k1_by_shape", "k1_by_variant", "views", "map", "reps", "iterations", "samples",
              "patch"}


def _run(args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=timeout)


def _json_lines(stdout: str):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def test_bench_cuda_on_the_cpu():
    r = _run(["bench_cuda.py", "--device", "cpu", "--views", "2", "--windows", "1",
              "--reps", "1", "--patch", "5", "--iterations", "1"])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = _json_lines(r.stdout)
    assert len(lines) == 1 and r.stdout.strip().splitlines()[-1].startswith("{")
    row = lines[0]
    assert set(row) == BENCH_KEYS
    assert row["metric"] == "patchmatch_mvs_depthmap_throughput"
    assert row["unit"] == "MP/s/cpu" and row["device"] == "cpu"
    assert math.isfinite(row["value"]) and row["value"] > 0
    assert row["vs_baseline"] == pytest.approx(row["value"] / 0.0167)
    assert len(row["windows_s"]) == 1 and row["windows_s"][0] > 0
    assert row["value"] == pytest.approx(2 * 120 * 160 / 1e6 / row["windows_s"][0])
    # the CPU runs K1's plain version: 5 calls a map (1 iteration), no launch
    assert row["k1_launches"] == 0 and row["k1_plain"] == 5
    assert row["k1_by_shape"] == {} and row["k1_by_variant"] == {}
    assert (row["views"], row["map"], row["reps"], row["patch"]) == (2, [120, 160], 1, 5)


def test_bench_stages_torch_quick_on_the_cpu():
    r = _run(["scripts/bench_stages_torch.py", "--quick", "--device", "cpu",
              "--skip", "sift", "sweep"])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = _json_lines(r.stdout)
    assert [row["metric"] for row in lines] == ["match_verify", "patchmatch_mvs",
                                               "bundle_adjust_full", "tsdf_integration"]
    for row in lines:
        assert {"metric", "value", "unit", "device", "k1_launches", "k1_plain",
                "k1_by_shape", "k1_by_variant"} <= set(row)
        assert row["device"] == "cpu"
        assert math.isfinite(row["value"]) and row["value"] > 0
        # the CPU runs K1's plain version
        assert row["k1_launches"] == 0 and row["k1_by_shape"] == row["k1_by_variant"] == {}
    match, patchmatch, bundle, tsdf = lines
    assert match["k1_plain"] == bundle["k1_plain"] == 0
    # bench_cuda.py's tiny CPU size: a warm-up and 1 repetition of 2 maps, 5
    # calls each; TSDF: a warm-up and 3 calls of 8 views
    assert patchmatch["unit"] == "MP/s/cpu" and patchmatch["k1_plain"] == 10
    assert (patchmatch["views"], patchmatch["reps"], len(patchmatch["windows_s"])) == (2, 1, 1)
    assert patchmatch["value"] == pytest.approx(2 * 120 * 160 / 1e6
                                                / patchmatch["windows_s"][0])
    assert tsdf["k1_plain"] == 32
    assert match["unit"] == "pairs/s" and set(match["segments_s"])
    assert all(len(v) == 3 for v in match["segments_s"].values())
    assert bundle["unit"] == "ms/LM-iter (12cam/1200pt)" and bundle["iterations"] >= 1
    assert tsdf["unit"] == "Mvoxel-obs/s (res 64)"
    assert all(len(v) == 3 for v in tsdf["segments_s"].values())


@pytest.mark.parametrize("script", ["bench_cuda.py", "scripts/bench_stages_torch.py"])
def test_without_a_gpu_the_scripts_refuse(script):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the scripts run on it")
    r = _run([script], timeout=120)
    assert r.returncode != 0
    assert "no CUDA device visible" in r.stderr
    assert not _json_lines(r.stdout)
