"""The harness never loads JAX or the JAX package (top-level names compared
whole), refuses to run without a card, and prints its result line with the
contract's keys."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str, cwd=ROOT, timeout=900) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_forbidden_names_are_compared_whole():
    p = _python(
        "import sys\n"
        "from benchmark import run\n"
        "import recon3d_tpu_torch.dense.patchmatch\n"
        "assert run.loaded_forbidden() == [], run.loaded_forbidden()\n"
        "sys.modules['recon3d_tpu.ops'] = object()\n"
        "sys.modules['jaxlib_extra'] = object()\n"
        "assert run.loaded_forbidden() == ['recon3d_tpu'], run.loaded_forbidden()\n")
    assert p.returncode == 0, p.stderr


@pytest.mark.parametrize("workload", ["dtu49.mvs", "dtu49.sfm"])
def test_a_run_loads_no_jax(workload):
    p = _python(
        "import json\n"
        "from benchmark import run\n"
        "from benchmark.tests._tiny import SMALL, run_tiny\n"
        f"res = run_tiny({workload!r}, trace=True, sizes=SMALL)\n"
        "print(json.dumps({'leaked': run.loaded_forbidden(), 'keys': list(res)}))\n")
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert got["keys"][:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert got["keys"][-1] == "checks"


def test_no_card_no_result(tmp_path):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dtu49.mvs",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if "CUDA device" not in p.stderr:
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the port is missing, and the run fails before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _python("import sys\n"
                "sys.path.insert(0, '.')\n"
                "from benchmark import run\n"
                "run.run_cell('dtu49.mvs', 1, 0.1, False, 'cpu')\n", cwd=tmp_path)
    assert p.returncode != 0
    assert "recon3d_tpu_torch" in p.stderr
