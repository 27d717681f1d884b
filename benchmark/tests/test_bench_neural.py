"""The neural SfM cell's readers, its operation count, its planted faults
and a tiny run of the cell on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import lightglue_ops, neural_faults, run
from benchmark.jobs import sfm_neural
from recon3d_tpu_torch.runtime.profiling import count, span

ROOT = Path(__file__).resolve().parents[2]
CELL = "dtu49_superpoint_lightglue.sfm"
NET = {"N": 2048, "D": 256, "L": 9}
STATS = [{"extract_time": 1.0, "match_time": 8.0, "init_time": 0.5, "incremental_time": 2.5,
          "final_ba_time": 1.0, "network": NET},
         {"extract_time": 2.0, "match_time": 9.0, "init_time": 0.5, "incremental_time": 3.5,
          "final_ba_time": 1.0, "network": NET}]


def _reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py", f"m_{name}")


def _scenes(match_s, pairs, nn_kept):
    """Finished sfm.reconstruct roots as the window's scenes and one more,
    the profiled scene, each with a neural.match span and the pair counts."""
    for s, n, k in zip(match_s + [0.0], pairs + [1], nn_kept + [0]):
        with span("sfm.reconstruct"):
            with span("neural.match") as m:
                count("neural.lightglue_pairs", n)
                count("neural.nn_kept_pairs", k)
            m.end_ns = m.start_ns + int(s * 1e9)     # the root aggregates when it ends


def test_the_operation_count_is_chip_smokes():
    chip_smoke = pytest.importorskip("chip_smoke")
    for N, D, L in [(2048, 256, 9), (256, 256, 9), (512, 128, 2)]:
        assert lightglue_ops.lightglue_ops(N, D, L) == chip_smoke.lightglue_flops(N, D, L)
    assert lightglue_ops.lightglue_ops(2048, 256, 9) == pytest.approx(0.2545e12, rel=1e-3)


def test_the_sfm_stage_readers_read_the_neural_job():
    """The SfM stage readers the cell shares with dtu49.sfm take its
    stats as they are."""
    rec = {"job": "sfm_neural", "stats": STATS}
    assert _reader("sfm.extract_s").read(rec) == pytest.approx(1.5)
    assert _reader("sfm.match_s").read(rec) == pytest.approx(8.5)
    assert _reader("sfm.register_s").read(rec) == pytest.approx(3.5)
    assert _reader("sfm.final_ba_s").read(rec) == pytest.approx(1.0)


def test_the_span_and_counter_readers():
    _scenes([6.0, 8.0], [427, 427], [423, 425])
    rec = {"job": "sfm_neural", "stats": STATS}
    assert _reader("neural.match_s").read(rec) == pytest.approx(7.0, rel=1e-6)
    want = 100 * 2 * 427 * lightglue_ops.lightglue_ops(2048, 256, 9) / (14.0 * 67e12)
    assert _reader("neural.match_mfu").read(rec) == pytest.approx(want, rel=1e-6)
    assert _reader("neural.lightglue_won_share").read(rec) == pytest.approx(100 * 6 / 854)
    for name in ("neural.match_s", "neural.match_mfu", "neural.lightglue_won_share"):
        assert _reader(name).read(dict(rec, job="sfm")) is None


def test_the_match_agreement_counts_the_rows_either_side_matches():
    ref = torch.tensor([3, -1, 5, 7, -1, 2])
    assert sfm_neural._agreement(ref.clone(), ref) == (4, 4)
    assert sfm_neural._agreement(torch.tensor([3, 1, -1, 7, -1, 0]), ref) == (2, 5)
    assert sfm_neural._agreement(torch.full((6,), -1), torch.full((6,), -1)) == (0, 0)


def test_the_match_faults_alter_lightglues_matches():
    """Under each match-extraction fault the matcher's extraction gives
    other matches than the plain one on the same log-assignment."""
    from recon3d_tpu_torch.neural import matcher

    # a diagonal of assignment probabilities 0.5 and 0.05 over 1e-4 elsewhere
    p = torch.full((64, 64), 1e-4) + torch.diag(torch.tensor([0.5, 0.05]).repeat(32))
    la, v = torch.log(p), torch.ones(64, dtype=torch.bool)
    clean = matcher.extract_matches(la, v, v, threshold=0.01)
    assert torch.equal(clean.idx2, torch.arange(64))
    for fault in (neural_faults.lightglue_matches_dropped, neural_faults.lightglue_threshold_raised):
        with fault():
            bad = matcher.extract_matches(la, v, v, threshold=0.01)
        a, b = sfm_neural._agreement(bad.idx2, clean.idx2)
        assert a < b
    assert matcher.extract_matches(la, v, v, threshold=0.01).idx2.equal(clean.idx2)


def test_faults_are_known_under_the_job():
    from benchmark import controls

    assert {"lightglue_layer_skipped", "superpoint_descriptors_shifted",
            "superpoint_scores_scaled", "lightglue_matches_dropped",
            "lightglue_threshold_raised", "state_unchanged"} <= set(controls.FAULTS["sfm_neural"])
    assert neural_faults.lightglue_layer_skipped is \
        controls.FAULTS["sfm_neural"]["lightglue_layer_skipped"]


def test_a_tiny_run_of_the_cell_loads_no_jax():
    """6 views of 192x256 at 256 slots on the CPU, traced, in a process of
    its own: every network number within its limit, the span, counter and
    stage readers found, and neither JAX nor the JAX package loaded."""
    code = (
        "import copy, json, time\n"
        "import torch\n"
        "from benchmark import run\n"
        "torch.set_num_threads(2)\n"
        f"f = copy.deepcopy(run.cell_files({CELL!r}))\n"
        "f['config'].update({'views': 6, 'height': 192, 'width': 256})\n"
        "f['config']['neural']['max_keypoints'] = 256\n"
        f"res = run.run_cell({CELL!r}, 2**31 + 11, 0.1, True, 'cpu', f, "
        "t_start=time.perf_counter())\n"
        "print(json.dumps({'leaked': run.loaded_forbidden(), 'res': res}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    res = got["res"]
    assert got["leaked"] == [] and res["failed"] == 0
    for name in ("sp_prob_err_max", "sp_desc_err_max", "lg_log_assign_err_max"):
        assert res["checks"][name]["value"] <= res["checks"][name]["limit"]
    for name in ("sp_kp_shared", "lg_match_agree"):
        assert res["checks"][name]["value"] >= res["checks"][name]["limit"]
    assert {"sfm.extract_s", "sfm.match_s", "sfm.register_s", "sfm.final_ba_s",
            "neural.match_s", "neural.match_mfu", "neural.lightglue_won_share"} \
        <= set(res["metrics"])
    assert 0 < res["metrics"]["neural.match_mfu"]["value"] < 100
