"""Each per-layer metric's reader on a recorded stage record, the K1 byte
count against chip_smoke.py's, and BENCHMARK.json against the files the
harness finds by name."""

import json
from pathlib import Path

import pytest

from benchmark import roofline, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

MVS_REC = {
    "job": "mvs",
    "stats": [{"prep": 0.1, "depth": 1.5, "fuse": 0.2, "filter": 0.1, "total": 1.9},
              {"prep": 0.1, "depth": 1.7, "fuse": 0.3, "filter": 0.2, "total": 2.3}],
    "unprofiled_wall_s": 2.0,
    "profile": {"busy_s": 0.5, "device_ops": 73000, "window_s": 9.0,
                "ops": {"void tent_warp_plane<4>(Args)": [0.02, 100],
                        "elementwise_kernel": [0.3, 50000]}},
    "k1_by_shape": {"16x120x160/16x172800": 10},
}
SFM_REC = {
    "job": "sfm",
    "stats": [{"extract_time": 1.0, "match_time": 2.0, "init_time": 0.5,
               "incremental_time": 3.0, "final_ba_time": 1.0},
              {"extract_time": 3.0, "match_time": 2.0, "init_time": 0.5,
               "incremental_time": 5.0, "final_ba_time": 2.0}],
    "unprofiled_wall_s": 8.0,
    "profile": {"busy_s": 2.0, "device_ops": 200000, "window_s": 30.0, "ops": {}},
    "k1_by_shape": {},
}
EXPECT = {
    "mvs.depth_s": (1.6, None), "mvs.fuse_s": (0.4, None), "mvs.device_ops": (73000, None),
    "device.idle_share.mvs": (75.0, None),
    "k1_roofline": (100.0 * 10 * 37_171_200 / 3.35e12 / 0.02, None),
    "sfm.extract_s": (None, 2.0), "sfm.match_s": (None, 2.0), "sfm.register_s": (None, 4.5),
    "sfm.final_ba_s": (None, 1.5), "sfm.device_ops": (None, 200000),
    "device.idle_share.sfm": (None, 75.0),
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    reader = run.load_module(run.BENCH / "metrics" / f"{name}.py", f"m_{name}")
    for rec, want in zip((MVS_REC, SFM_REC), EXPECT[name]):
        got = reader.read(rec)
        assert got == pytest.approx(want) if want is not None else got is None


def test_readers_find_nothing_without_a_trace():
    bare = dict(MVS_REC, profile={"busy_s": None, "device_ops": 0, "window_s": 1.0, "ops": {}},
                stats=[], k1_by_shape={})
    for name in EXPECT:
        reader = run.load_module(run.BENCH / "metrics" / f"{name}.py", f"m0_{name}")
        assert reader.read(bare) is None


@pytest.mark.parametrize("key,bound_ms", [
    ("16x120x160/16x172800", 0.0111),     # PatchMatch fine (PERF.md's K1 table)
    ("16x120x160/16x96000", 0.0063),      # refinement
    ("16x30x40/16x15600", 0.0010),        # coarse
    ("48x120x160/48x172800", 0.0333),     # bench_cuda.py
])
def test_k1_bound_whole_planes(key, bound_ms):
    assert 1e3 * roofline.k1_bound_s(*roofline.k1_shape(key)) == pytest.approx(bound_ms, abs=6e-5)


def test_k1_bytes_frozen_copy_of_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    for N, H, W, Nc, M in [(16, 120, 160, 16, 172800), (2, 120, 160, 1, 7077888),
                           (16, 300, 400, 16, 9 * 300 * 400)]:
        assert roofline.k1_bytes(N, H, W, Nc, M) == chip_smoke.k1_bytes(N, H, W, Nc, M)
        assert roofline.k1_bound_s(N, H, W, Nc, M) == pytest.approx(
            chip_smoke.k1_bound(N, H, W, Nc, M, None)["bound_ms"] / 1e3)


def test_k1_texels_frozen_copy():
    import torch

    chip_smoke = pytest.importorskip("chip_smoke")
    g = torch.Generator().manual_seed(0)
    coords = torch.rand((3, 500, 2), generator=g) * torch.tensor([45.0, 33.0]) - 2.0
    assert roofline.k1_texels(3, 30, 40, coords) == chip_smoke.k1_texels(3, 30, 40, coords)


def test_benchmark_json_matches_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for w in BENCH["workloads"]:
        cell = json.loads((run.BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (run.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert any(c["name"] == w["config"] for c in BENCH["configs"])
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (run.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in moves.get("workloads", [w])
    for w in BENCH["workloads"]:
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
        assert sum(w["name"] in e.get("workloads", [w["name"]])
                   for e in BENCH["end_to_end"]) >= 2
