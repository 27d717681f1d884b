"""The readers of the port's spans and counters (sfm.ba_s, sfm.ba_lm_steps,
sfm.host_syncs, sfm.pull_wait_s): on a recorded span record, on a program
without one, and on a traced run of the SfM cell at a small size on the
CPU, where their window is the window's scenes alone."""

import pytest

from benchmark import run
from benchmark.tests._tiny import SMALL, run_tiny
from recon3d_tpu_torch.runtime import profiling

SPAN_READERS = {"sfm.ba_s": ("seconds", "ba.full"),
                "sfm.ba_lm_steps": ("counters", "ba.lm_steps"),
                "sfm.host_syncs": ("counters", "host.reads"),
                "sfm.pull_wait_s": ("seconds", "host.pull")}


def _reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py", f"spans_{name}")


def _root(seq, ok=True, name="sfm.reconstruct", v=1.0):
    return {"seq": seq, "name": name, "ok": ok, "self_seconds": {}, "count": {},
            "seconds": {"ba.full": v, "host.pull": v / 10},
            "counters": {"ba.lm_steps": int(10 * v), "host.reads": int(100 * v)}}


RECORD = [_root(1, v=9.0),                       # the warm-up
          _root(2, name="io.image_set"), _root(3, v=1.0),
          _root(4, name="io.image_set"), _root(5, ok=False, v=7.0),   # a failed scene
          _root(6, name="io.image_set"), _root(7, v=3.0),
          _root(8, name="io.image_set"), _root(9, v=5.0)]             # the profiled scene
SFM_REC = {"job": "sfm", "stats": [{}, {}], "unprofiled_wall_s": 8.0, "profile": None,
           "k1_by_shape": {}}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_reader_takes_the_windows_ok_scenes(name, monkeypatch):
    monkeypatch.setattr(profiling, "finished", lambda: RECORD)
    kind, key = SPAN_READERS[name]
    want = (RECORD[2][kind][key] + RECORD[6][kind][key]) / 2
    assert _reader(name).read(SFM_REC) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_reader_finds_nothing_without_the_record(name, monkeypatch):
    reader = _reader(name)
    monkeypatch.setattr(profiling, "finished", lambda: RECORD[:3])   # fewer roots than scenes
    assert reader.read(SFM_REC) is None
    monkeypatch.setattr(profiling, "finished", lambda: RECORD)
    assert reader.read(dict(SFM_REC, stats=[])) is None
    assert reader.read(dict(SFM_REC, job="mvs")) is None
    monkeypatch.delattr(profiling, "finished")          # a program without spans
    assert reader.read(SFM_REC) is None


@pytest.fixture(scope="module")
def two_runs():
    out = []
    for _ in range(2):
        before = max((r["seq"] for r in profiling.finished()), default=0)
        res = run_tiny("dtu49.sfm", trace=True, sizes=SMALL)
        roots = [r for r in profiling.finished()
                 if r["seq"] > before and r["name"] == "sfm.reconstruct"]
        out.append((res, roots))
    return out


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_traced_tiny_run_reports_the_window(two_runs, name):
    kind, key = SPAN_READERS[name]
    for res, roots in two_runs:
        assert res["failed"] == 0
        # warm-up, the window's scenes, the profiled scene
        assert len(roots) == res["attempted"] + 2 and all(r["ok"] for r in roots)
        window = roots[1:-1]
        want = sum(r[kind].get(key, 0) for r in window) / len(window)
        assert res["metrics"][name]["value"] == pytest.approx(want)
        assert res["metrics"][name]["unit"] == next(
            m["unit"] for m in run.load_json(run.ROOT / "BENCHMARK.json")["per_layer"]
            if m["name"] == name)


@pytest.mark.parametrize("name", ["sfm.ba_lm_steps", "sfm.host_syncs"])
def test_counts_repeat_on_the_same_seed(two_runs, name):
    (a, _), (b, _) = two_runs
    assert a["metrics"][name]["value"] == b["metrics"][name]["value"] > 0
