"""The port's spans and counters (recon3d_tpu_torch/runtime/profiling.py):
nesting, parents and trace ids, self time, counters, the bound of the
finished-trace record, spans and reads raised through, the clock against
torch.profiler's events and the kind of range a span leaves in a trace;
and, on a small SfM scene on the CPU, the pipeline's timing keys as views
of its spans."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.camera import Camera
from recon3d_tpu_torch.config import ReconstructionConfig
from recon3d_tpu_torch.io.dataset import image_set_from_arrays
from recon3d_tpu_torch.runtime import profiling
from recon3d_tpu_torch.runtime.profiling import count, current, finished, pull, span
from recon3d_tpu_torch.sfm.pipeline import SfMPipeline
from tests.render import render_views

torch.set_num_threads(2)

SLACK_NS = 50_000


def _last(name):
    return [e for e in finished() if e["name"] == name][-1]


def test_nested_spans_share_the_root_trace_and_know_their_parent():
    with span("t.root") as root:
        with span("t.child") as child:
            with span("t.leaf") as leaf:
                assert current() is leaf
            assert current() is child
        with span("t.child") as second:
            pass
    assert current() is None
    assert root.parent is None and child.parent is root and leaf.parent is child
    assert second.parent is root
    assert root.trace is child.trace is leaf.trace is second.trace
    assert [s.name for s in root.trace.spans] == ["t.leaf", "t.child", "t.child", "t.root"]
    assert root.start_ns <= child.start_ns <= leaf.start_ns <= leaf.end_ns <= child.end_ns
    assert child.end_ns <= second.start_ns <= second.end_ns <= root.end_ns
    with span("t.other") as other:
        pass
    assert other.trace is not root.trace and other.trace.id > root.trace.id


def test_self_seconds_leave_out_the_children():
    with span("t.self") as root:
        time.sleep(0.02)
        with span("t.inner"):
            time.sleep(0.03)
    entry = _last("t.self")
    assert entry["seq"] == root.trace.id and entry["ok"]
    assert entry["seconds"]["t.self"] == pytest.approx(root.seconds)
    assert entry["self_seconds"]["t.self"] == pytest.approx(
        root.seconds - entry["seconds"]["t.inner"])
    assert entry["self_seconds"]["t.inner"] == entry["seconds"]["t.inner"] >= 0.03
    assert entry["count"] == {"t.self": 1, "t.inner": 1}
    assert root.within("t.inner") == pytest.approx(entry["seconds"]["t.inner"])
    assert root.within("t.self") == 0.0


def test_within_counts_only_descendants():
    with span("t.a") as a:
        with span("t.x"):
            pass
    with span("t.b") as b:
        with span("t.mid") as mid:
            with span("t.x") as x1:
                pass
        with span("t.x") as x2:
            pass
    assert a.within("t.x") > 0.0
    assert b.within("t.x") == pytest.approx(x1.seconds + x2.seconds)
    assert mid.within("t.x") == pytest.approx(x1.seconds)


def test_counters_belong_to_the_current_trace():
    count("t.orphan")                      # no span open: dropped
    with span("t.counted"):
        count("t.n")
        with span("t.deeper"):
            count("t.n", 4)
            count("t.bytes", 1024)
    entry = _last("t.counted")
    assert entry["counters"] == {"t.n": 5, "t.bytes": 1024}
    assert all("t.orphan" not in e["counters"] for e in finished())


def test_pull_reads_under_a_span_and_counts():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with span("t.pulls") as root:
        a = pull(x)
        b = pull(x[:1])
    np.testing.assert_array_equal(a.numpy(), x.numpy())
    assert b.shape == (1, 4) and b.device.type == "cpu"
    entry = _last("t.pulls")
    assert entry["counters"] == {"host.reads": 2, "host.read_bytes": 48 + 16}
    assert entry["count"]["host.pull"] == 2
    assert [s.parent for s in root.trace.spans[:2]] == [root, root]


def test_finished_is_bounded_and_keeps_the_newest_span_lists():
    for k in range(profiling.FINISHED_KEPT + 5):
        with span(f"t.bound{k}"):
            pass
    got = finished()
    assert len(got) == profiling.FINISHED_KEPT
    names = [e["name"] for e in got]
    assert names[-1] == f"t.bound{profiling.FINISHED_KEPT + 4}"
    assert names[0] == "t.bound5"
    seqs = [e["seq"] for e in got]
    assert seqs == sorted(seqs)
    with_spans = [e for e in got if "spans" in e]
    assert with_spans == got[-profiling.SPANS_KEPT:]
    last = with_spans[-1]["spans"]
    assert [(s["name"], s["parent"]) for s in last] == [(names[-1], None)]
    assert last[0]["start_ns"] <= last[0]["end_ns"]


def test_span_list_records_parents_by_index():
    with span("t.tree"):
        with span("t.branch"):
            with span("t.twig"):
                pass
    spans = _last("t.tree")["spans"]
    assert [s["name"] for s in spans] == ["t.twig", "t.branch", "t.tree"]
    assert [s["parent"] for s in spans] == [1, 2, None]


def test_a_span_raised_through_is_closed_and_its_root_failed():
    with pytest.raises(ValueError):
        with span("t.fails") as root:
            with span("t.raises") as inner:
                raise ValueError("boom")
    assert current() is None
    assert inner.end_ns is not None and root.end_ns is not None
    entry = _last("t.fails")
    assert entry["ok"] is False and entry["count"] == {"t.raises": 1, "t.fails": 1}


class _Unreadable(torch.Tensor):
    def cpu(self, *args, **kwargs):
        raise RuntimeError("the read failed")


def test_a_read_raised_through_is_closed():
    with span("t.badread") as root:
        with pytest.raises(RuntimeError, match="the read failed"):
            pull(torch.ones(2).as_subclass(_Unreadable))
        assert current() is root
    entry = _last("t.badread")
    assert entry["ok"] and entry["count"]["host.pull"] == 1
    assert "host.reads" not in entry["counters"]


def test_pull_passes_host_values_through():
    with span("t.hostvalue"):
        assert pull(3) == 3 and pull(None) is None
    assert "host.pull" not in _last("t.hostvalue")["count"]


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer()
    with span("t.timer") as root:
        with timer.stage("a"):
            time.sleep(0.01)
        with pytest.raises(RuntimeError):
            with timer.stage("b"):
                raise RuntimeError
        with timer.stage("a"):
            pass
    assert [n for n, _ in timer.stages] == ["a", "b", "a"]
    assert timer.as_dict()["a"] == pytest.approx(root.within("a"))
    assert timer.as_dict()["b"] == pytest.approx(root.within("b"))


def test_profiled_ops_lie_inside_their_span_on_the_profilers_clock():
    """An aten op that the profiler records inside a span starts and ends
    within the span's [start, end] on start_ns(), 50 us of slack each end."""
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(96, 96), torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.align") as s:
            c = a @ b
            d = torch.relu(c)
    del d
    events = list(prof.profiler.kineto_results.events())
    ops = [e for e in events if e.name() in ("aten::mm", "aten::relu")]
    assert {e.name() for e in ops} == {"aten::mm", "aten::relu"}
    for e in ops:
        assert s.start_ns - SLACK_NS <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns + SLACK_NS
    assert len([e for e in events if e.name() == "t.align"]) == 1


def test_spans_are_cpu_ops_and_never_user_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.kind"):
            with span("t.kind.inner"):
                torch.ones(8).sum()
            pull(torch.ones(3))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("name") in ("t.kind", "t.kind.inner", "host.pull")]
    assert sorted(e["name"] for e in mine) == ["host.pull", "t.kind", "t.kind.inner"]
    assert {e.get("cat") for e in mine} == {"cpu_op"}
    assert not any(e.get("cat") in ("user_annotation", "gpu_user_annotation") for e in events)


def test_no_profiler_range_without_a_session(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "_RecordFunctionFast", lambda name: entered.append(name))
    with span("t.quiet"):
        pass
    assert entered == []


# ---------------------------------------------------------------------------
# the SfM pipeline's timing keys are views of its spans


@pytest.fixture(scope="module")
def traced_scene():
    scene = render_views(n_views=5, image_size=(160, 192), arc_step=0.14)
    cfg = ReconstructionConfig()
    cfg = cfg.replace(
        sift=dataclasses.replace(cfg.sift, max_features=1024, contrast_threshold=0.012),
        match=dataclasses.replace(cfg.match, min_matches=15, ransac_hypotheses=512),
        sfm=dataclasses.replace(cfg.sfm, pnp_hypotheses=512),
    )
    pipe = SfMPipeline(config=cfg, device="cpu")
    iset = image_set_from_arrays(scene["images"], Camera.from_matrix(scene["K"]))
    io_root = _last("io.image_set")
    pipe.reconstruct(image_set=iset)
    return pipe, _last("sfm.reconstruct"), io_root


STAGE_SPANS = {"load_time": "sfm.load", "extract_time": "sfm.extract",
               "match_time": "sfm.match", "init_time": "sfm.init",
               "incremental_time": "sfm.incremental", "final_ba_time": "sfm.final",
               "total_time": "sfm.reconstruct"}


@pytest.mark.parametrize("key", sorted(STAGE_SPANS))
def test_stage_time_is_its_spans_duration(traced_scene, key):
    pipe, root, _ = traced_scene
    assert pipe.stats[key] == pytest.approx(root["seconds"][STAGE_SPANS[key]], rel=1e-12)
    assert root["count"][STAGE_SPANS[key]] == 1


def _children_seconds(root, parent, name):
    """Seconds of the spans `name` below the (one) span `parent`."""
    spans = root["spans"]
    top = next(i for i, s in enumerate(spans) if s["name"] == parent)
    total = 0
    for s in spans:
        p = s["parent"]
        while p is not None and p != top:
            p = spans[p]["parent"]
        if s["name"] == name and p == top:
            total += s["end_ns"] - s["start_ns"]
    return total / 1e9


@pytest.mark.parametrize("group,key,parent,name", [
    ("extract_detail_s", "host_prep_s", "sfm.extract", "extract.host_prep"),
    ("extract_detail_s", "detect_dispatch_s", "sfm.extract", "extract.detect_dispatch"),
    ("extract_detail_s", "counts_sync_s", "sfm.extract", "extract.counts_sync"),
    ("extract_detail_s", "describe_dispatch_s", "sfm.extract", "extract.describe_dispatch"),
    ("extract_detail_s", "concat_s", "sfm.extract", "extract.concat"),
    ("extract_detail_s", "kp_pull_sync_s", "sfm.extract", "extract.kp_pull"),
    ("match_detail_s", "valid_fetch_s", "sfm.match", "match.valid_fetch"),
    ("match_detail_s", "compact_s", "sfm.match", "match.compact"),
    ("match_detail_s", "dispatch_s", "sfm.match", "match.dispatch"),
    ("match_detail_s", "result_pull_s", "sfm.match", "match.result_pull"),
    ("match_detail_s", "translate_s", "sfm.match", "match.translate"),
    ("incremental_breakdown_s", "cands", "sfm.incremental", "wave.candidates"),
    ("incremental_breakdown_s", "register", "sfm.incremental", "wave.pnp"),
    ("incremental_breakdown_s", "triangulate", "sfm.incremental", "wave.triangulate"),
    ("incremental_breakdown_s", "ba_light", "sfm.incremental", "ba.light"),
    ("incremental_breakdown_s", "ba_full", "sfm.incremental", "ba.full"),
])
def test_detail_keys_are_their_spans_durations(traced_scene, group, key, parent, name):
    pipe, root, _ = traced_scene
    want = _children_seconds(root, parent, name)
    if name.startswith("match."):
        # the long-span rematch runs the same segments once more, outside the view
        want -= _children_seconds(root, "match.rematch", name)
    assert pipe.stats[group][key] == round(want, 3)


@pytest.mark.parametrize("key,names", [
    ("prep", ("pnp.prep",)), ("dispatch", ("pnp.dispatch",)),
    ("solve_fetch", ("pnp.fetch",)), ("accept", ("pnp.accept",)),
])
def test_register_detail_is_its_spans(traced_scene, key, names):
    pipe, root, _ = traced_scene
    assert pipe.stats["register_detail_s"][key] == pytest.approx(
        sum(root["seconds"][n] for n in names), abs=1e-9)
    assert pipe.stats["register_detail_s"]["waves"] == root["counters"]["wave.count"]


def test_ba_full_detail_is_its_spans(traced_scene):
    pipe, root, _ = traced_scene
    det, sec = pipe.stats["ba_full_detail_s"], root["seconds"]
    assert det["calls"] == root["count"]["ba.full"] == root["counters"]["ba.calls"]
    assert det["table"] == pytest.approx(sec["ba.prep"], abs=1e-9)
    assert det["upload"] == pytest.approx(sec["ba.upload"], abs=1e-9)
    assert det["prep"] == pytest.approx(sec["ba.prep"] + sec["ba.upload"], abs=1e-9)
    assert det["solve_fetch"] == pytest.approx(sec["ba.solve"] + sec["ba.fetch"], abs=1e-9)
    assert sum(det["iterations"]) == root["counters"]["ba.lm_accepted"]


def test_scene_counters_and_span_budget(traced_scene):
    pipe, root, io_root = traced_scene
    c = root["counters"]
    assert c["ba.lm_steps"] == root["count"]["ba.lm_step"] >= c["ba.lm_accepted"] >= 1
    assert c["host.reads"] == root["count"]["host.pull"] > 0
    assert c["host.read_bytes"] > 0
    assert c["wave.tried"] >= c["wave.accepted"] == len(pipe.registered) - 2
    assert c["wave.count"] == pipe.stats["register_detail_s"]["waves"]
    assert io_root["ok"] and root["ok"] and io_root["seq"] < root["seq"]
    assert sum(root["count"].values()) == len(root["spans"]) < 2000
    names = set(root["count"])
    assert {"sfm.wave", "wave.candidates", "wave.pnp", "wave.triangulate", "ba.light",
            "ba.full", "ba.prep", "ba.upload", "ba.solve", "ba.lm_step", "ba.fetch",
            "sfm.recover", "sfm.rescue", "sfm.normalize", "match.graph"} <= names
    assert not any(n.startswith("aten::") for n in names)
