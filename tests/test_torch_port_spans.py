"""The port's recorder (dorylus_tpu_torch/common/metrics.py): spans with
their parents, self times, the bounded list and the per-name aggregate,
counters and gauges, reset, the switch that turns it off, the
torch.profiler annotation, and the spans, counters and gauges the program
records: Graph.finalize, the hyb op's build, Engine's build and group
loop, the report file, the pair-reuse build's seconds and the CUDA
build's."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dorylus_tpu_torch.common import metrics
from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.common.metrics import Recorder, RunReport
from dorylus_tpu_torch.engine.engine import Engine
from dorylus_tpu_torch.graph.graph import synthetic_graph
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.hyb_plan import build_hyb_plan

torch.set_num_threads(1)


@pytest.fixture
def rec():
    return Recorder(recent=8)


@pytest.fixture
def program():
    """The process's recorder, emptied before and after the test."""
    metrics.reset()
    yield metrics
    metrics.reset()


def test_nesting_parents_and_self_time(rec):
    with rec.span("outer", k=1) as outer:
        time.sleep(0.01)
        with rec.span("inner") as inner:
            time.sleep(0.02)
            inner.attrs["late"] = True
        with rec.span("inner"):
            time.sleep(0.01)
    agg = rec.spans()
    assert agg["inner"]["count"] == 2 and agg["outer"]["count"] == 1
    assert agg["inner"]["self_s"] == pytest.approx(agg["inner"]["total_s"])
    assert agg["outer"]["total_s"] == pytest.approx(outer.seconds)
    assert agg["outer"]["self_s"] == pytest.approx(
        outer.seconds - agg["inner"]["total_s"], abs=1e-9)
    assert 0.005 < agg["outer"]["self_s"] < agg["outer"]["total_s"]
    got = rec.recent()
    assert [(r["name"], r["parent"]) for r in got] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)]
    assert got[0]["attrs"] == {"late": True} and got[2]["attrs"] == {"k": 1}
    assert got[2]["start"] <= got[0]["start"] <= got[0]["end"] <= got[2]["end"]


def test_aggregate_matches_the_list_and_the_list_is_bounded(rec):
    for i in range(20):
        with rec.span("a" if i % 3 else "b", i=i):
            pass
    got = rec.recent()
    assert len(got) == 8 and [r["attrs"]["i"] for r in got] == list(range(12, 20))
    agg = rec.spans()
    assert agg["a"]["count"] + agg["b"]["count"] == 20 and agg["b"]["count"] == 7
    last = [r for r in got if r["name"] == "b"]
    assert sum(r["end"] - r["start"] for r in last) <= agg["b"]["total_s"] + 1e-12
    # with room for all of them, the list sums to the aggregate
    whole = Recorder()
    for i in range(20):
        with whole.span("a" if i % 3 else "b"):
            sum(range(1000))
    for name, a in whole.spans().items():
        spans = [r for r in whole.recent() if r["name"] == name]
        assert len(spans) == a["count"]
        assert sum(r["end"] - r["start"] for r in spans) == pytest.approx(a["total_s"])


def test_counters_gauges_and_reset(rec):
    rec.count("c")
    rec.count("c", 4)
    rec.gauge("g", 3)
    rec.gauge("g", 7.5)
    with rec.span("s"):
        pass
    assert rec.counters() == {"c": 5} and rec.gauges() == {"g": 7.5}
    rec.reset()
    assert rec.spans() == {} and rec.recent() == [] and rec.counters() == {} \
        and rec.gauges() == {}


def test_a_span_open_across_reset_still_records(rec):
    with rec.span("open"):
        rec.reset()
    assert rec.spans()["open"]["count"] == 1


def test_disabled_records_nothing(rec):
    assert rec.set_enabled(False) is True
    with rec.span("off") as s:
        rec.count("c")
        rec.gauge("g", 1)
        time.sleep(0.01)
    # the span still times its body, for the code that reads its seconds
    assert s.seconds >= 0.01 and s.parent is None
    assert rec.spans() == {} and rec.counters() == {} and rec.gauges() == {}
    assert rec.recent() == []
    assert rec.set_enabled(True) is False
    with rec.span("on") as s:
        pass
    assert s.seconds >= 0.0 and rec.spans()["on"]["count"] == 1


@pytest.mark.parametrize("on_at_open", [True, False])
def test_switching_inside_a_span_keeps_the_stack(rec, on_at_open):
    rec.set_enabled(on_at_open)
    with rec.span("outer") as outer:
        rec.set_enabled(not on_at_open)
    rec.set_enabled(True)
    with rec.span("after") as after:
        pass
    # a span records as the recorder stood when it opened
    assert ("outer" in rec.spans()) is on_at_open
    assert outer.seconds >= 0.0 and after.parent is None
    assert rec.spans()["after"]["count"] == 1


def test_a_raising_body_is_recorded_and_unwound(rec):
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("fails"):
                raise ValueError("x")
    with rec.span("after"):
        pass
    assert [(r["name"], r["parent"]) for r in rec.recent()] == [
        ("fails", "outer"), ("outer", None), ("after", None)]


def test_threads_keep_their_own_parents_and_lose_no_update(rec):
    """More threads than cores, a short switch interval: every span and
    count lands, and each thread's spans nest under its own."""
    n_threads, n = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            with rec.span(f"t{t}"):
                for _ in range(n):
                    with rec.span("leaf"):
                        rec.count("leaves")

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert rec.counters()["leaves"] == n_threads * n
    assert rec.spans()["leaf"]["count"] == n_threads * n


def test_span_is_a_user_annotation_under_the_profiler(rec, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("probe.outer"):
            with rec.span("probe.inner"):
                torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"probe.outer", "probe.inner"} <= notes.keys()
    o, i = notes["probe.outer"], notes["probe.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert rec.spans()["probe.outer"]["count"] == 1


def test_no_annotation_without_a_session(rec, monkeypatch):
    from torch.autograd import profiler

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler session")

    monkeypatch.setattr(profiler, "record_function", refuse)
    with rec.span("quiet"):
        pass
    assert rec.spans()["quiet"]["count"] == 1


# ---- what the program records ----


def small_engine(epochs=60, **cfg):
    g = synthetic_graph(400, 6, 24, 5, seed=31)
    eng = Engine(g, LayerConfig([24, 12, 5]),
                 TrainConfig(epochs=epochs, eval_every=1, kernel="hyb", reuse="off", **cfg),
                 device="cpu")
    return g, eng


def test_engine_leaves_the_span_tree(program):
    g, eng = small_engine()
    eng.run(60)
    pairs = [(r["name"], r["parent"]) for r in program.recent()]
    assert ("graph.finalize", None) in pairs and ("graph.sort", "graph.finalize") in pairs \
        and ("graph.norms", "graph.finalize") in pairs
    for child in ("hyb.check", "hyb.transpose_order", "hyb.plan", "hyb.upload",
                  "engine.batch", "engine.params"):
        assert (child, "engine.build") in pairs, child
    assert ("engine.build", None) in pairs
    recs = program.recent()
    plans = [r["attrs"] for r in recs if r["name"] == "hyb.plan"]
    assert [p["direction"] for p in plans] == ["fwd", "bwd"]
    assert all(p["buckets"] >= 1 and p["hub_rows"] >= 0 for p in plans)
    groups = [r for r in recs if r["name"] == "engine.group"]
    assert [r["attrs"]["epochs"] for r in groups] == [25, 25, 10]
    assert [r["attrs"]["evals"] for r in groups] == [25, 25, 10]
    assert all(r["parent"] == "engine.run" and r["attrs"]["replayed"] is False
               for r in groups)
    for child in ("engine.dispatch", "engine.group_read", "engine.group_records"):
        assert pairs.count((child, "engine.group")) == 3, child
    assert pairs.count(("engine.run_end", "engine.run")) == 1
    assert pairs.count(("engine.final_eval", "engine.run_end")) == 2
    assert pairs.count(("engine.report", "engine.run_end")) == 1
    assert [r["attrs"]["mask"] for r in recs if r["name"] == "engine.final_eval"] == \
        ["val", "test"]
    agg = program.spans()
    assert agg["engine.run"]["count"] == 1 and agg["engine.group"]["count"] == 3
    build = agg["engine.build"]
    assert 0 <= build["self_s"] <= build["total_s"]
    fwd = build_hyb_plan(g.src, g.dst, None, g.num_vertices)
    order = np.argsort(g.src, kind="stable")
    bwd = build_hyb_plan(g.dst[order], g.src[order], order, g.num_vertices)
    gauges = program.gauges()
    assert gauges["hyb.slots.fwd"] == fwd["n_slots"] and gauges["hyb.slots.bwd"] == bwd["n_slots"]
    assert gauges["hyb.edges"] == g.num_edges
    op = eng.model.spmm_op
    for d in ("fwd", "bwd"):
        plan = getattr(op, d)
        parts = list(plan["buckets"]) + ([plan["top"]] if plan["top"] is not None else [])
        assert gauges[f"hyb.slots.{d}"] == sum(p["rows"].numel() for p in parts)
        assert gauges[f"hyb.plan_bytes.{d}"] >= sum(
            p["rows"].numel() * 4 + p["vals"].numel() * p["vals"].element_size()
            for p in parts)
    assert program.recent()[-1]["name"] == "engine.run"


def test_finalize_says_which_path_ran(program):
    from dorylus_tpu_torch import native

    synthetic_graph(200, 4, 8, 3, seed=2)
    fin = [r for r in program.recent() if r["name"] == "graph.finalize"][-1]
    assert fin["attrs"]["native"] == native.available()
    assert fin["attrs"]["edges"] > 0


def test_spans_leave_the_training_unchanged(program):
    g, a = small_engine(epochs=8)
    ra = a.run(8)
    was = program.set_enabled(False)
    try:
        _, b = small_engine(epochs=8)
        rb = b.run(8)
    finally:
        program.set_enabled(was)
    assert [e.loss for e in ra.epochs] == [e.loss for e in rb.epochs]
    assert ra.final_accuracy == rb.final_accuracy
    assert program.spans()["engine.group"]["count"] == 1


def test_report_file_carries_the_spans(program, tmp_path):
    _, eng = small_engine(epochs=3)
    program.count("probe.count", 2)
    eng.run(3)
    path = tmp_path / "report.json"
    eng.report.write(str(path))
    out = json.loads(path.read_text())
    spans = out["notes"]["spans"]
    assert spans["engine.run"]["count"] == 1 and spans["engine.build"]["count"] == 1
    assert set(spans["engine.group"]) == {"count", "total_s", "self_s"}
    assert out["notes"]["counters"] == {"probe.count": 2}
    assert out["notes"]["gauges"]["hyb.edges"] == eng.graph.num_edges
    # to_json is the JAX package's, unchanged: no record there
    assert "spans" not in json.loads(eng.report.to_json())["notes"]
    assert "spans" not in RunReport().notes


def test_reuse_seconds_come_from_its_spans(program):
    from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM

    g = synthetic_graph(300, 8, 8, 3, seed=5)
    op = ReuseSpMM(g.src, g.dst, g.num_vertices, g.num_vertices, device="cpu")
    mines = [r for r in program.recent() if r["name"] == "reuse.mine"]
    build = [r for r in program.recent() if r["name"] == "reuse.build"][-1]
    assert [m["attrs"]["direction"] for m in mines] == ["fwd", "bwd"]
    assert all(m["parent"] == "reuse.build" for m in mines)
    assert op.mine_seconds == tuple(m["end"] - m["start"] for m in mines)
    assert op.build_seconds == build["end"] - build["start"]
    assert op.build_seconds >= sum(op.mine_seconds) > 0
    assert build["attrs"]["miner"] == op.miner


def test_reuse_seconds_stay_true_with_the_recorder_off(program):
    from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM

    g = synthetic_graph(300, 8, 8, 3, seed=5)
    was = program.set_enabled(False)
    try:
        op = ReuseSpMM(g.src, g.dst, g.num_vertices, g.num_vertices, device="cpu")
    finally:
        program.set_enabled(was)
    assert "reuse.build" not in program.spans()
    assert op.build_seconds >= sum(op.mine_seconds) > 0 and min(op.mine_seconds) > 0


def fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes its -o file after a short sleep."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
                      "out=$2; fi; shift; done\nsleep 0.2\n: > \"$out\"\necho built\n")
    script.chmod(0o755)
    return str(script)


def test_cuda_build_seconds_come_from_its_spans(program, tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: fake_nvcc(tmp_path))
    srcs = sorted(cuda_build.CSRC.glob("*.cu"))[:2]
    info = cuda_build.compile_sources(srcs)
    comp = [r for r in program.recent() if r["name"] == "cuda_build.compile"]
    assert len(comp) == 1 and comp[0]["attrs"]["libraries"] == 2
    waits = [r for r in program.recent() if r["name"] == "cuda_build.nvcc"]
    assert [w["attrs"]["library"] for w in waits] == [src.stem for src in srcs]
    assert all(w["parent"] == "cuda_build.compile" for w in waits)
    for src, wait in zip(srcs, waits):
        assert info[src]["compiled"] is True and info[src]["log"].strip() == "built"
        # each library's own: from the batch's start to the end of its wait
        assert info[src]["seconds"] == wait["end"] - comp[0]["start"]
        assert 0.2 <= info[src]["seconds"] <= comp[0]["end"] - comp[0]["start"]
    again = cuda_build.compile_sources(srcs)
    assert all(not again[s]["compiled"] and again[s]["seconds"] == 0.0 for s in srcs)
    assert program.spans()["cuda_build.compile"]["count"] == 1
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    lib, inf = cuda_build.load(srcs[0])
    load = program.recent()[-1]
    assert lib == inf["path"] and load["name"] == "cuda_build.load"
    assert load["attrs"] == {"library": srcs[0].stem, "compiled": False}
