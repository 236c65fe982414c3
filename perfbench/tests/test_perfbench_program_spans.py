"""The readers of the program's own record: the set-up spans and the slot
gauges from the program's recorder, run_end_ms and loop_idle_ms from the
spans' annotations in a hand-made window trace, each reading nothing where
the program or the trace has no such record, and a traced run of a tiny
cell on the CPU that prints every reader the trace and record feed."""

import json

import numpy as np
import pytest
import torch

from conftest import write_cell
from dorylus_tpu_torch.common import metrics as program
from perfbench.devtrace import WINDOW, Trace
from perfbench.harness import Context, run_cell
from perfbench.spec import Cell

RECORDED = ("finalize_s", "plan_host_s", "plan_upload_s", "slot_fill")


def reader(name):
    return Cell("gcn-reddit.full").metric_reader(name)


def ctx(trace=None):
    return Context({}, {}, {}, 0, trace)


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def window_trace():
    """A window of 1000 us, two epochs in one run(): the group's dispatch
    (0-300, kernels 10-290), its read (300-400, the copy 300-350), its
    records (400-600, an aten::item inside at 450-550), then the run's end
    (600-1000, an eval kernel 620-900). Idle in loop spans but not in the
    dispatch: 350-620 and 900-1000, 370 us."""
    ev = [x(WINDOW, "user_annotation", 0, 1000),
          x("engine.run", "user_annotation", 0, 1000),
          x("engine.group", "user_annotation", 0, 600),
          x("engine.dispatch", "user_annotation", 0, 300),
          x("engine.group_read", "user_annotation", 300, 100),
          x("engine.group_records", "user_annotation", 400, 200),
          x("aten::item", "cpu_op", 450, 100),
          x("engine.run_end", "user_annotation", 600, 400),
          x("engine.final_eval", "user_annotation", 610, 300),
          x("k1", "kernel", 10, 280), x("copy", "gpu_memcpy", 300, 50),
          x("k2", "kernel", 620, 280)]
    return Trace(ev, epochs=2, runs=1)


def test_loop_idle_counts_idle_under_loop_spans_only():
    tr = window_trace()
    assert reader("loop_idle_ms")(ctx(tr)) == pytest.approx(0.370 / 2)
    # the gap inside the group's records is labelled by the finer event,
    # and still counts
    assert dict(tr.idle_gaps())["aten::item"] > 0


def test_loop_idle_leaves_out_idle_between_runs():
    """Two run() calls with 100 us of idle between them, outside engine.run:
    only the idle inside each run's end (20 us each) counts."""
    ev = [x(WINDOW, "user_annotation", 0, 1000)]
    for t in (0, 500):
        ev += [x("engine.run", "user_annotation", t, 400),
               x("engine.dispatch", "user_annotation", t, 380),
               x("k", "kernel", t, 380)]
    ev.append(x("k", "kernel", 900, 100))
    tr = Trace(ev, epochs=4, runs=2)
    assert reader("loop_idle_ms")(ctx(tr)) == pytest.approx(0.040 / 4)


def test_run_end_is_the_mean_annotation():
    tr = window_trace()
    assert reader("run_end_ms")(ctx(tr)) == pytest.approx(0.4)
    ev = [x(WINDOW, "user_annotation", 0, 2000),
          x("engine.run_end", "user_annotation", 100, 300),
          x("engine.run_end", "user_annotation", 1000, 500),
          x("engine.run_end", "cpu_op", 1600, 900),
          x("k", "kernel", 0, 10)]
    assert reader("run_end_ms")(ctx(Trace(ev, 4, 2))) == pytest.approx(0.4)


def test_trace_readers_read_nothing_without_the_spans():
    ev = [x(WINDOW, "user_annotation", 0, 1000), x("aten::mm", "cpu_op", 0, 900),
          x("k", "kernel", 10, 500)]
    tr = Trace(ev, 2, 1)
    for name in ("run_end_ms", "loop_idle_ms"):
        assert reader(name)(ctx(tr)) is None and reader(name)(ctx()) is None


def test_recorded_readers_read_the_program_record():
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.graph.graph import synthetic_graph

    program.reset()
    try:
        assert all(reader(n)(ctx()) is None for n in RECORDED)
        g = synthetic_graph(400, 6, 24, 5, seed=3)
        Engine(g, LayerConfig([24, 12, 5]), TrainConfig(kernel="hyb", reuse="off"),
               device="cpu")
        spans, gauges = program.spans(), program.gauges()
        assert reader("finalize_s")(ctx()) == spans["graph.finalize"]["total_s"]
        assert reader("plan_host_s")(ctx()) == pytest.approx(
            sum(spans[k]["total_s"] for k in ("hyb.check", "hyb.transpose_order", "hyb.plan")))
        assert reader("plan_upload_s")(ctx()) == spans["hyb.upload"]["total_s"]
        fill = reader("slot_fill")(ctx())
        assert fill == pytest.approx(
            200.0 * g.num_edges / (gauges["hyb.slots.fwd"] + gauges["hyb.slots.bwd"]))
        assert 0 < fill <= 100
    finally:
        program.reset()


def test_recorded_readers_read_nothing_from_a_program_without_a_recorder(monkeypatch):
    for name in ("spans", "gauges"):
        monkeypatch.delattr(program, name)
    assert all(reader(n)(ctx()) is None for n in RECORDED)


def test_a_traced_cpu_run_prints_the_recorded_metrics(tmp_path):
    """The harness, traced, on the CPU, in a tiny cell that the new metrics
    list: the record's four readers and run_end_ms print; loop_idle_ms
    needs device events, which the CPU's trace has none of."""
    write_cell(tmp_path, "gcn")
    path = tmp_path / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for m in bench["per_layer"]:
        if "gcn-reddit.full" in m.get("workloads", []):
            m["workloads"].append("tiny.t")
    path.write_text(json.dumps(bench))
    program.reset()
    try:
        cell = Cell("tiny.t", tmp_path, tmp_path / "perfbench")
        out = run_cell(cell, 2**31 + 7, 0.2, True, torch.device("cpu"), 0.0)
    finally:
        program.reset()
    got = out["metrics"]
    assert set(RECORDED) | {"run_end_ms"} <= got.keys()
    assert "loop_idle_ms" not in got
    assert got["run_end_ms"]["value"] > 0 and got["run_end_ms"]["unit"] == "ms"
    assert np.isfinite([got[n]["value"] for n in RECORDED]).all()
