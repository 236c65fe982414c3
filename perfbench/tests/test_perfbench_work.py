"""The yardstick's counts against hand counts on a tiny graph, and the
shares of a peak or a roofline, fed the bound time itself, read 100% and no
more."""

import json
import math

import pytest

from conftest import REPO
from perfbench import work
from perfbench.spec import Cell

# V = 4 vertices, E = 6 edges, widths 3 -> 2 -> 2
TINY = {"model": "gcn", "num_vertices": 4, "dims": [3, 2, 2], "agg_dtype": "bfloat16",
        "optimize_order": True}
TRAFFIC = {"edges": 6, "eval_every": 1, "epochs_per_run": 2}


def test_aggregation_by_hand():
    op = work.aggregation("a", edges=6, v_src=4, v_out=4, width=2, table_dtype="bfloat16",
                          val_dtype="bfloat16")
    # indices 6*4, values 6*2, row offsets 5*4, table 4*2*2, output 4*2*4
    assert op.bytes == 24 + 12 + 20 + 16 + 32
    assert op.flops == 2 * 6 * 2
    unit = work.aggregation("u", 6, 4, 4, 2, "bfloat16", None)
    assert unit.bytes == 24 + 20 + 16 + 32 and unit.flops == 6 * 2


def test_matmul_by_hand():
    op = work.matmul("m", 4, 3, 2)
    assert op.flops == 2 * 4 * 3 * 2 and op.bytes == (12 + 6 + 8) * 4
    assert op.bound_s() == max(48 / 67e12, 104 / 3.35e12)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_epoch_ops_by_hand(model):
    """3 -> 2 -> 2. GCN: layer 0 shrinks, so it transforms first and
    aggregates x W0 at 2, whose gradient flows back; layer 1 (2 -> 2)
    aggregates its input h at 2, which has a gradient (l > 0). GAT
    aggregates z at 2 in both. So 2 aggregations forward, 2 backward, 2 in
    the eval; matmuls: 2 forward, dW0, dW1 and dH1, 2 in the eval; GAT's
    attention adds z @ a a layer forward and in the eval, and d(za) a^T and
    z^T d(za) a layer backward: 8 more."""
    cfg = dict(TINY, model=model)
    ops = work.forward_ops(cfg, 6) + work.backward_ops(cfg, 6) + work.forward_ops(cfg, 6, "eval")
    assert sum(op.kind == "aggregate" for op in ops) == 6
    assert sum(op.kind == "matmul" for op in ops) == (7 if model == "gcn" else 15)
    assert all(op.bytes > 0 and op.flops > 0 for op in ops)


def test_gcn_widening_first_layer_has_no_backward_aggregation():
    cfg = dict(TINY, dims=[2, 3, 2])  # layer 0 aggregates x itself, at 2
    names = [op.name for op in work.backward_ops(cfg, 6)]
    assert "bwd.agg0" not in names and "bwd.agg1" in names


def test_gat_attention_products_by_hand():
    """V = 4, layer widths 2 and 2: a layer's z @ a is (4, 2) @ (2, 1),
    16 operations; d(za) a^T is (4, 1) @ (1, 2), 16; z^T d(za) is (2, 4) @
    (4, 1), 16; each f32, its inputs read and its output written once."""
    cfg = dict(TINY, model="gat")
    fwd = {op.name: op for op in work.attention_ops(cfg, "fwd")}
    bwd = {op.name: op for op in work.attention_ops(cfg, "bwd")}
    assert sorted(fwd) == ["fwd.att0", "fwd.att1"]
    assert sorted(bwd) == ["bwd.da0", "bwd.da1", "bwd.dz_att0", "bwd.dz_att1"]
    assert fwd["fwd.att0"].flops == 2 * 4 * 2 * 1 and fwd["fwd.att0"].bytes == (8 + 2 + 4) * 4
    assert bwd["bwd.dz_att0"].flops == 2 * 4 * 1 * 2 and bwd["bwd.dz_att0"].bytes == (4 + 2 + 8) * 4
    assert bwd["bwd.da0"].flops == 2 * 2 * 4 * 1 and bwd["bwd.da0"].bytes == (8 + 4 + 2) * 4
    assert all(op.kind == "matmul" for op in [*fwd.values(), *bwd.values()])
    assert work.attention_ops(TINY, "fwd") == [] and work.attention_ops(TINY, "bwd") == []
    names = [op.name for op in work.forward_ops(cfg, 6, "eval") + work.backward_ops(cfg, 6)]
    assert {"eval.att0", "eval.att1", "bwd.da1", "bwd.dz_att1"} <= set(names)


def test_window_counts_each_runs_final_evals():
    """One eval forward a run(k), whatever eval_every says: each evaluated
    epoch's weights are what the next epoch's training forward reads, and
    the run's last weights need one forward, for the final stats."""
    for every in (1, 3, 0):
        counted = work.window_ops(TINY, dict(TRAFFIC, eval_every=every), epochs=4, runs=2)
        n = {op.name: k for op, k in counted}
        assert n["fwd.agg0"] == 4 and n["bwd.dw0"] == 4 and n["bwd.agg1"] == 4
        assert n["eval.agg0"] == n["eval.agg1"] == n["eval.mm0"] == 2
        assert len(counted) == len(n)


class FakeTrace:
    """A trace whose kernels took exactly the bound time, and whose window
    holds nothing else."""

    def __init__(self, config, traffic, epochs, runs):
        self.epochs, self.runs = epochs, runs
        ops = work.window_ops(config, traffic, epochs, runs)
        self.agg, self.mm = work.bound_s(ops, "aggregate"), work.bound_s(ops, "matmul")
        self.span_s = self.agg + self.mm
        self.busy_s = self.span_s
        self.device = [("k", "kernel", 0.0, 1.0)]

    def kernel_seconds(self, include=None, exclude=None):
        if include is not None and include.search("gather_pass_kernel"):
            return self.agg
        if include is not None and include.search("cutlass_80_simt_sgemm"):
            return self.mm
        return 0.0


@pytest.mark.parametrize("cell", ["gcn-reddit.full", "gcn-reddit.sparse", "gat"])
@pytest.mark.parametrize("metric", ["gather_roofline", "matmul_roofline", "step_mfu"])
def test_shares_fed_the_bound_read_100(cell, metric):
    """Each cell's, and GAT's configuration on the full traffic."""
    c = Cell("gcn-reddit.full" if cell == "gat" else cell)
    config = dict(c.config, model="gat") if cell == "gat" else c.config
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert any(m["name"] == metric and m["unit"] == "%" for m in bench["per_layer"])

    class Ctx:
        traffic = c.traffic
    Ctx.config = config
    Ctx.trace = FakeTrace(config, c.traffic, epochs=700, runs=14)

    value = c.metric_reader(metric)(Ctx())
    assert math.isclose(value, 100.0, rel_tol=1e-9) and value <= 100.0 + 1e-9
