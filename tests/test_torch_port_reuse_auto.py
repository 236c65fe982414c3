"""reuse="auto" in the port against the JAX package, on the CPU:

  * `reuse_payoff` and `gate_reuse_auto` (engine/engine.py) with JAX's
    constants patched in equal JAX's over a grid of model, V, E and
    cfg.epochs on both sides of the gate's threshold;
  * `Engine(reuse="auto")` against JAX's `Engine(reuse="auto")` at JAX's
    constants: on a community graph where the gate opens and the mined cut
    (22.7%) clears the 10% floor, the same decision, the same rewrite and
    the losses within the reuse tolerances; on a uniform graph (cut 0) both
    plain hyb; with the gate shut both plain hyb;
  * the same three on 2 gloo ranks of `ShardedEngine` against JAX's
    `ShardedEngine` on `make_mesh(2)` (the cut summed over the shards);
  * at the card's constants (fitted on the H100, PERF.md §6) the
    decision the fitted numbers predict.

The gate reads cfg.epochs (the declared horizon): the engines are built
with the horizon the case needs and run 3 epochs. Tolerances as in
tests/test_torch_port_reuse.py: GCN loss atol 1e-4, GAT rtol 1e-5 (f32).
"""

import math

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import Engine as JEngine
from dorylus_tpu.engine import engine as jengine
from dorylus_tpu.graph.graph import Graph, community_core_edges
from dorylus_tpu.ops.hyb_spmm import HybSpMM as JHybSpMM
from dorylus_tpu.ops.reuse_sharded import ShardedReuseSpMM as JShardedReuseSpMM
from dorylus_tpu.ops.reuse_spmm import ReuseSpMM as JReuseSpMM
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.engine import engine as tengine
from dorylus_tpu_torch.graph.graph import build_graph
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
from dorylus_tpu_torch.parallel.multihost import spawn_local
from test_torch_port_sharded import loss_close

torch.set_num_threads(1)

DIMS = [24, 12, 5]
CONSTANTS = ("REUSE_AUTO_MIN_CUT", "REUSE_SAVE_S_PER_ROW", "REUSE_MODEL_EFF",
             "REUSE_CUT_CAP", "REUSE_MINE_S_PER_EDGE")
JAX_CONSTANTS = {k: getattr(jengine, k) for k in CONSTANTS}


@pytest.fixture
def jax_constants(monkeypatch):
    for k, x in JAX_CONSTANTS.items():
        monkeypatch.setattr(tengine, k, x)


def community():
    """Communities of 40 sharing a core of 20: the rewrite cuts 22.7% of
    the gathered rows (22.7% on each of 2 range shards)."""
    src, dst = community_core_edges(800, 12, comm=40, core=20, p_core=0.85, seed=1)
    rng = np.random.default_rng(4)
    labels = ((np.arange(800) * 5) // 800).astype(np.int32)
    feats = rng.normal(0, 1, size=(800, 24)).astype(np.float32)
    feats += 0.6 * rng.normal(0, 1, size=(5, 24)).astype(np.float32)[labels]
    return Graph(num_vertices=800, src=src, dst=dst, features=feats, labels=labels,
                 num_classes=5).finalize()


def uniform():
    """A uniform random graph: no pair repeats, the cut is 0."""
    g = build_graph(600, 6, 24, 5, seed=3)
    return Graph(num_vertices=g.num_vertices, src=g.src, dst=g.dst, features=g.features,
                 labels=g.labels, num_classes=g.num_classes).finalize()


def threshold(model: str, v: int, e: int) -> int:
    """The least cfg.epochs at which JAX's gate opens."""
    c = JAX_CONSTANTS
    per_epoch = c["REUSE_CUT_CAP"] * v * c["REUSE_SAVE_S_PER_ROW"] * c["REUSE_MODEL_EFF"][model]
    return math.ceil(e * c["REUSE_MINE_S_PER_EDGE"] / per_epoch)


# (the case, the graph, the model, cfg.epochs, what both engines must take)
CASES = {"opens": (community, "gcn", 100, "reuse"),
         "opens-gat": (community, "gat", 800, "reuse"),
         "floor": (uniform, "gcn", 100, "plain"),
         "shut": (community, "gcn", 3, "plain")}


@pytest.mark.parametrize("v,e", [(800, 9359), (232_965, 11_648_250), (1_600_000, 23_986_000),
                                 (4000, 80_000)])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_payoff_matches_jax(jax_constants, model, v, e):
    thr = threshold(model, v, e)
    for epochs in (1, thr - 1, thr, thr + 1, 100, 10 * thr):
        cfg = TrainConfig(model=model, epochs=max(1, epochs))
        assert tengine.reuse_payoff(cfg, v, e) == jengine.reuse_payoff(cfg, v, e)
        want = jengine.gate_reuse_auto(cfg, v, e)
        assert tengine.gate_reuse_auto(cfg, v, e) == want
        assert want == (max(1, epochs) >= thr)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_auto_matches_jax(jax_constants, capfd, case):
    make, model, epochs, want = CASES[case]
    g = make()
    assert JAX_CONSTANTS["REUSE_AUTO_MIN_CUT"] == 0.10
    cfg = TrainConfig(epochs=epochs, eval_every=1, kernel="hyb", model=model,
                      learning_rate=0.005 if model == "gat" else 0.01)
    assert cfg.reuse == "auto"
    gate = threshold(model, g.num_vertices, g.num_edges) <= epochs
    assert gate == (case != "shut")
    teng = tengine.Engine(g, LayerConfig(DIMS), cfg, device="cpu")
    jeng = JEngine(g, LayerConfig(DIMS), cfg)
    top, jop = teng.model.spmm_op, jeng.model.spmm_op
    if want == "reuse":
        assert isinstance(top, ReuseSpMM) and isinstance(jop, JReuseSpMM)
        assert top.plan_fwd.stats["row_reduction"] >= 0.10
        for mine, theirs in ((top.plan_fwd, jop.plan_fwd), (top.plan_bwd, jop.plan_bwd)):
            assert mine.num_pairs == theirs.num_pairs > 0
            for a, b in zip(mine.levels, theirs.levels):
                np.testing.assert_array_equal(a, b)
    else:
        assert type(top) is HybSpMM and type(jop) is JHybSpMM
    logged = capfd.readouterr().err
    assert ("skipping mining" in logged) == (case == "shut")
    assert ("below the 10% profitability floor" in logged) == (case == "floor")
    tl = [e.loss for e in teng.run(3).epochs]
    jl = [e.loss for e in jeng.run(3).epochs]
    loss_close(tl, jl, model, False)


def jax_sharded(g, cfg):
    eng = JShardedEngine(g, LayerConfig(DIMS), cfg, mesh=make_mesh(2))
    return eng, [e.loss for e in eng.run(3).epochs]


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 devices (virtual CPU mesh)")
def test_sharded_auto_matches_jax(capfd):
    """The three cases on 2 gloo ranks in one launch per graph, against JAX's
    ShardedEngine: the rewrite kept (overlap off) on the community graph,
    the fused plan (overlap on, as reuse="off" runs) below the floor and
    with the gate shut."""
    opts = {"constants": JAX_CONSTANTS, "run": 3}
    for make, cases in ((community, ("opens", "shut")), (uniform, ("floor",))):
        g = make()
        runs = [(dict(model=CASES[c][1], kernel="hyb", eval_every=1), CASES[c][2], opts)
                for c in cases]
        res = spawn_local(2, ranks.engines_rank, (g, DIMS, runs), backend="gloo",
                          device="cpu", timeout_s=240)
        assert all(a["losses"] == b["losses"] for a, b in zip(res[0], res[1]))
        for i, case in enumerate(cases):
            _, model, epochs, want = CASES[case]
            jeng, jl = jax_sharded(g, TrainConfig(epochs=epochs, eval_every=1, kernel="hyb",
                                                  model=model))
            jop = jeng.model.spmm_op
            if want == "reuse":
                assert isinstance(jop, JShardedReuseSpMM) and not jeng.cfg.overlap
                assert (res[0][i]["plan"], res[0][i]["overlap"]) == ("ShardedReuseSpMM", False)
                for r in range(2):
                    assert res[r][i]["pairs"] == (jop.plan_fwd[r].num_pairs,
                                                  jop.plan_bwd[r].num_pairs)
            else:
                assert jop is None and jeng.cfg.overlap
                assert (res[0][i]["plan"], res[0][i]["overlap"]) == ("fused", True)
            loss_close(res[0][i]["losses"], jl, model, False)
    logged = capfd.readouterr().err
    assert "reuse auto: sharded row cut 0.0% below the 10% profitability floor" in logged
    assert "skipping mining" in logged


def test_card_constants_decide_as_fitted(capfd):
    """The card's fit (PERF.md §6): an epoch with the rewrite saves
    nothing on the H100, so REUSE_SAVE_S_PER_ROW = 0 and GAT's efficiency
    0: the gate stays shut at any horizon, says why (0.0e+00 s/row), and
    reuse="auto" trains what reuse="off" trains, bit for bit."""
    assert tengine.REUSE_SAVE_S_PER_ROW == 0.0 and tengine.REUSE_MODEL_EFF["gat"] == 0.0
    assert (tengine.REUSE_AUTO_MIN_CUT, tengine.REUSE_CUT_CAP) == (0.10, 0.45)
    for model in ("gcn", "gat"):
        for v, e in ((4000, 80_000), (232_965, 11_619_013), (1_600_000, 23_986_000)):
            for epochs in (1, 100, 10**6):
                cfg = TrainConfig(model=model, epochs=epochs)
                worth, ceiling, mine = tengine.reuse_payoff(cfg, v, e)
                assert (worth, ceiling) == (False, 0.0)
                assert mine == e * tengine.REUSE_MINE_S_PER_EDGE > 0
    g = community()
    cfg = TrainConfig(epochs=100, eval_every=1, kernel="hyb")
    auto = tengine.Engine(g, LayerConfig(DIMS), cfg, device="cpu")
    assert type(auto.model.spmm_op) is HybSpMM
    assert "x 0.0e+00 s/row" in capfd.readouterr().err
    off = tengine.Engine(g, LayerConfig(DIMS), TrainConfig(epochs=100, eval_every=1,
                                                           kernel="hyb", reuse="off"),
                         device="cpu")
    assert [e.loss for e in auto.run(3).epochs] == [e.loss for e in off.run(3).epochs]
