"""Stage profiling and the cost and memory notes of the port
(engine/profiling.py, `Engine.profile`, `ShardedEngine.profile`, the
notes `run_loop` fills) against the JAX package's `Engine.profile`,
`ShardedEngine.profile` and `report_cost`, on the CPU. ~25 s in one
process (one launch of 2 gloo ranks).

What is compared is the shape of the reports: the key sets (the brackets
one configuration has), that every time is > 0, `stage_times` in JAX's
layout, and the cost note's keys. The times themselves are this host's.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.engine import Engine as JEngine
from dorylus_tpu.engine.profiling import report_cost as jreport_cost
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.engine import profiling
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >=2 devices (virtual CPU mesh)")

DIMS = [16, 8, 4]


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(300, 6, 16, 4, seed=55)


def cfg_of(model, kernel, **kw):
    lr = 0.005 if model == "gat" else 0.01
    return TrainConfig(**dict(dict(epochs=1, eval_every=0, model=model, kernel=kernel,
                                   reuse="off", learning_rate=lr), **kw))


@pytest.mark.parametrize("kernel", ["hyb", "xla", "degree"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_engine_profile_returns_jaxs_keys(graph, model, kernel):
    """Engine.profile's brackets are JAX's for the same graph and config,
    each > 0; report.stage_times holds them in JAX's layout."""
    teng = TEngine(graph, LayerConfig(DIMS), cfg_of(model, kernel), device="cpu")
    times = teng.profile(iters=2)
    jeng = JEngine(graph, LayerConfig(DIMS), cfg_of(model, kernel))
    want = jeng.profile(iters=1)
    assert set(times) == set(want)
    assert all(v > 0 for v in times.values())
    st = teng.report.stage_times
    assert set(st) == set(jeng.report.stage_times) == set(times)
    for k, v in st.items():
        assert set(v) == set(jeng.report.stage_times[k]) == {"total_s", "count", "avg_ms"}
        assert v["count"] == 2 and v["avg_ms"] == times[k]
        assert v["total_s"] == pytest.approx(times[k] / 1e3 * 2)


def test_profile_gat_growing_layer():
    """JAX's test_profile_gat_growing_layer: the dense bracket times the
    layer's (V, fin) @ (fin, fout) on a GAT layer that grows the width."""
    g = synthetic_graph(500, 6, 4, 3, seed=1)
    eng = TEngine(g, LayerConfig([4, 8, 3]),
                  TrainConfig(model="gat", learning_rate=0.005, epochs=1, eval_every=0),
                  device="cpu")
    times = eng.profile(iters=2)
    for l in (0, 1):
        assert times[f"dense_l{l}_ms"] > 0
        assert times[f"aggregate_l{l}_ms"] > 0


def test_brackets_run_the_models_aggregation(graph):
    """Each layer's bracket aggregates at the model's width through the
    model's entry: GCN transforms first on a shrinking layer (8, then 4
    wide), GAT at its output width; the bracket's forward equals the op's
    entry on the first columns of x."""
    for model in ("gcn", "gat"):
        eng = TEngine(graph, LayerConfig(DIMS), cfg_of(model, "hyb"), device="cpu")
        brackets = profiling.agg_brackets(eng.model, eng.batch)
        assert [f for f, _, _ in brackets] == [8, 4]
        op, x = eng.model.spmm_op, eng.batch.x
        for f, fwd, bwd in brackets:
            h = x[:, :f].contiguous()
            want = op.apply_dst(h, h[:, 0]) if model == "gat" else op.apply_static(h)
            torch.testing.assert_close(fwd(), want)
            assert bwd().shape == h.shape


def test_stub_batch_is_rebuilt_for_the_brackets(graph, monkeypatch):
    """The hyb engines ship stub edge arrays; the profiler's brackets get a
    full batch, as JAX's Engine.profile rebuilds one."""
    eng = TEngine(graph, LayerConfig(DIMS), cfg_of("gcn", "hyb"), device="cpu")
    assert eng.batch.src.shape[0] == 0
    seen = {}

    def spy(model, params, batch, iters):
        seen["edges"] = batch.src.shape[0]
        seen["edge_val"] = batch.edge_val
        return {"forward_ms": 1.0}

    monkeypatch.setattr(profiling, "profile_stages", spy)
    eng.profile(iters=1)
    assert seen["edges"] == graph.num_edges
    np.testing.assert_allclose(seen["edge_val"].numpy(), graph.edge_norm)
    gat = TEngine(graph, LayerConfig(DIMS), cfg_of("gat", "hyb"), device="cpu")
    gat.profile(iters=1)
    np.testing.assert_array_equal(seen["edge_val"].numpy(), np.ones(graph.num_edges))
    xla = TEngine(graph, LayerConfig(DIMS), cfg_of("gcn", "xla"), device="cpu")
    assert xla.batch.src.shape[0] == graph.num_edges  # not stubbed: used as it is
    xla.profile(iters=1)
    assert seen["edges"] == graph.num_edges


def test_cost_note_after_run(graph):
    """run() fills notes["cost"] with JAX's keys (GPU-seconds under
    `chip_seconds`, at the assumed price per GPU-hour, not the TPU's); no
    "hbm" note on the CPU."""
    eng = TEngine(graph, LayerConfig(DIMS), cfg_of("gcn", "hyb", epochs=3), device="cpu")
    rep = eng.run()
    cost = rep.notes["cost"]
    assert set(cost) == set(jreport_cost(1.0))
    assert cost["chip_seconds"] == round(rep.total_time_s, 2)
    assert cost["price_per_chip_hour_usd"] == profiling.DEFAULT_GPU_USD_PER_HOUR != 1.20
    assert "hbm" not in rep.notes
    c = profiling.report_cost(3600.0, n_gpus=4, price_per_gpu_hour=2.0)
    assert c == {"chip_seconds": 14400.0, "price_per_chip_hour_usd": 2.0,
                 "estimated_cost_usd": 8.0}


def test_report_memory_is_none_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: report_memory() reads it")
    assert profiling.report_memory() is None
    assert profiling.report_memory("cpu") is None


def test_time_ms_on_the_cpu():
    """The host clock around `iters` calls after one untimed call."""
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3)

    assert profiling.time_ms(fn, 4, torch.device("cpu")) > 0
    assert len(calls) == 5


@pytest.mark.parametrize("kernel,plan", [("hyb", "fused"), ("degree", "pair"),
                                         ("xla", "edge_op")])
def test_sharded_profile_returns_jaxs_keys(sharded_runs, graph, kernel, plan):
    """ShardedEngine.profile on 2 gloo ranks, on the plan the engine
    trains on: JAX's key set from ShardedEngine on make_mesh(2), every value
    > 0 and the same on both ranks; run() filled the cost note (2 ranks: 2
    GPUs' seconds)."""
    rows = sharded_runs[kernel]
    assert rows[0]["plan"] == plan
    jeng = JShardedEngine(graph, LayerConfig(DIMS), cfg_of("gcn", kernel), mesh=make_mesh(2))
    want = jeng.profile(iters=1)
    assert set(rows[0]["profile"]) == set(want)
    assert all(v > 0 for v in rows[0]["profile"].values())
    assert rows[0]["profile"] == rows[1]["profile"]
    for r in rows:
        assert set(r["notes"]["cost"]) == set(jreport_cost(1.0))


@pytest.fixture(scope="module")
def sharded_runs(graph):
    kernels = ["hyb", "degree", "xla"]
    # the plan JAX's overlap="auto" resolves to off a TPU, given explicitly
    # (the port's auto is the card's table, parallel/train_step.py AUTO_OVERLAP)
    runs = [(dict(model="gcn", kernel=k, overlap=k != "xla", reuse="off", eval_every=0), 1,
             {"profile": True}) for k in kernels]
    res = spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=180)
    return {k: [res[r][i] for r in range(2)] for i, k in enumerate(kernels)}
