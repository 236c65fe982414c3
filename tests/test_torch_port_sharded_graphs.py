"""The sharded engine's epoch groups through the CUDA-graph path
(engine/graphs.py `EpochGraphs`, parallel/train_step.py `ShardedEngine`)
and the graphs' lifetime in both engines, on the CPU, with the capture
stood in for by a graph that reruns its body (`_torch_ranks.Rerun`):

  * (a) 2 gloo ranks through EpochGraphs, GCN and GAT at staleness 0 and
    1, groups of 3 with eval every 2 and the converge switch dropping the
    window: losses, accuracies, params and Adam's state equal the eager
    ranks' bit for bit, and JAX's `ShardedEngine` on `make_mesh(2)`;
  * (b) the host-read guard: while the stand-in's train and eval bodies
    run, Tensor.item, .tolist, .numpy, bool(), float(), int() and
    torch.cuda.synchronize raise; on the fused and the combined hyb plans,
    the degree pair, the edgewise split, reuse="pairs" and 1 graph x 2
    feat shards. The multi-rank body reads nothing on the host, which is
    what a capture over NCCL asks;
  * (c) the graphs' lifetime: two run()s of one engine (both engines)
    capture once and equal two eager run()s bit for bit; new Adam tensors
    or a param's new storage between the runs, or a run(graphs=False),
    lead to a new capture, still bit for bit; two run()s of JAX's Engine
    give the same losses;
  * (d) the rule that decides whether an engine captures: with no group
    and under NCCL it captures, under gloo it runs eagerly and its
    construction log says why, on the CPU always eagerly.

Tolerances (PERF.md section 2): GCN losses atol 1e-4, GAT rtol 1e-5;
accuracies over the same rows atol 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import engine as jengine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.common.config import LayerConfig as TLayerConfig
from dorylus_tpu_torch.common.config import TrainConfig as TTrainConfig
from dorylus_tpu_torch.engine import engine as tengine
from dorylus_tpu_torch.parallel import multihost, train_step
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >=2 devices (virtual CPU mesh)")

DIMS = [24, 16, 6]
# the converge switch at epoch 4 on this graph (val accuracy 0.495 / 0.12)
SWITCH = {"gcn": 0.4, "gat": 0.119}


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(2000, 6, 24, 6, seed=71)


def cfg(model="gcn", **kw):
    kw.setdefault("kernel", "hyb")
    kw.setdefault("reuse", "off")
    return dict(model=model, compile_cache="off",
                learning_rate=0.005 if model == "gat" else 0.01, **kw)


def losses_close(got, want, model):
    if model == "gcn":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def same_state(a, b):
    """Two rank results: the same params and Adam state, bit for bit."""
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    assert a["adam"][0] == b["adam"][0]
    for i in (1, 2):
        for k in a["adam"][i]:
            np.testing.assert_array_equal(a["adam"][i][k], b["adam"][i][k])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_two_ranks_through_the_graphs_equal_eager_and_jax(graph, model):
    """(a) Staleness 0 and 1, groups of 3 with eval every 2, the converge
    switch at epoch 4: the stood-in graph ranks against the eager ranks
    (bit for bit) and JAX's ShardedEngine on a 2-device mesh."""
    kws = [cfg(model, eval_every=2, epochs_per_call=3, staleness=s, target_accuracy=0.99,
               switch_threshold=SWITCH[model]) for s in (0, 1)]
    runs = [(kw, 6, opts) for kw in kws for opts in ({"graphs": True}, {})]

    def jax_runs():
        return [JShardedEngine(graph, LayerConfig(DIMS), TrainConfig(epochs=6, **kw),
                               mesh=make_mesh(2)).run() for kw in kws]

    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_runs)
        res = spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                          device="cpu", timeout_s=240)
        jreps = jax_run.result()
    for r in range(2):
        for s, jrep in enumerate(jreps):
            graphed, eager = res[r][2 * s], res[r][2 * s + 1]
            assert graphed["runs"][0]["graphed"] and not eager["runs"][0]["graphed"]
            # one train graph (two at S = 1: with and without the window) and eval
            assert graphed["runs"][0]["captures"] == (3 if s else 2)
            assert graphed["losses"] == eager["losses"]
            assert graphed["accuracies"] == eager["accuracies"]
            assert (graphed["val_acc"], graphed["test_acc"]) == (eager["val_acc"],
                                                                 eager["test_acc"])
            assert graphed["notes"]["converge_state"] == "CLOSE"
            same_state(graphed, eager)
            assert graphed["adam"][0] == 6
            losses_close(graphed["losses"], [e.loss for e in jrep.epochs], model)
            assert [a is None for a in graphed["accuracies"]] == [e.accuracy is None
                                                                 for e in jrep.epochs]
            np.testing.assert_allclose([graphed["val_acc"], graphed["test_acc"]],
                                       [jrep.final_accuracy, jrep.test_accuracy],
                                       rtol=0, atol=1e-6)
    assert res[0][0]["losses"] == res[1][0]["losses"]


# (b)'s sharded plans: (label, cfg, the plan the model runs)
GUARDED = [
    ("hyb fused gcn", cfg("gcn", staleness=1), "fused"),
    ("hyb fused gat", cfg("gat"), "fused"),
    ("hyb combined", cfg("gcn", overlap="off"), "ShardedHybSpMM"),
    ("degree pair", cfg("gcn", kernel="degree", staleness=1), "pair"),
    ("edgewise split", cfg("gcn", kernel="xla", overlap="on"), "edge_split"),
    ("reuse pairs", cfg("gcn", reuse="pairs", reuse_max_pairs=0), "ShardedReuseSpMM"),
    ("tp 1x2", cfg("gcn", kernel="xla", feat_shards=2, num_shards=1), "edge_op"),
]


@pytest.fixture(scope="module")
def guarded(graph):
    """Each of GUARDED through the stood-in graphs with host reads refused
    in their bodies, and eagerly; then GCN on the combined plan with the
    capture decided as on the card over gloo: one launch of 2 ranks."""
    runs = []
    for _, kw, _ in GUARDED:
        kw = dict(kw, eval_every=2, epochs_per_call=2)
        runs += [(kw, 4, {"graphs": True, "guard": True}), (kw, 4, {})]
    runs.append((cfg("gcn", overlap="off", eval_every=2), 2, {"as_card": "gloo"}))
    return spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                       device="cpu", timeout_s=240)


@pytest.mark.parametrize("case", range(len(GUARDED)), ids=[g[0] for g in GUARDED])
def test_no_host_read_inside_the_sharded_bodies(guarded, case):
    """(b) The train and eval bodies of every sharded plan, replayed under
    the host-read guard, equal the eager ranks bit for bit."""
    label, kw, plan = GUARDED[case]
    for r in range(2):
        graphed, eager = guarded[r][2 * case], guarded[r][2 * case + 1]
        assert graphed["plan"] == eager["plan"] == plan
        assert graphed["runs"][0]["graphed"] and graphed["runs"][0]["captures"] >= 2
        assert graphed["losses"] == eager["losses"] and np.all(np.isfinite(eager["losses"]))
        assert graphed["accuracies"] == eager["accuracies"]
        same_state(graphed, eager)
    if "feat_shards" in kw:
        assert guarded[0][2 * case]["mesh"] == (1, 2, 0, 0)
        assert guarded[1][2 * case]["mesh"] == (1, 2, 0, 1)


def test_the_guard_refuses_host_reads():
    """The guard itself: each refused call raises inside it and works
    after it."""
    t = torch.ones(2)
    with ranks.host_reads_refused():
        for read in (lambda: t[0].item(), t.tolist, t.numpy, lambda: bool(t[0]),
                     lambda: float(t[0]), lambda: int(t[0]), torch.cuda.synchronize):
            with pytest.raises(ranks.HostRead):
                read()
        assert torch.equal(t + t, 2 * t)
    assert t[0].item() == 1.0 and bool(t[0]) and t.tolist() == [1.0, 1.0]


def test_gloo_runs_eagerly_and_says_so(guarded):
    """(d) Under gloo, decided as on the card, the engine runs eagerly and
    its construction log line says why."""
    for r in range(2):
        got = guarded[r][-1]
        assert "gloo" in got["graph_refusal"] and not got["runs"][0]["graphed"]
        line = next(m for m in got["logs"] if m.startswith("dorylus_tpu_torch sharded engine"))
        assert line.endswith(f"epochs eager ({got['graph_refusal']})")


def test_the_capture_rule():
    """(d) The predicate and the rule, by the names alone: without a
    process group and under NCCL the collectives can be captured, under
    gloo not; on the CPU no engine captures."""
    assert multihost.collectives_capturable("none") and multihost.collectives_capturable()
    assert multihost.collectives_capturable("nccl")
    assert not multihost.collectives_capturable("gloo")
    card = torch.device("cuda")
    assert tengine.epoch_graph_refusal(card, "none") is None
    assert tengine.epoch_graph_refusal(card, "nccl") is None
    assert "gloo" in tengine.epoch_graph_refusal(card, "gloo")
    for backend in ("none", "nccl", "gloo"):
        assert "CPU" in tengine.epoch_graph_refusal(torch.device("cpu"), backend)


def engine(graph, kind, **kw):
    c = TTrainConfig(**kw)
    if kind == "sharded":
        return train_step.ShardedEngine(graph, TLayerConfig(DIMS), c, device="cpu")
    return tengine.Engine(graph, TLayerConfig(DIMS), c, device="cpu")


@pytest.mark.parametrize("backend", ["none", "nccl"])
def test_no_group_and_nccl_capture(graph, monkeypatch, backend):
    """(d) With no process group, and with NCCL's name stubbed in, the
    engine built as on the card captures (the stood-in graphs) and equals
    the eager engine bit for bit; on the CPU itself it runs eagerly and
    its log says so."""
    kw = cfg("gcn", epochs=4, eval_every=2, epochs_per_call=2)
    lines = []
    monkeypatch.setattr(train_step, "log", lambda msg, *a: lines.append(msg % a))
    eager = engine(graph, "sharded", **kw)
    assert eager.graph_refusal == "the CPU has no CUDA graphs"
    assert lines[-1].endswith("epochs eager (the CPU has no CUDA graphs)")
    real = train_step.epoch_graph_refusal
    monkeypatch.setattr(train_step, "epoch_graph_refusal",
                        lambda dev, be: real(torch.device("cuda"), be))
    if backend == "nccl":
        monkeypatch.setattr(multihost, "backend_name", lambda: "nccl")
    eng = engine(graph, "sharded", **kw)
    assert eng.graph_refusal is None
    assert lines[-1].endswith("epochs replayed as CUDA graphs")
    made = ranks.Rerun.made
    with ranks.stand_in_graphs(eng):
        rg = eng.run()
    re_ = eager.run()
    assert eng._graphs is not None and eager._graphs is None
    assert ranks.Rerun.made - made == 2
    assert [e.loss for e in rg.epochs] == [e.loss for e in re_.epochs]
    assert all(torch.equal(p, eager.params[k]) for k, p in eng.params.items())


LIFETIME = [None, "adam", "param", "eager"]


@pytest.mark.parametrize("between", LIFETIME)
@pytest.mark.parametrize("kind", ["engine", "sharded"])
def test_graphs_live_as_long_as_the_engine(graph, kind, between):
    """(c) Two run()s of one engine through the stood-in graphs (GCN at
    S = 1, groups of 3, eval every 2): nothing between them, new Adam
    tensors, each param's new storage, or a run(graphs=False) in between.
    The second run captures nothing where nothing was replaced, and again
    otherwise; every run equals the eager engine's bit for bit."""
    kw = cfg("gcn", epochs=5, eval_every=2, epochs_per_call=3, staleness=1)
    eng, eager = engine(graph, kind, **kw), engine(graph, kind, **kw)
    eng.graph_refusal = None  # as on the card: the epochs are captured
    made = ranks.Rerun.made
    reps, counts = [], []
    with ranks.stand_in_graphs(eng):
        reps.append(eng.run())
        counts.append(ranks.Rerun.made - made)
        kept = eng._graphs
        if between == "eager":
            reps.append(eng.run(graphs=False))
            assert eng._graphs is None
        elif between is not None:
            ranks.rebind(eng, between)
        reps.append(eng.run())
        counts.append(ranks.Rerun.made - made)
    for _ in reps:
        want = eager.run(graphs=False)
    # a report gathers every run's records
    assert len(eng.report.epochs) == 5 * len(reps)
    assert [e.loss for e in eng.report.epochs] == [e.loss for e in want.epochs]
    assert [e.accuracy for e in eng.report.epochs] == [e.accuracy for e in want.epochs]
    assert eng.report.final_accuracy == want.final_accuracy
    for k, p in eng.params.items():
        assert torch.equal(p, eager.params[k])
        assert torch.equal(eng.opt_state.m[k], eager.opt_state.m[k])
        assert torch.equal(eng.opt_state.v[k], eager.opt_state.v[k])
    assert eng.opt_state.step == eager.opt_state.step
    # the first run: the train graph with the window, and eval
    assert counts[0] == 2
    if between is None:
        assert counts[1] == 2 and eng._graphs is kept
    elif between == "eager":
        assert counts[1] == 4 and eng._graphs is not kept
    else:  # the train graph holds Adam's state and the params; eval the params
        assert counts[1] == (3 if between == "adam" else 4) and eng._graphs is kept


def test_second_run_matches_jax(graph):
    """(c) Two run()s of JAX's Engine and of the port's engine through the
    stood-in graphs: the same losses, the second run starting again at
    epoch 0 with Adam's step carried on."""
    kw = cfg("gcn", epochs=4, eval_every=2, epochs_per_call=2, staleness=1)
    jeng = jengine.Engine(graph, LayerConfig(DIMS), TrainConfig(**kw))
    jl = [[e.loss for e in jeng.run().epochs] for _ in range(2)]
    eng = engine(graph, "engine", **kw)
    eng.graph_refusal = None
    with ranks.stand_in_graphs(eng):
        first = [e.loss for e in eng.run().epochs]
        both = eng.run().epochs
    assert [e.epoch for e in both] == [0, 1, 2, 3] * 2
    losses_close(first, jl[0][:4], "gcn")
    losses_close([e.loss for e in both][4:], jl[1][4:], "gcn")
