"""One forward per state of the params (engine/engine.py `folds_evals`,
`eager_group`, `run_loop`; engine/graphs.py `EpochGraphs.run_group`):

  * GCN and GAT on hyb, eval every 1 and 2 epochs, run(7) in groups of 3
    and of the auto cap against groups of 1, eagerly and through
    EpochGraphs with the capture stood in for by a graph that reruns its
    body (`_torch_ranks.Rerun`): the per-epoch losses, the evaluated
    epochs' val stats (correct, loss, count) and accuracies, and the final
    val and test accuracies are equal with ==;
  * the counters engine.evals_folded and engine.eval_forwards equal what
    the groups and flags imply: a flagged epoch folds unless it ends its
    group, and the final evals fold where the run's last epoch was
    evaluated; a training step measures val stats only where they are
    read, once for each folded per-epoch eval;
  * staleness 1, bf16 compute and the sharded engine on 2 gloo ranks fold
    no per-epoch eval, only the final evals, and eval_every 0 folds
    nothing and runs one eval forward for both final evals; their records
    equal groups of 1;
  * on the card (marked `gpu`, skips without one): the captured graphs on
    a hyb plan with bf16 gather tables, folded against groups of 1 and
    against the eager loop, bit for bit.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu_torch.common import metrics
from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.engine import graphs
from dorylus_tpu_torch.engine.engine import Engine, eval_masks
from dorylus_tpu_torch.graph.graph import synthetic_graph
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

DIMS = [24, 16, 6]
EPOCHS = 7
FOLDED, FORWARDS = "engine.evals_folded", "engine.eval_forwards"


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(600, 6, 24, 6, seed=71)


def config(model="gcn", epc=1, **kw):
    kw.setdefault("kernel", "hyb")
    return TrainConfig(model=model, epochs=EPOCHS, reuse="off", compile_cache="off",
                       learning_rate=0.005 if model == "gat" else 0.01,
                       epochs_per_call=epc, **kw)


def records(eng, rep, vals) -> dict:
    """The run's records; "forward": the final accuracies from an eval
    forward of their own on the params the run left."""
    forward = tuple(c / max(1.0, n) for c, _, n in eng._stats(eval_masks(eng.batch)).tolist())
    return {"losses": [e.loss for e in rep.epochs],
            "accuracies": [e.accuracy for e in rep.epochs],
            "val_stats": vals, "final": (rep.final_accuracy, rep.test_accuracy),
            "forward": forward,
            "counts": (metrics.counters().get(FOLDED), metrics.counters().get(FORWARDS))}


def run(eng, stand_in=False, graphed=False) -> dict:
    """eng.run(EPOCHS) with its groups' val stats recorded off `_dispatch`,
    and under "measured" how many calls of the training step measured val
    stats: eagerly, through the stand-in graphs, or (graphed) through the
    card's, whose replays call no step (not counted there)."""
    vals, measured, dispatch, step = [], [], eng._dispatch, eng._train_epoch

    def recorded(lrs, flags, window):
        losses, stats = dispatch(lrs, flags, window)
        vals.extend(row for row, f in zip(stats[:, 0].tolist(), flags) if f)
        return losses, stats

    def train_epoch(*args, val=False, **kw):
        loss, st = step(*args, val=val, **kw)
        measured.append(st is not None)
        assert val == measured[-1]
        return loss, st

    eng._dispatch, eng._train_epoch = recorded, train_epoch
    metrics.reset()
    try:
        if stand_in:
            eng._graphs = graphs.EpochGraphs(eng.device)
            with ranks.stand_in_graphs(eng):
                rep = eng.run(EPOCHS)
        else:
            rep = eng.run(EPOCHS, graphs=graphed)
        return {**records(eng, rep, vals), "measured": sum(measured),
                "captures": None if eng._graphs is None else eng._graphs.captures}
    finally:
        metrics.reset()


def implied_counts(sizes, every) -> tuple[int, int]:
    """(folded, forwards) of a folding run in groups of `sizes`: a flagged
    epoch folds unless it ends its group, which runs the eval forward; the
    final evals fold where the last epoch was evaluated, else run one eval
    forward."""
    folded = forwards = 0
    epoch = 0
    for k in sizes:
        for ep in range(epoch, epoch + k):
            if every and (ep % every == 0 or ep == EPOCHS - 1):
                if ep == epoch + k - 1:
                    forwards += 1
                else:
                    folded += 1
        epoch += k
    return (folded + 2, forwards) if every else (0, 1)


GROUPS = {1: [1] * EPOCHS, 3: [3, 3, 1], 0: [EPOCHS]}


@pytest.mark.parametrize("stand_in", [False, True], ids=["eager", "stand_in_graphs"])
@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_folded_runs_equal_groups_of_one(graph, model, every, stand_in):
    base = run(Engine(graph, LayerConfig(DIMS), config(model, 1, eval_every=every),
                      device="cpu"), stand_in)
    assert base["counts"] == implied_counts(GROUPS[1], every)
    assert len(base["val_stats"]) == sum(a is not None for a in base["accuracies"]) > 0
    for epc in (3, 0):
        got = run(Engine(graph, LayerConfig(DIMS), config(model, epc, eval_every=every),
                         device="cpu"), stand_in)
        for key in ("losses", "accuracies", "val_stats", "final"):
            assert got[key] == base[key], (epc, key)
        assert got["final"] == got["forward"]
        assert got["counts"] == implied_counts(GROUPS[epc], every), epc
        assert got["counts"][0] > base["counts"][0]
        assert got["measured"] == got["counts"][0] - 2, epc
        # both train graphs and the eval, all in the first group
        assert got["captures"] == base["captures"] == (3 if stand_in else None)


@pytest.mark.parametrize("case", ["staleness 1", "bf16 compute", "eval_every 0"])
def test_what_folds_nothing(graph, case):
    """No per-epoch eval folds and no training step measures val stats;
    the final evals read the run's last eval where there is one (with
    eval_every 0 one eval forward serves both); the records equal groups
    of 1."""
    kw = {"staleness 1": dict(staleness=1, eval_every=1),
          "bf16 compute": dict(compute_dtype="bfloat16", eval_every=1),
          "eval_every 0": dict(eval_every=0)}[case]
    got = [run(Engine(graph, LayerConfig(DIMS), config("gcn", epc, **kw), device="cpu"))
           for epc in (1, 3)]
    for rec in got:
        evals = sum(a is not None for a in rec["accuracies"])
        assert rec["counts"] == ((2, evals) if evals else (0, 1))
        assert rec["measured"] == 0
        assert rec["final"] == rec["forward"]
    for key in ("losses", "accuracies", "val_stats", "final"):
        assert got[1][key] == got[0][key], key


def sharded_rank(rank, world, device, graph):
    """The sharded engine's records and counters in groups of 1 and of 3."""
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    torch.set_num_threads(1)
    out = []
    for epc in (1, 3):
        eng = ShardedEngine(graph, LayerConfig(DIMS), config("gcn", epc, eval_every=1),
                            device=device)
        out.append(run(eng))
    return out


def test_sharded_engine_folds_nothing(graph):
    """No per-epoch eval folds; the final evals read the last eval."""
    res = spawn_local(2, sharded_rank, (graph,), backend="gloo", device="cpu",
                      timeout_s=120)
    for one, three in res:
        assert one["counts"] == three["counts"] == (2, EPOCHS)
        assert one["measured"] == three["measured"] == 0
        assert one["final"] == one["forward"] and three["final"] == three["forward"]
        for key in ("losses", "accuracies", "val_stats", "final"):
            assert three[key] == one[key], key
    assert res[0][1]["losses"] == res[1][1]["losses"]


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_captured_graphs_fold_bit_for_bit(model):
    """The card's captured train and eval graphs, eval every epoch, in
    groups of the auto cap against groups of 1 and against the eager loop
    in groups of the auto cap: equal records; the folded runs count what
    their groups imply."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graphs and the kernels run there")
    g = synthetic_graph(3000, 12, 24, 6, seed=5)

    def engine(epc):
        cfg = config(model, epc, eval_every=1, agg_dtype="bfloat16")
        eng = Engine(g, LayerConfig(DIMS), cfg, device="cuda")
        assert eng.kernel_selected == "hyb"
        return eng

    base = run(engine(1), graphed=True)
    folded = run(engine(0), graphed=True)
    eager = run(engine(0), graphed=False)
    for key in ("losses", "accuracies", "val_stats", "final"):
        assert folded[key] == base[key], key
        assert eager[key] == base[key], key
    assert folded["final"] == folded["forward"]
    assert folded["counts"] == eager["counts"] == implied_counts(GROUPS[0], 1)
    assert folded["captures"] == base["captures"] == 3
    assert np.isfinite(folded["losses"]).all()
