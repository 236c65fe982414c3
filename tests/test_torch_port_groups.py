"""The port's epoch groups (engine/engine.py `group_len`, `run_loop`,
`eager_group`; engine/graphs.py `EpochGraphs`) against the JAX package's
compiled groups (dorylus_tpu/engine/engine.py `group_len`, `eval_flags`,
`run_group_loop`), on the CPU:

  * `group_len` and `eval_flags` equal JAX's over a grid of epochs, ends,
    epochs_per_call (0, 1, 3, 7), eval cadences, target accuracies and
    checkpoint cadences (num_edges=0: JAX's edge budget, not ported, does
    not bind);
  * `Engine.run` with epochs_per_call 1, 3 and 0 at staleness 0 and 1
    equals the JAX `Engine` with the same setting: per-epoch losses, the
    evaluated epochs and their accuracies, the final accuracies; with
    checkpoints and a resume (the steps JAX writes); with a target accuracy
    (both stop at the same epoch); the sharded engine on 2 gloo ranks with
    epochs_per_call=3 against JAX's `ShardedEngine`;
  * Adam and SGD with the rate as a 0-dim tensor equal the float form bit
    for bit; `StaleWindow`'s ring equals JAX's stack roll and the list
    rotation it replaced over 5 rolls;
  * `EpochGraphs`' bookkeeping (the eager first epoch, the capture that
    steps nothing, the rate written before each replay, the step counter)
    with the capture stood in for by a graph that reruns its body: bit for
    bit against the eager loop; the launch counts a capture takes back and
    each replay adds.

Tolerances (PERF.md section 2): GCN losses atol 1e-4 (1e-3 with bf16
gather tables), GAT rtol 1e-5; accuracies, counts of rows over the same
rows, atol 1e-6, and 0.01 (2 of the 200 validation rows) with bf16 gather
tables, whose rounding of 1e-3 in the logits moves an argmax where the top
two classes are that close.
"""

import contextlib
import itertools
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import engine as jengine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.common.config import TrainConfig as TTrainConfig
from dorylus_tpu_torch.engine import engine as tengine
from dorylus_tpu_torch.engine import graphs
from dorylus_tpu_torch.ops import hyb_spmm
from dorylus_tpu_torch.optim.adam import adam_init, adam_lr_t, adam_update, sgd_update
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

DIMS = [24, 16, 6]


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(2000, 6, 24, 6, seed=71)


def cfg(model="gcn", epochs=7, **kw):
    kw.setdefault("kernel", "xla")
    return dict(model=model, epochs=epochs, reuse="off", compile_cache="off",
                learning_rate=0.005 if model == "gat" else 0.01, **kw)


def both(graph, **kw):
    """The JAX Engine's and the port's report for one configuration."""
    j = jengine.Engine(graph, LayerConfig(DIMS), TrainConfig(**kw)).run()
    t = tengine.Engine(graph, LayerConfig(DIMS), TTrainConfig(**kw), device="cpu").run()
    return j, t


def same_records(t, j, model="gcn", narrow=False):
    assert [e.epoch for e in t.epochs] == [e.epoch for e in j.epochs]
    tl, jl = ([e.loss for e in r.epochs] for r in (t, j))
    if model == "gcn":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3 if narrow else 1e-4)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert [e.accuracy is None for e in t.epochs] == [e.accuracy is None for e in j.epochs]
    acc_tol = 0.01 if narrow else 1e-6
    np.testing.assert_allclose([e.accuracy for e in t.epochs if e.accuracy is not None],
                               [e.accuracy for e in j.epochs if e.accuracy is not None],
                               rtol=0, atol=acc_tol)
    np.testing.assert_allclose([t.final_accuracy, t.test_accuracy],
                               [j.final_accuracy, j.test_accuracy], rtol=0, atol=acc_tol)


def group_sizes(rep):
    """The groups' sizes, read from the records: a group's epochs share its
    mean time."""
    return [len(list(g)) for _, g in itertools.groupby(e.time_ms for e in rep.epochs)]


@pytest.mark.parametrize("epc", [0, 1, 3, 7])
def test_group_len_and_eval_flags_match_jax(epc):
    assert tengine.AUTO_GROUP_CAP == jengine.AUTO_GROUP_CAP
    for every, target, ck_every in itertools.product((0, 1, 2, 5), (None, 0.9), (0, 3, 4)):
        kw = dict(epochs_per_call=epc, eval_every=every, target_accuracy=target,
                  checkpoint_every=ck_every, checkpoint_dir="ck" if ck_every else None)
        jc, tc = TrainConfig(**kw), TTrainConfig(**kw)
        for epoch, n in itertools.product(range(0, 40, 3), (0, 1, 2, 7, 30)):
            end = epoch + n
            k = tengine.group_len(epoch, end, tc)
            assert k == jengine.group_len(epoch, end, jc, 0), (kw, epoch, end)
            np.testing.assert_array_equal(tengine.eval_flags(epoch, k, end, tc),
                                          jengine.eval_flags(epoch, k, end, jc))


@pytest.mark.parametrize("stale", [0, 1])
@pytest.mark.parametrize("epc", [1, 3, 0])
def test_grouped_run_matches_jax(graph, epc, stale):
    """GCN on xla in f32; GAT at epochs_per_call 3 and staleness 1; GCN on
    hyb with bf16 gather tables at epochs_per_call 0 and staleness 1."""
    model = "gat" if (epc, stale) == (3, 1) else "gcn"
    narrow = (epc, stale) == (0, 1)
    kw = dict(kernel="hyb", agg_dtype="bfloat16") if narrow else {}
    j, t = both(graph, **cfg(model, epochs=5, eval_every=2, epochs_per_call=epc,
                             staleness=stale, **kw))
    same_records(t, j, model, narrow)
    assert group_sizes(t) == {1: [1] * 5, 3: [3, 2], 0: [5]}[epc]


def test_grouped_checkpoints_and_resume_match_jax(graph, tmp_path):
    """Checkpoints every 3 epochs cut the groups; both packages write steps
    3 and 6; a resume of 3 more epochs carries on from step 6, the same
    records, and both write step 9."""
    reps = {}
    for who in ("j", "t"):
        d = str(tmp_path / who)
        first = cfg(epochs=6, eval_every=2, checkpoint_dir=d, checkpoint_every=3,
                    staleness=1)
        then = dict(first, epochs=3, resume=True)
        if who == "j":
            reps[who] = [jengine.Engine(graph, LayerConfig(DIMS), TrainConfig(**c)).run()
                         for c in (first, then)]
        else:
            reps[who] = [tengine.Engine(graph, LayerConfig(DIMS), TTrainConfig(**c),
                                        device="cpu").run() for c in (first, then)]
    for t, j in zip(reps["t"], reps["j"]):
        same_records(t, j)
    assert group_sizes(reps["t"][0]) == [3, 3]
    assert [e.epoch for e in reps["t"][1].epochs] == [6, 7, 8]
    assert group_sizes(reps["t"][1]) == [3]
    names = [sorted(p.name for p in (tmp_path / w).iterdir()) for w in ("j", "t")]
    assert names[0] == names[1] == ["LATEST", "ckpt_00000003.npz", "ckpt_00000006.npz",
                                    "ckpt_00000009.npz"]


def test_target_accuracy_stops_at_the_jax_epoch(graph, capsys):
    """A target accuracy reached mid-run: groups end at every eval epoch,
    and both packages stop after the same epoch."""
    kw = cfg(epochs=30, eval_every=2, target_accuracy=0.5, epochs_per_call=0)
    j, t = both(graph, **kw)
    assert len(t.epochs) < 30 and t.notes["converge_state"] == "DONE"
    same_records(t, j)
    assert group_sizes(t)[:3] == [1, 2, 2]


def test_sharded_groups_match_jax(graph):
    """2 gloo ranks in groups of 3 (eval every 2 epochs, staleness 1)
    against JAX's ShardedEngine on a 2-device mesh (run in a thread while
    the ranks run)."""
    kw = cfg("gcn", eval_every=2, epochs_per_call=3, staleness=1)
    epochs = kw.pop("epochs")
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(lambda: JShardedEngine(
            graph, LayerConfig(DIMS), TrainConfig(epochs=epochs, **kw),
            mesh=make_mesh(2)).run())
        res = spawn_local(2, ranks.engine_rank, (graph, DIMS, kw, epochs, {}),
                          backend="gloo", device="cpu", timeout_s=120)
        jrep = jax_run.result()
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], [e.loss for e in jrep.epochs],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose([res[0]["val_acc"], res[0]["test_acc"]],
                               [jrep.final_accuracy, jrep.test_accuracy], rtol=0, atol=1e-6)
    assert [a is None for a in res[0]["accuracies"]] == [e.accuracy is None
                                                        for e in jrep.epochs]
    assert [len(list(g)) for _, g in itertools.groupby(res[0]["times"])] == [3, 3, 1]


def _params(seed, shapes=((7, 5), (5,), (3, 4))):
    rng = np.random.default_rng(seed)
    return {f"p{i}": torch.tensor(rng.normal(size=s).astype(np.float32))
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("decay", [0.0, 0.01])
def test_tensor_rate_equals_float_rate(decay):
    """Adam with lr_t as a 0-dim f32 tensor (what a captured epoch reads)
    equals the float form bit for bit over 5 steps with a decaying lr; SGD
    likewise."""
    pa, pb = _params(1), _params(1)
    sa, sb = adam_init(pa), adam_init(pb)
    rate = torch.zeros(())
    for step in range(5):
        grads = _params(10 + step)
        lr = 0.01 * 0.7 ** (step // 2)
        pa, sa = adam_update(pa, grads, sa, lr=lr, weight_decay=decay)
        rate.fill_(adam_lr_t(lr, sb.step + 1))
        pb, sb = adam_update(pb, grads, sb, lr=None, weight_decay=decay, lr_t=rate)
        assert sa.step == sb.step == step + 1
        for k in pa:
            assert torch.equal(pa[k], pb[k]) and torch.equal(sa.m[k], sb.m[k])
            assert torch.equal(sa.v[k], sb.v[k])
        qa, qb = _params(20 + step), _params(20 + step)
        rate.fill_(lr)
        sgd_update(qa, grads, lr)
        sgd_update(qb, grads, rate)
        assert all(torch.equal(qa[k], qb[k]) for k in qa)


def test_ring_stash_equals_jax_roll_and_rotation():
    """StaleWindow at S = 2 over 5 rolls: its copies equal JAX's stacked
    history rolled by concatenate([hi[1:], p[None]]) and the list rotation
    (drop the oldest, append the params) that it replaced; the copies keep
    their storage."""
    params = _params(3)
    win = tengine.StaleWindow(params, 2)
    ptrs = [[t.data_ptr() for t in c.values()] for c in win.copies]
    hist = {k: jnp.tile(jnp.asarray(p.numpy())[None], (3,) + (1,) * p.dim())
            for k, p in params.items()}
    rotation = [{k: p.clone() for k, p in params.items()} for _ in range(3)]
    for step in range(5):
        params = _params(30 + step)
        win.roll(params)
        hist = {k: jnp.concatenate([h[1:], jnp.asarray(params[k].numpy())[None]])
                for k, h in hist.items()}
        rotation = rotation[1:] + [{k: p.clone() for k, p in params.items()}]
        for i, copy in enumerate(win.copies):
            for k, t in copy.items():
                np.testing.assert_array_equal(t.detach().numpy(), np.asarray(hist[k][i]))
                assert torch.equal(t.detach(), rotation[i][k])
    assert ptrs == [[t.data_ptr() for t in c.values()] for c in win.copies]


# the capture stood in for: a replay reruns the body
_Rerun = ranks.Rerun


@pytest.mark.parametrize("stale", [0, 1])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_epoch_graphs_bookkeeping_bit_for_bit(graph, monkeypatch, model, stale):
    """EpochGraphs driven by the group loop (groups of 3 and eval every 2
    epochs, the converge switch dropping the window at S = 1) with the
    capture stood in for: losses, accuracies, params, Adam's state and
    step equal the eager loop's bit for bit."""
    monkeypatch.setattr(graphs, "_Graph", _Rerun)
    monkeypatch.setattr(graphs.EpochGraphs, "_eager", lambda self, fn: fn())
    # the switch at epoch 4 (val accuracy 0.495 / 0.12 there); groups
    # [0], [1, 2], [3, 4], [5]
    kw = cfg(model, epochs=6, kernel="hyb", eval_every=2, epochs_per_call=3,
             staleness=stale, target_accuracy=0.99,
             switch_threshold={"gcn": 0.4, "gat": 0.119}[model])
    engines = [tengine.Engine(graph, LayerConfig(DIMS), TTrainConfig(**kw), device="cpu")
               for _ in range(2)]
    reps = []
    monkeypatch.setattr(_Rerun, "eng", engines[1])
    for eng, use in zip(engines, (False, True)):
        eng._graphs = graphs.EpochGraphs(eng.device) if use else None
        reps.append(tengine.run_loop(eng, 6))
    eager, replayed = reps
    assert [e.loss for e in replayed.epochs] == [e.loss for e in eager.epochs]
    assert [e.accuracy for e in replayed.epochs] == [e.accuracy for e in eager.epochs]
    g = engines[1]._graphs
    assert set(g.train) == {False, bool(stale)} and g.eval is not None
    assert eager.notes["converge_state"] == replayed.notes["converge_state"] == "CLOSE"
    for k, p in engines[0].params.items():
        assert torch.equal(p, engines[1].params[k])
        assert torch.equal(engines[0].opt_state.m[k], engines[1].opt_state.m[k])
    assert engines[0].opt_state.step == engines[1].opt_state.step == 6


def test_capture_counts_are_added_per_replay(monkeypatch):
    """A graph's capture leaves the launch counters where they were and
    every replay adds what the capture counted, module counters and the
    callers' tallies alike."""

    class Recorded:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Recorded)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(hyb_spmm, "KERNEL_LAUNCHES", 5)
    tally = {"K1 64": 1}
    monkeypatch.setattr(graphs, "LAUNCH_TALLIES", [tally])

    def body():
        hyb_spmm.KERNEL_LAUNCHES += 2
        tally["K1 64"] += 2
        tally["K1 32"] = 1
        return torch.ones(())

    g = graphs._Graph(body)
    assert hyb_spmm.KERNEL_LAUNCHES == 5 and tally == {"K1 64": 1}
    for n in (1, 2, 3):
        assert g.replay() == 1
        assert hyb_spmm.KERNEL_LAUNCHES == 5 + 2 * n
        assert tally == {"K1 64": 1 + 2 * n, "K1 32": n}
