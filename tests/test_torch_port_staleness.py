"""Bounded staleness in both port engines (engine/engine.py `StaleWindow`,
`run_loop`) against the JAX engines' weight-stash window, on the CPU:

  * loss trajectories at S = 1 and 2, GCN and GAT, on hyb and xla, against
    the JAX `Engine`; with bf16 compute (the cast of the stale weights)
    against JAX at its bf16 tolerance;
  * the same on 2 gloo ranks against the JAX `ShardedEngine` on a 2-device
    mesh (the stale forward through the halo exchange and its reverse);
  * S = 0 is synchronous training, bit for bit;
  * the converge monitor turns the run synchronous at the epoch JAX's does,
    on one device and on 2 ranks;
  * S = 1 with a resume: the window restarts at the loaded params, as in
    JAX.

Tolerances: f32 losses GCN atol 1e-4, GAT rtol 1e-5; bf16 compute GCN atol
2e-3, GAT rtol 5e-3 (PERF.md section 2).
"""

import re

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.engine import Engine as JEngine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

DIMS = [16, 8, 4]


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(260, 6, 16, 4, seed=53)


def cfg(model, epochs=6, **kw):
    kw.setdefault("kernel", "hyb")
    return TrainConfig(model=model, epochs=epochs, eval_every=0, reuse="off",
                       learning_rate=0.005 if model == "gat" else 0.01,
                       compile_cache="off", **kw)


def losses(rep):
    return np.array([e.loss for e in rep.epochs])


def loss_close(got, ref, model, narrow=False):
    if model == "gcn":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 if narrow else 1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=5e-3 if narrow else 1e-5, atol=0)


@pytest.mark.parametrize("stale", [1, 2])
@pytest.mark.parametrize("kernel", ["hyb", "xla"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_staleness_matches_jax(graph, model, kernel, stale):
    c = cfg(model, staleness=stale, kernel=kernel)
    jl = losses(JEngine(graph, LayerConfig(DIMS), c).run())
    tl = losses(TEngine(graph, LayerConfig(DIMS), c, device="cpu").run())
    loss_close(tl, jl, model)
    # the first S+1 epochs take their gradients at the starting params, so
    # epochs 1..S differ from synchronous training
    sync = losses(TEngine(graph, LayerConfig(DIMS), cfg(model, kernel=kernel),
                          device="cpu").run())
    assert tl[0] == sync[0] and abs(tl[2] - sync[2]) > 1e-6


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_staleness_with_bf16_compute_matches_jax(graph, model):
    """The stale copy goes through the models' bf16 casts (GCN's weights,
    GAT's weights and attention vectors) and bf16 gather tables."""
    c = cfg(model, staleness=2, compute_dtype="bfloat16", agg_dtype="bfloat16")
    jl = losses(JEngine(graph, LayerConfig(DIMS), c).run())
    tl = losses(TEngine(graph, LayerConfig(DIMS), c, device="cpu").run())
    loss_close(tl, jl, model, narrow=True)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_staleness_zero_is_synchronous(graph, model):
    """staleness=0 and None run the same code: the same losses and
    params, bit for bit."""
    engines = [TEngine(graph, LayerConfig(DIMS), cfg(model, epochs=4, staleness=s),
                       device="cpu") for s in (None, 0)]
    reps = [e.run() for e in engines]
    assert list(losses(reps[0])) == list(losses(reps[1]))
    for k, p in engines[0].params.items():
        assert torch.equal(p, engines[1].params[k])


def test_negative_staleness_is_refused(graph):
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    for make in (TEngine, ShardedEngine):
        with pytest.raises(ValueError, match="staleness=-1"):
            make(graph, LayerConfig(DIMS), cfg("gcn", staleness=-1), device="cpu")


def _switch_epoch(text):
    found = re.findall(r"Converge state CLOSE at epoch (\d+) — switching to sync", text)
    return [int(x) for x in found]


# switch thresholds each model's val accuracy crosses after a few epochs
SWITCH = {"gcn": 0.5, "gat": 0.25}


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_converge_switch_at_the_jax_epoch(graph, model, capsys):
    """With a target accuracy the monitor drops the window once val
    accuracy crosses switch_threshold * target: the same epoch as JAX,
    the same losses before and after, no early stop (target 1.01)."""
    c = TrainConfig(model=model, epochs=12, eval_every=1, kernel="hyb", reuse="off",
                    learning_rate=0.005 if model == "gat" else 0.01, staleness=2,
                    target_accuracy=1.01, switch_threshold=SWITCH[model],
                    compile_cache="off")
    jrep = JEngine(graph, LayerConfig(DIMS), c).run()
    jswitch = _switch_epoch(capsys.readouterr().err)
    trep = TEngine(graph, LayerConfig(DIMS), c, device="cpu").run()
    tswitch = _switch_epoch(capsys.readouterr().err)
    assert len(jswitch) == 1 and 0 < jswitch[0] < 11, jswitch
    assert tswitch == jswitch
    assert trep.notes["converge_state"] == jrep.notes["converge_state"] == "CLOSE"
    loss_close(losses(trep), losses(jrep), model)


def test_staleness_with_resume_matches_jax(graph, tmp_path):
    """S=1, 3 epochs with a checkpoint, then 3 resumed: the resumed run
    takes epoch 3's gradient at the loaded params (a fresh window), in both
    packages; it is not the uninterrupted S=1 run."""
    layers = LayerConfig(DIMS)
    out = {}
    for name, make in (("jax", lambda c: JEngine(graph, layers, c)),
                       ("port", lambda c: TEngine(graph, layers, c, device="cpu"))):
        d = str(tmp_path / name)
        make(cfg("gcn", 3, staleness=1, checkpoint_dir=d, checkpoint_every=3)).run()
        eng = make(cfg("gcn", 3, staleness=1, checkpoint_dir=d, resume=True))
        assert eng.start_epoch == 3
        out[name] = losses(eng.run())
    loss_close(out["port"], out["jax"], "gcn")
    # the uninterrupted run takes epoch 3's loss and gradient at epoch 2's
    # params, the resumed one at the loaded (epoch 3's): the losses differ
    straight = losses(TEngine(graph, layers, cfg("gcn", 6, staleness=1), device="cpu").run())
    assert abs(out["port"][0] - straight[3]) > 1e-6


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs >=2 devices (virtual CPU mesh)")
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_sharded_staleness_matches_jax(graph, model, capsys):
    """2 gloo ranks against the JAX ShardedEngine on a 2-device mesh: S=1
    and S=2 on the fused plan (hyb), S=1 on the edgewise path (xla), and
    S=2 with the converge switch, in one launch."""
    lr = 0.005 if model == "gat" else 0.01
    base = dict(model=model, reuse="off", learning_rate=lr)
    switch = dict(base, kernel="hyb", staleness=2, eval_every=1, target_accuracy=1.01,
                  switch_threshold=SWITCH[model])
    runs = [(dict(base, kernel="hyb", staleness=1, eval_every=0), 6, {}),
            (dict(base, kernel="hyb", staleness=2, eval_every=0), 6, {}),
            (dict(base, kernel="xla", staleness=1, eval_every=0), 6, {}),
            (switch, 10, {})]
    res = spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=240)
    assert [r["losses"] for r in res[0]] == [r["losses"] for r in res[1]]
    for (kw, epochs, _), got in zip(runs, res[0]):
        capsys.readouterr()
        jrep = JShardedEngine(graph, LayerConfig(DIMS),
                              TrainConfig(epochs=epochs, compile_cache="off", **kw),
                              mesh=make_mesh(2)).run()
        loss_close(got["losses"], losses(jrep), model)
    jswitch = _switch_epoch(capsys.readouterr().err)
    assert len(jswitch) == 1
    # the port's ranks ran in other processes: their switch shows in the
    # trajectory, which leaves the S=2 run's after the switch
    stale2 = res[0][1]["losses"]
    assert stale2[:jswitch[0] + 1] == res[0][3]["losses"][:jswitch[0] + 1]
