"""Checkpoints across the two packages (dorylus_tpu_torch/engine/checkpoint.py
against dorylus_tpu/engine/checkpoint.py), on the CPU:

  * the files: what JAX writes the port loads array for array and back,
    `opt/step` an int32 0-d array both ways;
  * resume: a checkpoint either package writes resumes in the other, one
    device and 2 gloo ranks against a 2-device JAX mesh, and the losses
    continue an uninterrupted JAX run's; epoch numbering (the LR schedule)
    carries on from the checkpoint's step;
  * the crash cases of tests/test_checkpoint.py: a truncated temp and an
    empty LATEST never win, and a crash mid-write leaves only a dotfile.

Tolerances: f32 losses against JAX, GCN atol 1e-4, GAT rtol 1e-5 (PERF.md
section 2: only summation orders differ).
"""

import json

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import checkpoint as jck
from dorylus_tpu.engine.engine import Engine as JEngine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.engine import checkpoint as tck
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

DIMS = [16, 8, 4]


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(240, 6, 16, 4, seed=41)


def cfg(model, epochs, **kw):
    return TrainConfig(model=model, epochs=epochs, eval_every=0, kernel="hyb", reuse="off",
                       learning_rate=0.005 if model == "gat" else 0.01,
                       compile_cache="off", **kw)


def losses(rep):
    return np.array([e.loss for e in rep.epochs])


def loss_close(got, ref, model):
    if model == "gcn":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_files_carry_both_ways(graph, tmp_path):
    """JAX writes, the port loads; the port writes, JAX loads: the same
    arrays under the same keys, opt/step an int32 0-d array."""
    jd, td = tmp_path / "j", tmp_path / "t"
    jeng = JEngine(graph, LayerConfig(DIMS), cfg("gat", 3, checkpoint_dir=str(jd),
                                                 checkpoint_every=3))
    jeng.run()
    got = tck.load_checkpoint(tck.latest_checkpoint(jd))
    assert got["step"] == 3 and got["opt_state"]["step"] == 3
    assert sorted(got["params"]) == ["a0", "a1", "w0", "w1"]
    for k, w in jeng.params.items():
        np.testing.assert_array_equal(got["params"][k], np.asarray(w))
        np.testing.assert_array_equal(got["opt_state"]["m"][k], np.asarray(jeng.opt_state.m[k]))
        np.testing.assert_array_equal(got["opt_state"]["v"][k], np.asarray(jeng.opt_state.v[k]))

    teng = TEngine(graph, LayerConfig(DIMS), cfg("gat", 2, checkpoint_dir=str(td),
                                                 checkpoint_every=2), device="cpu")
    teng.run()
    path = jck.latest_checkpoint(td)
    assert path.name == "ckpt_00000002.npz"
    back = jck.load_checkpoint(path)
    assert back["step"] == 2 and back["extra"] == {}
    assert back["opt_state"].step.dtype == np.int32 and back["opt_state"].step.shape == ()
    assert int(back["opt_state"].step) == teng.opt_state.step == 2
    for k, p in teng.params.items():
        np.testing.assert_array_equal(back["params"][k], p.detach().numpy())
        np.testing.assert_array_equal(back["opt_state"].m[k], teng.opt_state.m[k].numpy())
        np.testing.assert_array_equal(back["opt_state"].v[k], teng.opt_state.v[k].numpy())
    with np.load(path, allow_pickle=False) as z:
        assert z["opt/step"].dtype == np.int32 and z["opt/step"].shape == ()
        assert json.loads(bytes(z["__meta__"]).decode()) == {"step": 2, "extra": {}}
    # the same keys as JAX's file, and nothing else in the directory
    with np.load(jck.latest_checkpoint(jd)) as zj, np.load(path) as zt:
        assert sorted(zj.files) == sorted(zt.files)
    assert sorted(p.name for p in td.iterdir()) == ["LATEST", "ckpt_00000002.npz"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_resume_across_packages(graph, tmp_path, model, writer):
    """3 epochs in one package with a checkpoint, then 3 resumed in the
    other: the losses of epochs 3-5 are those of an uninterrupted 6-epoch
    JAX run. The LR decays every 2 epochs, so the numbering must carry on."""
    layers = LayerConfig(DIMS)
    kw = dict(lr_decay_every=2)
    full = losses(JEngine(graph, layers, cfg(model, 6, **kw)).run())
    d = str(tmp_path / "ck")
    first = cfg(model, 3, checkpoint_dir=d, checkpoint_every=3, **kw)
    if writer == "jax":
        JEngine(graph, layers, first).run()
        eng = TEngine(graph, layers, cfg(model, 3, checkpoint_dir=d, resume=True, **kw),
                      device="cpu")
    else:
        TEngine(graph, layers, first, device="cpu").run()
        eng = JEngine(graph, layers, cfg(model, 3, checkpoint_dir=d, resume=True, **kw))
    assert eng.start_epoch == 3
    rep = eng.run()
    assert [e.epoch for e in rep.epochs] == [3, 4, 5]
    loss_close(losses(rep), full[3:], model)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs >=2 devices (virtual CPU mesh)")
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_resume_across_packages_on_two_ranks(graph, tmp_path, model):
    """The same on 2 gloo ranks against a 2-device JAX mesh: the port's
    rank 0 writes a checkpoint the JAX ShardedEngine resumes from, and the
    port's ranks resume from the JAX ShardedEngine's; both continue the
    uninterrupted JAX run. One launch runs the port's two runs."""
    layers = LayerConfig(DIMS)
    full = losses(JShardedEngine(graph, layers, cfg(model, 6), mesh=make_mesh(2)).run())
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    JShardedEngine(graph, layers, cfg(model, 3, checkpoint_dir=jd, checkpoint_every=3),
                   mesh=make_mesh(2)).run()
    base = dict(model=model, kernel="hyb", reuse="off", eval_every=0,
                learning_rate=0.005 if model == "gat" else 0.01)
    runs = [(dict(base, checkpoint_dir=td, checkpoint_every=3), 3, {}),
            (dict(base, checkpoint_dir=jd, resume=True), 3, {})]
    res = spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=240)
    assert res[0][1]["losses"] == res[1][1]["losses"]
    loss_close(res[0][0]["losses"], full[:3], model)
    loss_close(res[0][1]["losses"], full[3:], model)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "LATEST", "ckpt_00000003.npz"]
    jeng = JShardedEngine(graph, layers, cfg(model, 3, checkpoint_dir=td, resume=True),
                          mesh=make_mesh(2))
    assert jeng.start_epoch == 3
    loss_close(losses(jeng.run()), full[3:], model)


def test_resume_ignores_truncated_tmp_and_empty_latest(tmp_path):
    """tests/test_checkpoint.py's crash artifacts, in the port's reader
    and across packages: a garbage dotfile temp and a temp of the older
    naming never win over a complete checkpoint; an empty LATEST falls
    back to the newest complete file."""
    d = tmp_path / "ck"
    tck.save_checkpoint(d, 10, {"w0": torch.ones(2, 2)})
    (d / ".ckpt_00000020.npz.tmp").write_bytes(b"garbage")
    (d / "ckpt_00000020.tmp.npz").write_bytes(b"garbage")
    for m in (tck, jck):
        p = m.latest_checkpoint(d)
        assert p is not None and p.name == "ckpt_00000010.npz"
        assert m.load_checkpoint(p)["step"] == 10
    (d / "LATEST").write_text("")  # a crash mid-marker-write
    for m in (tck, jck):
        assert m.latest_checkpoint(d).name == "ckpt_00000010.npz"
    assert tck.latest_checkpoint(tmp_path / "none") is None


def test_crash_mid_write_leaves_a_dotfile(tmp_path, monkeypatch):
    """A write that dies half way leaves `.ckpt_N.npz.tmp` and the LATEST
    of the last complete checkpoint: what resume loads is whole."""
    d = tmp_path / "ck"
    tck.save_checkpoint(d, 4, {"w0": torch.zeros(3)})

    def dies(f, **arrays):
        f.write(b"PK\x03\x04 half")
        raise OSError("disk gone")

    monkeypatch.setattr(tck.np, "savez", dies)
    with pytest.raises(OSError):
        tck.save_checkpoint(d, 8, {"w0": torch.ones(3)})
    monkeypatch.undo()
    assert sorted(p.name for p in d.iterdir()) == [".ckpt_00000008.npz.tmp", "LATEST",
                                                   "ckpt_00000004.npz"]
    assert (d / "LATEST").read_text() == "ckpt_00000004.npz"
    got = tck.load_checkpoint(tck.latest_checkpoint(d))
    assert got["step"] == 4 and got["opt_state"] is None
    np.testing.assert_array_equal(got["params"]["w0"], np.zeros(3, np.float32))


def test_resume_without_checkpoint_and_sgd(graph, tmp_path):
    """resume=True over an empty directory starts at epoch 0; an SGD run's
    checkpoint holds no Adam state, and resuming it continues the run."""
    layers = LayerConfig(DIMS)
    d = str(tmp_path / "ck")
    eng = TEngine(graph, layers, cfg("gcn", 2, checkpoint_dir=d, resume=True, adam=False),
                  device="cpu")
    assert eng.start_epoch == 0
    full = losses(TEngine(graph, layers, cfg("gcn", 4, adam=False), device="cpu").run())
    TEngine(graph, layers, cfg("gcn", 2, checkpoint_dir=d, checkpoint_every=2, adam=False),
            device="cpu").run()
    assert tck.load_checkpoint(tck.latest_checkpoint(d))["opt_state"] is None
    rep = TEngine(graph, layers, cfg("gcn", 2, checkpoint_dir=d, resume=True, adam=False),
                  device="cpu").run()
    np.testing.assert_array_equal(losses(rep), full[2:])
