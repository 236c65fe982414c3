"""Tensor parallelism in the port (parallel/mesh.py, the models'
`_forward_tp`, `ShardedEngine` with feat_shards = m > 1) on gloo CPU ranks,
against the JAX `ShardedEngine` on a `make_mesh(n, feat_shards=m)` mesh of
the 8-device virtual CPU mesh, and against the port's single-device
`Engine`. The graphs and layer configs are those of the JAX package's
tests/test_feat_parallel.py. ~60 s in one process (four launches of 2-4
ranks, each running several cases).

Tolerances: per-epoch losses against JAX's TP run rtol 1e-5 in f32, atol
1e-3 with bf16 gather tables; against the single-device port run JAX's own
rtol 5e-4. Gradients (the world-summed TP gradients at the initial params)
against single-device autograd and JAX's jax.grad element by element at
rtol 1e-4, atol 1e-6: Adam is invariant to a constant scale of a gradient,
so only this catches an m-fold over-count.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.engine import Engine as JEngine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel.mesh import make_mesh as jmake_mesh
from dorylus_tpu.parallel.train_step import ShardedEngine as JShardedEngine
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.parallel.multihost import spawn_local
from dorylus_tpu_torch.parallel.train_step import ShardedEngine
from test_torch_port_reuse_sharded import overlap_graph

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (virtual CPU mesh)")

GCN_G = dict(args=(400, 6, 16, 5), seed=13, dims=[16, 8, 5])
GAT_G = dict(args=(240, 5, 12, 4), seed=17, dims=[12, 8, 4])
GAT5_G = dict(args=(240, 5, 12, 5), seed=19, dims=[12, 8, 5])  # 5 % 2: indivisible output
GCN = dict(model="gcn", learning_rate=0.01)
GAT = dict(model="gat", learning_rate=0.005)


def graph_of(spec):
    return synthetic_graph(*spec["args"], seed=spec["seed"])


@pytest.fixture(scope="module")
def graphs():
    return {"gcn": graph_of(GCN_G), "gat": graph_of(GAT_G), "gat5": graph_of(GAT5_G),
            "reuse": overlap_graph()}


DIMS = {"gcn": GCN_G["dims"], "gat": GAT_G["dims"], "gat5": GAT5_G["dims"],
        "reuse": [24, 12, 5]}

# (name, graph, cfg, epochs, opts) per launch; each launch is n * m ranks
CASES = {
    (2, 2): [("gcn hyb", "gcn", dict(GCN, kernel="hyb"), 5,
              {"grads": True, "predict": True, "profile": True}),
             ("gcn xla", "gcn", dict(GCN, kernel="xla"), 5, {}),
             ("gcn hyb bf16", "gcn", dict(GCN, kernel="hyb", agg_dtype="bfloat16"), 5, {}),
             ("gat hyb", "gat", dict(GAT, kernel="hyb"), 4, {"grads": True}),
             ("gat5 hyb", "gat5", dict(GAT, kernel="hyb"), 4, {}),
             ("reuse gcn", "reuse", dict(GCN, kernel="hyb", reuse="pairs"), 4, {}),
             ("gcn hyb s1", "gcn", dict(GCN, kernel="hyb", staleness=1), 5, {}),
             ("gcn hyb ckpt", "gcn", dict(GCN, kernel="hyb", checkpoint_every=4), 4, {})],
    (1, 4): [("gcn hyb", "gcn", dict(GCN, kernel="hyb"), 5, {"profile": True}),
             ("gcn xla", "gcn", dict(GCN, kernel="xla"), 5, {}),
             ("gat xla", "gat", dict(GAT, kernel="xla"), 4, {})],
    (1, 2): [("gcn degree", "gcn", dict(GCN, kernel="degree"), 5, {}),
             ("gat degree", "gcn", dict(GAT, kernel="degree"), 4, {}),
             ("gcn hyb", "gcn", dict(GCN, kernel="hyb"), 5, {})],
}


def _cfg(cfg, n, m, epochs, ckpt=None):
    kw = dict(cfg, eval_every=1, feat_shards=m, num_shards=n)
    kw.setdefault("reuse", "off")
    if "checkpoint_every" in kw:
        kw["checkpoint_dir"] = ckpt
    return kw


@pytest.fixture(scope="module")
def runs(graphs, tmp_path_factory):
    """{(n, m): {case name: [rank results]}}: one launch per (n, m)."""
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    out = {}
    for (n, m), cases in CASES.items():
        args = [(graphs[g], DIMS[g], _cfg(cfg, n, m, ep, ckpt), ep, opts)
                for _, g, cfg, ep, opts in cases]
        res = spawn_local(n * m, ranks.cases_rank, (args,), backend="gloo", device="cpu",
                          timeout_s=300)
        out[n, m] = {name: [res[r][i] for r in range(n * m)]
                     for i, (name, *_) in enumerate(cases)}
    out["ckpt"] = ckpt
    return out


def jax_tp(g, dims, n, m, epochs, cfg):
    kw = dict(cfg, eval_every=1)
    kw.setdefault("reuse", "off")
    eng = JShardedEngine(g, LayerConfig(dims), TrainConfig(epochs=epochs, feat_shards=m,
                                                           num_shards=n, **kw),
                         mesh=jmake_mesh(n, feat_shards=m))
    rep = eng.run()
    return np.array([e.loss for e in rep.epochs]), eng


def port_single(g, dims, epochs, cfg, **extra):
    kw = dict(cfg, eval_every=1)
    kw.setdefault("reuse", "off")
    eng = TEngine(g, LayerConfig(dims), TrainConfig(epochs=epochs, **dict(kw, **extra)),
                  device="cpu")
    rep = eng.run()
    return np.array([e.loss for e in rep.epochs]), eng


def case(n, m, name):
    return next(c for c in CASES[n, m] if c[0] == name)


def check_trajectory(runs, graphs, n, m, name, narrow=False):
    _, gname, cfg, epochs, _ = case(n, m, name)
    rows = runs[n, m][name]
    got = np.array(rows[0]["losses"])
    for r in rows[1:]:  # every rank reports the same numbers
        assert r["losses"] == rows[0]["losses"] and r["val_acc"] == rows[0]["val_acc"]
    jl, jeng = jax_tp(graphs[gname], DIMS[gname], n, m, epochs, cfg)
    if narrow:
        np.testing.assert_allclose(got, jl, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(got, jl, rtol=1e-5, atol=0)
    single, _ = port_single(graphs[gname], DIMS[gname], epochs, cfg)
    np.testing.assert_allclose(got, single, rtol=5e-4, atol=1e-6)
    return rows, jeng


@pytest.mark.parametrize("n,m,kernel", [(2, 2, "hyb"), (2, 2, "xla"), (1, 4, "hyb"),
                                        (1, 4, "xla"), (1, 2, "hyb"), (1, 2, "degree")])
def test_tp_gcn_matches_jax_and_single_device(runs, graphs, n, m, kernel):
    rows, jeng = check_trajectory(runs, graphs, n, m, f"gcn {kernel}")
    assert abs(rows[0]["val_acc"] - jeng.report.final_accuracy) < 1e-6
    assert rows[0]["overlap"] is False and rows[0]["kernel"] == kernel
    # the mesh as JAX's reshape(n, m): rank r on shard r // m at feat index r % m
    assert [r["mesh"] for r in rows] == [(n, m, r // m, r % m) for r in range(n * m)]


@pytest.mark.parametrize("n,m,name", [(2, 2, "gat hyb"), (1, 4, "gat xla"),
                                      (1, 2, "gat degree")])
def test_tp_gat_matches_jax_and_single_device(runs, graphs, n, m, name):
    check_trajectory(runs, graphs, n, m, name)


def test_tp_gat_indivisible_output_width(runs, graphs):
    """Classes 5 with m = 2: the output layer aggregates the whole z on
    every feat rank (the column-masked matvec keeps d(a) block-local)."""
    check_trajectory(runs, graphs, 2, 2, "gat5 hyb")


def test_tp_bf16_gather_matches_jax(runs, graphs):
    rows = runs[2, 2]["gcn hyb bf16"]
    _, _, cfg, epochs, _ = case(2, 2, "gcn hyb bf16")
    jl, _ = jax_tp(graphs["gcn"], DIMS["gcn"], 2, 2, epochs, cfg)
    np.testing.assert_allclose(rows[0]["losses"], jl, rtol=0, atol=1e-3)


def test_tp_reuse_pairs_matches_jax(runs, graphs):
    """reuse="pairs" under TP: the pair budget at the sliced width; the
    trajectory against JAX's TP reuse run and against plain single-device
    hyb (the rewrite is exact)."""
    rows = runs[2, 2]["reuse gcn"]
    assert rows[0]["plan"] == "ShardedReuseSpMM" and rows[0]["pairs"][0] > 0
    _, _, cfg, epochs, _ = case(2, 2, "reuse gcn")
    jl, jeng = jax_tp(graphs["reuse"], DIMS["reuse"], 2, 2, epochs, cfg)
    for r in rows:
        g = r["mesh"][2]
        assert r["pairs"] == (jeng.model.spmm_op.plan_fwd[g].num_pairs,
                              jeng.model.spmm_op.plan_bwd[g].num_pairs)
    np.testing.assert_allclose(rows[0]["losses"], jl, rtol=1e-5, atol=0)
    plain, _ = port_single(graphs["reuse"], DIMS["reuse"], epochs, dict(cfg, reuse="off"))
    np.testing.assert_allclose(rows[0]["losses"], plain, rtol=5e-4, atol=1e-6)


def test_tp_staleness_matches_jax(runs, graphs):
    rows = runs[2, 2]["gcn hyb s1"]
    _, _, cfg, epochs, _ = case(2, 2, "gcn hyb s1")
    jl, _ = jax_tp(graphs["gcn"], DIMS["gcn"], 2, 2, epochs, cfg)
    np.testing.assert_allclose(rows[0]["losses"], jl, rtol=1e-5, atol=0)
    assert rows[0]["losses"][1] == rows[0]["losses"][0]  # epoch 1 at epoch 0's params
    single, _ = port_single(graphs["gcn"], DIMS["gcn"], epochs, cfg)
    np.testing.assert_allclose(rows[0]["losses"], single, rtol=5e-4, atol=1e-6)


def test_tp_checkpoint_resumes_on_one_device(runs, graphs):
    """A checkpoint written by the 2 x 2 run (rank 0 writes) resumes on the
    single-device engine: its two epochs continue the uninterrupted run."""
    _, _, cfg, _, _ = case(2, 2, "gcn hyb ckpt")
    full, _ = port_single(graphs["gcn"], DIMS["gcn"], 6, dict(GCN, kernel="hyb"))
    np.testing.assert_allclose(runs[2, 2]["gcn hyb ckpt"][0]["losses"], full[:4], rtol=5e-4)
    resumed, eng = port_single(graphs["gcn"], DIMS["gcn"], 2, dict(GCN, kernel="hyb"),
                               checkpoint_dir=runs["ckpt"], resume=True)
    assert eng.start_epoch == 4
    np.testing.assert_allclose(resumed, full[4:], rtol=5e-4)


@pytest.mark.parametrize("name,spec,cfg", [("gcn hyb", "gcn", GCN), ("gat hyb", "gat", GAT)])
def test_tp_gradients_exact(runs, graphs, name, spec, cfg):
    """The 2 x 2 TP gradients summed over the world (what the train step's
    all-reduce gives) against single-device autograd and JAX's jax.grad,
    element by element."""
    rows = runs[2, 2][name]
    g, dims = graphs[spec], DIMS[spec]
    tp = rows[0]["grads"]
    for r in rows[1:]:
        for k in tp:
            np.testing.assert_array_equal(r["grads"][k], tp[k])
    teng = TEngine(g, LayerConfig(dims), TrainConfig(kernel="hyb", reuse="off", **cfg),
                   device="cpu")
    names = list(teng.params)
    tg = torch.autograd.grad(teng.model.loss(teng.batch), [teng.params[k] for k in names])
    jeng = JEngine(g, LayerConfig(dims), TrainConfig(kernel="hyb", reuse="off", **cfg))
    jg = jax.grad(lambda p: jeng.model.loss(p, jeng.batch))(jeng.params)
    assert set(tp) == set(names) == set(jg)
    for k, t in zip(names, tg):
        np.testing.assert_allclose(tp[k], t.numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tp[k], np.asarray(jg[k]), rtol=1e-4, atol=1e-6)


def test_tp_loss_and_accuracy_are_not_multiplied(runs, graphs):
    """The loss is summed over the graph group only and the evaluation
    counts each shard once: both equal the single-device engine's, not m
    times it."""
    rows = runs[2, 2]["gcn hyb"]
    single, eng = port_single(graphs["gcn"], DIMS["gcn"], 5, dict(GCN, kernel="hyb"))
    assert rows[0]["losses"][0] == pytest.approx(single[0], rel=1e-5)
    assert rows[0]["val_acc"] == pytest.approx(eng.report.final_accuracy, abs=1e-6)
    assert rows[0]["test_acc"] == pytest.approx(eng.report.test_accuracy, abs=1e-6)
    assert 0 < rows[0]["val_acc"] <= 1
    # the cost note counts every rank's GPU-seconds (JAX: mesh.size chips)
    assert rows[0]["notes"]["feat_shards"] == 2 and rows[0]["notes"]["shards"] == 2
    assert rows[0]["notes"]["cost"]["chip_seconds"] >= 0 and "hbm" not in rows[0]["notes"]


def test_tp_predict_in_global_order(runs, graphs):
    """predict() at 2 x 2 gathers each shard once over its graph group, on
    every rank: the single-device rows in global vertex order."""
    _, eng = port_single(graphs["gcn"], DIMS["gcn"], 5, dict(GCN, kernel="hyb"))
    want = eng.predict()
    for r in runs[2, 2]["gcn hyb"]:
        assert r["predict"].shape == want.shape
        np.testing.assert_allclose(r["predict"], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("n,m", [(2, 2), (1, 4)])
def test_tp_profile_returns_jaxs_keys(runs, graphs, n, m):
    """ShardedEngine.profile on a TP engine: JAX's key set for the same
    configuration (halo lines only with more than one graph shard), every
    value > 0 and the same on every rank."""
    rows = runs[n, m]["gcn hyb"]
    _, jeng = jax_tp(graphs["gcn"], DIMS["gcn"], n, m, 1, dict(GCN, kernel="hyb"))
    want = jeng.profile(iters=1)
    got = rows[0]["profile"]
    assert set(got) == set(want)
    assert all(v > 0 for v in got.values())
    assert all(r["profile"] == got for r in rows)


def test_tp_staging_over_two_groups():
    """gloo stages every collective through one host buffer per tag: feat
    and graph reductions, gathers and all-to-alls of one shape and dtype,
    interleaved, each give their own group's result, and no result changes
    after a later call reuses the buffer."""
    res = spawn_local(4, ranks.staging_rank, (), backend="gloo", device="cpu", timeout_s=120)
    for r, out in enumerate(res):
        n_, m_, gi, fi = out["mesh"]
        feat = [gi * 2 + j for j in range(2)]  # the ranks sharing my shard
        graph = [i * 2 + fi for i in range(2)]  # the ranks sharing my feat index
        want = [sum(q + 1 for q in feat), 10 * sum(q + 1 for q in graph),
                100 * sum(q + 1 for q in feat)]
        for k in range(3):
            np.testing.assert_array_equal(out["at_return"][k], np.full((3, 4), want[k]))
        np.testing.assert_array_equal(out["at_return"][3][:, 0, 0], [q + 1 for q in graph])
        np.testing.assert_array_equal(out["at_return"][4][:, 0, 0], [2 * (q + 1) for q in feat])
        for k, grp, base in ((5, graph, 10), (6, feat, 100)):
            me = grp.index(r)
            got = out["at_return"][k][:, 0]
            np.testing.assert_array_equal(
                got, [2 * me + j + base * q for q in grp for j in range(2)])
        np.testing.assert_array_equal(out["at_return"][7], np.full((3, 4), 10.0))
        for a, b in zip(out["at_return"], out["at_end"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model,dims,m", [("gcn", [10, 8, 4], 4), ("gat", [12, 6, 4], 4)])
def test_tp_refuses_an_indivisible_width(model, dims, m):
    """JAX asserts every input and hidden width divides m; the port keeps
    the refusal (nothing is padded)."""
    g = synthetic_graph(200, 5, dims[0], dims[-1], seed=3)
    with pytest.raises(ValueError, match="divisible"):
        ShardedEngine(g, LayerConfig(dims), TrainConfig(feat_shards=m, model=model,
                                                        reuse="off"), device="cpu")


@pytest.mark.parametrize("kw", [dict(feat_shards=2), dict(feat_shards=2, num_shards=2)])
def test_tp_refuses_a_world_that_is_not_n_by_m(kw):
    """Without a process group the world is one rank: no (n, m) mesh fits
    (JAX: the mesh's feat axis does not match)."""
    g = synthetic_graph(200, 5, 16, 4, seed=3)
    with pytest.raises(ValueError, match="feat axis"):
        ShardedEngine(g, LayerConfig([16, 8, 4]), TrainConfig(reuse="off", **kw),
                      device="cpu")


def test_cli_trains_with_feat_shards(tmp_path, graphs):
    """`train --shards 2 --feat-shards 2 --device cpu` through cli.main: 4
    ranks, rank r on shard r // 2; its losses are the single-device run's."""
    import json

    from dorylus_tpu_torch.cli import main as tmain

    rep = tmp_path / "rep.json"
    argv = ["train", "--dataset", "synthetic", "--synth-vertices", "400", "--synth-degree",
            "6", "--epochs", "3", "--eval-every", "0", "--kernel", "hyb", "--reuse", "off",
            "--device", "cpu", "--output", str(rep)]
    assert tmain(argv + ["--shards", "2", "--feat-shards", "2"]) == 0
    tp = json.loads(rep.read_text())
    assert tp["notes"]["feat_shards"] == 2 and tp["notes"]["shards"] == 2
    assert tmain(argv) == 0
    one = json.loads(rep.read_text())
    np.testing.assert_allclose([e["loss"] for e in tp["epochs"]],
                               [e["loss"] for e in one["epochs"]], rtol=5e-4)

