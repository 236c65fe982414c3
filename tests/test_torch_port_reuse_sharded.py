"""The port's sharded pair reuse against the JAX package, on the CPU:

  * `ShardedReuseSpMM` (ops/reuse_sharded.py) per shard against JAX's op:
    the mined rewrites (`plan_fwd` / `plan_bwd` levels, src, dst: the
    miner's own output, before JAX remaps pair ids to its padded layout),
    the rank-1 factors `f_in` / `f_out`, and `apply_static`, `apply_dst`,
    `apply_unit` on the same halo table: outputs and the table's and
    dst_val's gradients, passes 1 and 2;
  * the non-square `ReuseSpMM` it is built on, against a dense product;
  * `ShardedEngine` with kernel="hyb", reuse="pairs" on 2 and 4 gloo ranks
    against the JAX `ShardedEngine` with the same setting and the port's
    single-device `Engine` without reuse; the factor exchange at
    construction against JAX's host-assembled `f_in`; reuse="pairs" on
    another kernel logged and off;
  * reuse="pairs" on one graph shard (a 1 x 1 mesh, and 1 x 2 with tensor
    parallelism on 2 gloo ranks): the table is the vp rows the model hands
    the op and the factor the local one; against the port's `Engine` and
    the JAX `Engine` with reuse="pairs" (JAX's `ShardedEngine` fails
    there: its op keeps n * max_h ghost rows that no halo fills).

Tolerances: ops in f32 1e-5 relative to max|ref|, bf16 gather tables <=
2e-3 * max|ref|. Engines over 5 epochs: GCN loss atol 1e-4 (f32) / 1e-3
(bf16), GAT rtol 1e-5 / 5e-3. Every multi-process run has its own timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import Engine as JEngine
from dorylus_tpu.graph.graph import Graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.ops.reuse_sharded import ShardedReuseSpMM as JShardedReuseSpMM
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM
from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
from dorylus_tpu_torch.parallel.halo import ghost_counts
from dorylus_tpu_torch.parallel.multihost import spawn_local
from test_reuse import clustered_graph
from test_torch_port_sharded import close, loss_close, t32

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")

DIMS = [24, 12, 5]


def overlap_graph(v=800, seed=3):
    """Communities with shared neighbour pairs (the JAX package's
    tests/test_reuse_sharded.py `_overlap_graph`)."""
    src, dst = clustered_graph(num_vertices=v, communities=16, deg=14, seed=seed)
    rng = np.random.default_rng(seed + 1)
    labels = ((np.arange(v) * 5) // v).astype(np.int32)
    feats = rng.normal(0, 1, size=(v, 24)).astype(np.float32)
    feats += 0.6 * rng.normal(0, 1, size=(5, 24)).astype(np.float32)[labels]
    return Graph(num_vertices=v, src=src, dst=dst, features=feats, labels=labels,
                 num_classes=5).finalize()


@pytest.fixture(scope="module")
def graph():
    return overlap_graph()


@pytest.fixture(scope="module")
def sharded(graph):
    return partition_graph(graph, 4, method="range")


def live_ghosts(sg, s):
    """Which slots of shard s's ghost block an owner fills."""
    cnt = ghost_counts(sg.shards[s], sg.n_shards, sg.vp, sg.max_h)
    return (np.arange(sg.max_h)[None, :] < cnt[:, None]).ravel()


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("passes", [1, 2])
def test_sharded_reuse_op_matches_jax(graph, sharded, passes, narrow):
    sg = sharded
    n, vp, mh = sg.n_shards, sg.vp, sg.max_h
    f_global = np.sqrt(graph.self_norm)
    jgd, tgd = (jnp.bfloat16, torch.bfloat16) if narrow else (None, None)
    jop = JShardedReuseSpMM(sg, gather_dtype=jgd, rank1_factor=f_global, passes=passes,
                            min_uses=3)
    assert jop.num_pairs > 0
    rng = np.random.default_rng(9)
    f = 6
    sizes = set()
    for s, shard in enumerate(sg.shards):
        jf_in, jf_out = np.asarray(jop.arrays["f_in"][s]), np.asarray(jop.arrays["f_out"][s])
        # the local factor from the shard's own self_val, the ghosts' from JAX
        np.testing.assert_array_equal(np.sqrt(shard.self_val), jf_out)
        top = ShardedReuseSpMM(
            shard, n, rank1_factor=np.concatenate([np.sqrt(shard.self_val), jf_in[vp:]]),
            gather_dtype=tgd, passes=passes, device="cpu")
        assert (top.num_in, top.num_out) == (vp + n * mh, vp)
        # both packages mined the same rewrite, array for array
        for mine, theirs in ((top.plan_fwd, jop.plan_fwd[s]), (top.plan_bwd, jop.plan_bwd[s])):
            assert len(mine.levels) == len(theirs.levels)
            for a, b in zip(mine.levels, theirs.levels):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(mine.src, theirs.src)
            np.testing.assert_array_equal(mine.dst, theirs.dst)
            assert mine.table_size == theirs.table_size
        assert top.plan_fwd.num_vertices == vp + n * mh and top.plan_bwd.num_vertices == vp
        sizes.add(top.num_pairs)
        np.testing.assert_array_equal(top.f_in.numpy(), jf_in)
        np.testing.assert_array_equal(top.f_out.numpy(), jf_out)
        ja = jax.tree.map(lambda v: v[s], jop.arrays)
        table = rng.normal(size=(vp + n * mh, f)).astype(np.float32)
        dv = rng.normal(size=vp).astype(np.float32)
        gout = rng.normal(size=(vp, f)).astype(np.float32)
        for name in ("apply_static", "apply_dst", "apply_unit"):
            tt, td = t32(table, True), t32(dv, True)
            if name == "apply_dst":
                out = top.apply_dst(tt, td)
                jout, vjp = jax.vjp(lambda t, d: jop.apply_dst(ja, t, d), jnp.asarray(table),
                                    jnp.asarray(dv))
            else:
                out = getattr(top, name)(tt)
                jout, vjp = jax.vjp(lambda t: getattr(jop, name)(ja, t), jnp.asarray(table))
            out.backward(t32(gout))
            jg = vjp(jnp.asarray(gout))
            close(out.detach(), jout, narrow)
            # the pad slots of the ghost block take no gradient in either
            close(tt.grad, jg[0], narrow)
            if name == "apply_dst":
                close(td.grad, jg[1], narrow)
        with pytest.raises(NotImplementedError, match="factorizable"):
            top.apply(t32(table), t32(np.zeros(shard.num_edges)))
    assert len(sizes) > 1, "shards must mine unequal pair counts for this test to bite"


def test_nonsquare_reuse_op_is_the_dense_product():
    """ReuseSpMM over a (num_out, num_in) operator with num_in != num_out:
    forward, dh and the rank-1 form against a dense matrix; pair ids start
    at num_in forward and at num_out backward."""
    rng = np.random.default_rng(0)
    num_in, num_out, e = 90, 40, 1500
    # destinations share source pairs: sources drawn from a few groups
    dst = np.sort(rng.integers(0, num_out, size=e)).astype(np.int32)
    src = ((dst % 5) * 18 + rng.integers(0, 18, size=e)).astype(np.int32)
    pairs = np.unique(np.stack([src, dst]), axis=1)
    src, dst = pairs[0].astype(np.int32), pairs[1].astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    f_in = rng.uniform(0.5, 1.5, size=num_in).astype(np.float32)
    f_out = rng.uniform(0.5, 1.5, size=num_out).astype(np.float32)
    op = ReuseSpMM(src, dst, num_in, num_out, rank1_factor=(f_in, f_out), passes=2, device="cpu")
    assert op.plan_fwd.num_pairs > 0 and op.plan_bwd.num_pairs > 0
    assert op.plan_fwd.num_vertices == num_in and op.plan_bwd.num_vertices == num_out
    assert min(int(p.min()) for p in op.plan_fwd.levels) >= 0
    assert int(op.plan_fwd.src.max()) >= num_in and int(op.plan_bwd.src.max()) >= num_out
    dense = np.zeros((num_out, num_in), np.float32)
    np.add.at(dense, (dst, src), 1.0)
    h = rng.normal(size=(num_in, 5)).astype(np.float32)
    gout = rng.normal(size=(num_out, 5)).astype(np.float32)
    th = t32(h, True)
    out = op.apply_unit(th)
    out.backward(t32(gout))
    close(out.detach(), dense @ h, False)
    close(th.grad, dense.T @ gout, False)
    close(op.apply_static(t32(h)), f_out[:, None] * (dense @ (f_in[:, None] * h)), False)
    with pytest.raises(ValueError, match="mined over 90"):
        op.apply_unit(t32(h[:80]))
    with pytest.raises(ValueError, match="rank1_factor"):
        ReuseSpMM(src, dst, num_in, num_out, rank1_factor=f_in, device="cpu")


def test_sharded_reuse_refusals(sharded):
    shard = sharded.shards[0]
    with pytest.raises(ValueError, match="local then .* ghost rows"):
        # local rows only
        ShardedReuseSpMM(shard, 4, rank1_factor=np.sqrt(shard.self_val), device="cpu")
    with pytest.raises(ValueError, match="rank1_factor"):
        ShardedReuseSpMM(shard, 4, rank1_factor=np.ones(3, np.float32), device="cpu")
    op = ShardedReuseSpMM(shard, 4, device="cpu")  # GAT: no factor, no exchange
    assert op.f_in is None and not op.has_static_vals
    with pytest.raises(RuntimeError, match="without rank1_factor"):
        op.apply_static(torch.zeros((op.num_in, 2)))


# ---- the engine ----


def jax_reuse_engine(g, n, **kw):
    eng = JShardedEngine(g, LayerConfig(DIMS), TrainConfig(epochs=5, reuse="pairs", **kw),
                         mesh=make_mesh(n))
    rep = eng.run()
    return np.array([e.loss for e in rep.epochs]), eng


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
@pytest.mark.parametrize("n", [2, 4])
def test_reuse_engine_matches_jax_and_single_device(graph, n, model, lr, capfd):
    """kernel="hyb", reuse="pairs" in f32 and with bf16 gather tables, and
    reuse="pairs" on kernel="degree" (logged and off), in one launch."""
    base = dict(model=model, kernel="hyb", learning_rate=lr, eval_every=1)
    runs = [(dict(base, reuse="pairs"), 5, {"predict": True}),
            (dict(base, reuse="pairs", agg_dtype="bfloat16"), 5, {}),
            (dict(base, reuse="pairs", kernel="degree"), 2, {})]
    res = spawn_local(n, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=240)
    for r in range(1, n):
        for a, b in zip(res[0], res[r]):
            assert a["losses"] == b["losses"]
    f32, bf16, degree = res[0]
    # the rewrite runs on the combined table: overlap is turned off
    assert (f32["plan"], f32["overlap"]) == ("ShardedReuseSpMM", False)
    assert (degree["plan"], degree["overlap"]) == ("pair", True)  # reuse off, as in JAX
    logged = capfd.readouterr().err
    assert "interior/boundary overlap split disabled" in logged
    assert "pair reuse requires kernel=hyb (have degree)" in logged
    jl, jeng = jax_reuse_engine(graph, n, **base)
    assert isinstance(jeng.model.spmm_op, JShardedReuseSpMM) and not jeng.cfg.overlap
    for r in range(n):
        assert res[r][0]["pairs"] == (jeng.model.spmm_op.plan_fwd[r].num_pairs,
                                      jeng.model.spmm_op.plan_bwd[r].num_pairs)
        assert res[r][0]["pairs"][0] > 0
    loss_close(f32["losses"], jl, model, False)
    single = TEngine(graph, LayerConfig(DIMS), TrainConfig(epochs=5, reuse="off", **base),
                     device="cpu")
    loss_close(f32["losses"], [e.loss for e in single.run().epochs], model, False)
    jl16, _ = jax_reuse_engine(graph, n, agg_dtype="bfloat16", **base)
    loss_close(bf16["losses"], jl16, model, True)
    want = single.predict()
    scale = float(np.abs(want).max())
    assert float(np.abs(f32["predict"] - want).max()) <= \
        (1e-4 if model == "gcn" else 1e-3) * scale
    if model == "gcn":
        # the factor exchange at construction: each rank's f_in is JAX's
        # host-assembled one wherever an owner fills the slot (JAX repeats
        # the owner's row 0 past a pair's exact count; the port leaves 0;
        # no edge reads those slots)
        sg = jeng.sharded
        for r in range(n):
            jf_in = np.asarray(jeng.model.spmm_op.arrays["f_in"][r])
            live = np.r_[np.ones(sg.vp, bool), live_ghosts(sg, r)]
            np.testing.assert_array_equal(res[r][0]["f_in"][live], jf_in[live])
            assert not res[r][0]["f_in"][~live].any()
            np.testing.assert_array_equal(res[r][0]["f_out"],
                                          np.asarray(jeng.model.spmm_op.arrays["f_out"][r]))
            e = sg.shards[r].num_edges
            assert live[np.asarray(sg.shards[r].src[:e])].all()


# ---- one graph shard ----


@pytest.mark.parametrize("model,lr,narrow", [("gcn", 0.01, False), ("gcn", 0.01, True),
                                             ("gat", 0.005, False)],
                         ids=["gcn-f32", "gcn-bf16", "gat-f32"])
def test_reuse_on_one_graph_shard(graph, model, lr, narrow):
    """A 1 x 1 mesh (no process group): the rewrite over the vp local rows,
    the local rank-1 factor (GCN) or none (GAT); the same losses as the
    port's one-device Engine with reuse="pairs" (rtol 1e-5; bit for bit in
    practice: the same edges mine the same pairs) and JAX's Engine's."""
    kw = dict(model=model, kernel="hyb", reuse="pairs", learning_rate=lr, eval_every=1,
              agg_dtype="bfloat16" if narrow else "float32")
    out = ranks.engine_rank(0, 1, "cpu", graph, DIMS, kw, 5, {})
    assert out["mesh"] == (1, 1, 0, 0) and out["wire"] is None
    assert out["plan"] == "ShardedReuseSpMM" and out["pairs"][0] > 0
    single = TEngine(graph, LayerConfig(DIMS), TrainConfig(epochs=5, **kw), device="cpu")
    assert isinstance(single.model.spmm_op, ReuseSpMM)
    assert out["pairs"] == (single.model.spmm_op.plan_fwd.num_pairs,
                            single.model.spmm_op.plan_bwd.num_pairs)
    np.testing.assert_allclose(out["losses"], [e.loss for e in single.run().epochs],
                               rtol=1e-5, atol=0)
    if model == "gcn":
        np.testing.assert_array_equal(out["f_in"], out["f_out"])
        v = graph.num_vertices
        np.testing.assert_allclose(out["f_out"][:v] ** 2, graph.self_norm, rtol=1e-6)
    jeng = JEngine(graph, LayerConfig(DIMS), TrainConfig(epochs=5, **kw))
    loss_close(out["losses"], [e.loss for e in jeng.run().epochs], model, narrow)


def test_reuse_on_one_graph_shard_tp(graph):
    """A 1 x 2 mesh (one graph shard, two feat shards, 2 gloo ranks): GCN
    with reuse="pairs" at half the width, against the one-device Engine
    with reuse="pairs" (rtol 1e-5) and JAX's Engine (atol 1e-4)."""
    kw = dict(model="gcn", kernel="hyb", reuse="pairs", eval_every=1, feat_shards=2)
    res = spawn_local(2, ranks.engine_rank, (graph, DIMS, kw, 5, {}), backend="gloo",
                      device="cpu", timeout_s=240)
    assert [r["mesh"] for r in res] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["plan"] == "ShardedReuseSpMM" and res[0]["pairs"][0] > 0
    one = dict(kw, feat_shards=1)
    single = TEngine(graph, LayerConfig(DIMS), TrainConfig(epochs=5, **one), device="cpu")
    np.testing.assert_allclose(res[0]["losses"], [e.loss for e in single.run().epochs],
                               rtol=1e-5, atol=0)
    jeng = JEngine(graph, LayerConfig(DIMS), TrainConfig(epochs=5, **one))
    loss_close(res[0]["losses"], [e.loss for e in jeng.run().epochs], "gcn", False)
