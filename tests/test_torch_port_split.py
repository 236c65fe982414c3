"""The (interior, boundary) overlap split of the port against the JAX
package, on the CPU:

  * `ShardedHybSpMM` edges="interior" / "boundary" per shard against JAX's
    op on the same shard and table (static and unit/dst plans);
  * the models' split branches in one process, with a linear stand-in for
    the exchange: the op pair (with static values, and through
    `apply(h, val_int)` / `apply(ghosts, val_bnd)` without them) and the
    edgewise split (two `EdgeSpMM`) against the combined paths: outputs and
    every parameter's gradient; GAT's d(att) sums two contributions;
  * `shard_batch`: the split arrays ship only on the edgewise split,
    zero-length stubs where the plans carry what aggregation reads;
  * `ShardedEngine` with kernel="xla", overlap=True on 2 and 4 gloo ranks
    against the JAX `ShardedEngine` with the same setting and the port's
    single-device `Engine`;
  * a rank whose shard has no boundary edge (it receives no ghost row and
    its boundary plan is empty): every overlap plan still enters every
    collective, forward and backward, and trains the single-device
    trajectory (2 ranks, own timeout).

Tolerances: ops and models in f32 1e-5 relative to max|ref| (summation
orders differ), bf16 gather tables <= 2e-3 * max|ref|; engines over 5
epochs: GCN loss atol 1e-4, GAT rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.graph.graph import Graph, clustered_synthetic_graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.ops.hyb_sharded import ShardedHybSpMM as JShardedHybSpMM
from dorylus_tpu_torch.common.config import LayerConfig
from dorylus_tpu_torch.graph.partition import shard_edges
from dorylus_tpu_torch.models.gat import GAT
from dorylus_tpu_torch.models.gcn import GCN
from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
from dorylus_tpu_torch.ops.spmm import EdgeSpMM
from dorylus_tpu_torch.parallel.multihost import spawn_local
from dorylus_tpu_torch.parallel.train_step import shard_batch
from test_torch_port_sharded import (DIMS, close, hub_graph, jax_sharded, loss_close,
                                     port_single, t32)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")


@pytest.fixture(scope="module", params=["gcn", "gat"])
def shards(request):
    static = request.param == "gcn"
    return partition_graph(hub_graph(), 4, method="hash", for_gat=not static), static


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edges", ["interior", "boundary"])
def test_sharded_hyb_split_plans_match_jax(shards, edges, narrow):
    sg, static = shards
    n, vp, mh = sg.n_shards, sg.vp, sg.max_h
    kw = dict(max_width=16, lam_slots=8, static_vals=static, edges=edges)
    jop = JShardedHybSpMM(sg, dynamic=False, gather_dtype=jnp.bfloat16 if narrow else None,
                          **kw)
    rows = vp if edges == "interior" else n * mh
    rng = np.random.default_rng(4)
    for s, shard in enumerate(sg.shards):
        top = ShardedHybSpMM(shard, n, gather_dtype=torch.bfloat16 if narrow else None,
                             device="cpu", **kw)
        assert (top.num_in, top.num_out, top.fused) == (rows, vp, False)
        ja = jax.tree.map(lambda v: v[s], jop.arrays)
        table = rng.normal(size=(rows, 6)).astype(np.float32)
        dv = rng.normal(size=vp).astype(np.float32)
        gout = rng.normal(size=(vp, 6)).astype(np.float32)
        tt, td = t32(table, True), t32(dv, True)
        if static:
            out = top.apply_static(tt)
            jout, vjp = jax.vjp(lambda t: jop.apply_static(ja, t), jnp.asarray(table))
        else:
            out = top.apply_dst(tt, td)
            jout, vjp = jax.vjp(lambda t, d: jop.apply_dst(ja, t, d), jnp.asarray(table),
                                jnp.asarray(dv))
        out.backward(t32(gout))
        jg = vjp(jnp.asarray(gout))
        close(out.detach(), jout, narrow)
        close(tt.grad, jg[0], narrow)
        if not static:
            close(td.grad, jg[1], narrow)


# ---- the models' split branches, one process ----


def _model_setup(model_cls, static_vals, seed=2):
    """One shard of a 4-way partition, a linear stand-in for the exchange
    (ghosts = G h: differentiable, as the exchange is) and the batches."""
    gat = model_cls is GAT
    sg = partition_graph(hub_graph(), 4, method="hash", for_gat=gat)
    shard, n = sg.shards[1], sg.n_shards
    rng = np.random.default_rng(seed)
    g_mat = t32(rng.normal(size=(n * sg.max_h, sg.vp)) / np.sqrt(sg.vp))

    def ghosts_of(h):
        return torch.matmul(g_mat, h.float()).to(h.dtype)

    def table_of(h):
        return torch.cat([h, ghosts_of(h)], dim=0)

    return sg, shard, n, ghosts_of, table_of


def _grads(model, batch, halo):
    params = model.init_params()
    loss = model.loss(batch, halo=halo)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


@pytest.mark.parametrize("model_cls,static_vals", [(GCN, True), (GCN, False), (GAT, False)],
                         ids=["gcn-static", "gcn-values", "gat"])
def test_models_op_pair_is_the_combined_op(model_cls, static_vals):
    """The (interior, boundary) degree pair against the combined degree op
    under the same exchange: loss and every parameter gradient. Without
    static values GCN feeds `val_int` / `val_bnd` through `apply`."""
    sg, shard, n, ghosts_of, table_of = _model_setup(model_cls, static_vals)
    layers = LayerConfig(DIMS)
    pair = tuple(ShardedDegreeSpMM(shard, n, edges=e, static_vals=static_vals, device="cpu")
                 for e in ("interior", "boundary"))
    comb = ShardedDegreeSpMM(shard, n, static_vals=static_vals, device="cpu")
    needs_values = model_cls is GCN and not static_vals
    b_pair = shard_batch(shard, sg.denom, torch.device("cpu"), edge_arrays=False,
                         split="edges" if needs_values else "stubs")
    b_comb = shard_batch(shard, sg.denom, torch.device("cpu"), edge_arrays=needs_values)
    l_pair, g_pair = _grads(model_cls(layers, spmm_split=pair), b_pair, ghosts_of)
    l_comb, g_comb = _grads(model_cls(layers, spmm_op=comb), b_comb, table_of)
    close(l_pair, l_comb, False)
    for a, b in zip(g_pair, g_comb):
        close(a, b, False)


@pytest.mark.parametrize("model_cls", [GCN, GAT], ids=["gcn", "gat"])
def test_models_edgewise_split_is_the_combined_edgewise_path(model_cls):
    sg, shard, n, ghosts_of, table_of = _model_setup(model_cls, False)
    layers = LayerConfig(DIMS)
    cpu = torch.device("cpu")
    eops = tuple(EdgeSpMM(*shard_edges(shard, e)[:2], rows, sg.vp, device=cpu)
                 for e, rows in (("interior", sg.vp), ("boundary", n * sg.max_h)))
    eop = EdgeSpMM(*shard_edges(shard, "combined")[:2], sg.vp + n * sg.max_h, sg.vp,
                   device=cpu)
    b_split = shard_batch(shard, sg.denom, cpu, edge_arrays=False, split="edges")
    b_comb = shard_batch(shard, sg.denom, cpu, edge_arrays=True)
    l_split, g_split = _grads(model_cls(layers, edge_split=eops), b_split, ghosts_of)
    l_comb, g_comb = _grads(model_cls(layers, edge_op=eop), b_comb, table_of)
    close(l_split, l_comb, False)
    for a, b in zip(g_split, g_comb):
        close(a, b, False)
    # the split batch's edge arrays are checked against each op's edges
    swapped = model_cls(layers, edge_split=eops[::-1])
    with pytest.raises(ValueError, match="edge"):
        swapped.loss(b_split, halo=ghosts_of)


def test_shard_batch_ships_the_split_only_where_it_is_read():
    sg = partition_graph(hub_graph(), 4, method="hash")
    shard = sg.shards[2]
    cpu = torch.device("cpu")
    plain = shard_batch(shard, sg.denom, cpu, edge_arrays=True)
    assert plain.src_int is None and plain.val_bnd is None
    assert plain.src.shape == (shard.num_edges,)
    stubs = shard_batch(shard, sg.denom, cpu, edge_arrays=False, split="stubs")
    for name in ("src", "dst", "edge_val", "src_int", "dst_int", "val_int", "src_bnd",
                 "dst_bnd", "val_bnd"):
        assert getattr(stubs, name).shape == (0,), name
    edges = shard_batch(shard, sg.denom, cpu, edge_arrays=False, split="edges")
    ki, kb = shard.num_int, shard.num_edges - shard.num_int
    np.testing.assert_array_equal(edges.src_int.numpy(), shard.src_int[:ki])
    np.testing.assert_array_equal(edges.dst_bnd.numpy(), shard.dst_bnd[:kb])
    np.testing.assert_array_equal(edges.val_bnd.numpy(), shard.val_bnd[:kb])
    assert edges.src.shape == (0,) and edges.src_bnd.dtype == torch.int32
    assert int(edges.src_bnd.max()) < sg.n_shards * sg.max_h


# ---- the engine ----


@pytest.fixture(scope="module")
def graph():
    return clustered_synthetic_graph(600, 8, 16, 5, seed=11, window=128, cut=0.2)


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
@pytest.mark.parametrize("n", [2, 4])
def test_edgewise_split_engine_matches_jax_and_single_device(graph, n, model, lr):
    """kernel="xla": overlap=True and "on" run the edgewise split, False
    (what JAX's auto resolves to off a TPU) the combined edgewise path. (The
    port's auto reads the card's table: tests/test_torch_port_switch_points.py.)"""
    base = dict(model=model, kernel="xla", learning_rate=lr, eval_every=1, reuse="off")
    runs = [(dict(base, overlap=True), 5, {"predict": True}),
            (dict(base, overlap="on"), 2, {}),
            (dict(base, overlap=False), 5, {})]
    res = spawn_local(n, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=240)
    for r in range(1, n):
        for a, b in zip(res[0], res[r]):
            assert a["losses"] == b["losses"]
    split, on, combined = res[0]
    assert (split["kernel"], split["overlap"], split["plan"]) == ("xla", True, "edge_split")
    assert on["plan"] == "edge_split" and on["losses"] == split["losses"][:2]
    assert (combined["overlap"], combined["plan"]) == (False, "edge_op")
    kw = dict(model=model, kernel="xla", learning_rate=lr, eval_every=1)
    jl, jeng = jax_sharded(graph, n, overlap=True, **kw)
    assert jeng.cfg.overlap and jeng.model.spmm_split is None and jeng.model.spmm_op is None
    loss_close(split["losses"], jl, model, False)
    loss_close(split["losses"], combined["losses"], model, False)
    single_l, single = port_single(graph, **kw)
    loss_close(split["losses"], single_l, model, False)
    want = single.predict()
    scale = float(np.abs(want).max())
    assert float(np.abs(split["predict"] - want).max()) <= \
        (1e-4 if model == "gcn" else 1e-3) * scale


def one_way_graph(v=240, seed=6):
    """Two halves under a 2-way range partition: every edge stays inside
    its half except edges from the second half into the first, so rank 1's
    shard has no boundary edge and receives no ghost row, while rank 0
    reads rank 1's rows."""
    rng = np.random.default_rng(seed)
    half = v // 2
    dst0 = rng.integers(0, half, size=6 * half)
    src0 = np.where(rng.random(6 * half) < 0.3, rng.integers(half, v, size=6 * half),
                    rng.integers(0, half, size=6 * half))
    dst1 = rng.integers(half, v, size=6 * half)
    src1 = rng.integers(half, v, size=6 * half)
    pairs = np.unique(np.stack([np.r_[src0, src1], np.r_[dst0, dst1]]), axis=1)
    return Graph(num_vertices=v, src=pairs[0].astype(np.int32), dst=pairs[1].astype(np.int32),
                 features=rng.normal(size=(v, 16)).astype(np.float32),
                 labels=(np.arange(v) % 5).astype(np.int32), num_classes=5).finalize()


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
def test_a_rank_without_boundary_edges_enters_every_collective(model, lr):
    """Every overlap plan on two ranks of which one has an empty boundary
    set: no hang (the launch has its own timeout; a rank that skipped the
    reverse all-to-all would leave its peer waiting), and the
    single-device trajectory."""
    g = one_way_graph()
    base = dict(model=model, learning_rate=lr, eval_every=1, reuse="off")
    runs = [(dict(base, kernel="degree"), 5, {}),
            (dict(base, kernel="xla", overlap=True), 5, {}),
            (dict(base, kernel="hyb"), 5, {}),
            (dict(base, kernel="hyb", reuse="pairs", reuse_max_pairs=0), 5, {})]
    res = spawn_local(2, ranks.engines_rank, (g, DIMS, runs), backend="gloo", device="cpu",
                      timeout_s=120)
    assert [r["boundary_edges"] for r in res[1]] == [0, 0, 0, 0]
    assert all(r["boundary_edges"] > 0 for r in res[0])
    assert [r["plan"] for r in res[0]] == ["pair", "edge_split", "fused", "ShardedReuseSpMM"]
    single_l, _ = port_single(g, model=model, kernel="hyb", learning_rate=lr, eval_every=1)
    for a, b in zip(res[0], res[1]):
        assert a["losses"] == b["losses"]
        loss_close(a["losses"], single_l, model, False)
