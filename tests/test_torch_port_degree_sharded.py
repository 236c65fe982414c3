"""The port's sharded degree path against the JAX package, on the CPU:

  * `ShardedDegreeSpMM` (ops/degree_sharded.py), each rank's combined,
    interior and boundary plans, against JAX's op on the same shard (one
    slice of its stacked arrays) and the same table: `apply_static`,
    `apply_dst` and `apply`, outputs and the gradients of the table, dst_val
    and val. The port plans over the shard's real edges, JAX over the
    padded ones with the pads silenced: the sums are the same;
  * the interior and boundary passes add up to the combined one; a plan
    without edges returns zeros and a defined zero gradient;
  * `ShardedEngine` with kernel="degree" on 2 and 4 gloo ranks, the
    (interior, boundary) pair (overlap auto) and the combined plan, against
    the JAX `ShardedEngine` and the port's single-device `Engine`, and on the
    uneven hub graph.

Tolerances: ops in f32 1e-5 relative to max|ref| (summation orders differ),
with bf16 gather tables <= 2e-3 * max|ref|. Engines over 5 epochs: GCN loss
atol 1e-4 (f32) / 1e-3 (bf16); GAT rtol 1e-5 / 5e-3 (its losses are O(100)
at init; the pair sums two bf16-table passes where the combined plan rounds
one, inside the bf16 limit). Every multi-process run has its own timeout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.graph.graph import clustered_synthetic_graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.ops.degree_sharded import ShardedDegreeSpMM as JShardedDegreeSpMM
from dorylus_tpu_torch.graph.partition import shard_edges
from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
from dorylus_tpu_torch.parallel.multihost import spawn_local
from test_torch_port_sharded import (DIMS, close, hub_graph, jax_sharded, loss_close,
                                     port_single, t32)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")

EDGE_SETS = ("combined", "interior", "boundary")


@pytest.fixture(scope="module")
def sharded():
    return partition_graph(hub_graph(), 4, method="hash")  # heavy cut


def table_for(edges, h, gh):
    return {"combined": np.concatenate([h, gh]), "interior": h, "boundary": gh}[edges]


def jax_edge_count(shard, edges):
    return len({"combined": shard.src, "interior": shard.src_int,
                "boundary": shard.src_bnd}[edges])


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edges", EDGE_SETS)
def test_sharded_degree_op_matches_jax(sharded, edges, narrow):
    sg = sharded
    n, vp, mh = sg.n_shards, sg.vp, sg.max_h
    jgd, tgd = (jnp.bfloat16, torch.bfloat16) if narrow else (None, None)
    jops = {static: JShardedDegreeSpMM(sg, edges=edges, static_vals=static, gather_dtype=jgd)
            for static in (True, False)}
    rng = np.random.default_rng(3)
    f = 6
    for s, shard in enumerate(sg.shards):
        h = rng.normal(size=(vp, f)).astype(np.float32)
        gh = rng.normal(size=(n * mh, f)).astype(np.float32)
        table = table_for(edges, h, gh)
        dv = rng.normal(size=vp).astype(np.float32)
        gout = rng.normal(size=(vp, f)).astype(np.float32)
        for static in (True, False):
            top = ShardedDegreeSpMM(shard, n, edges=edges, static_vals=static,
                                    gather_dtype=tgd, device="cpu")
            assert (top.num_in, top.num_out) == (table.shape[0], vp)
            ja = jax.tree.map(lambda v: v[s], jops[static].arrays)
            jop = jops[static]
            tt, td = t32(table, True), t32(dv, True)
            if static:
                out = top.apply_static(tt)
                jout, vjp = jax.vjp(lambda t: jop.apply_static(ja, t), jnp.asarray(table))
            else:
                out = top.apply_dst(tt, td)
                jout, vjp = jax.vjp(lambda t, d: jop.apply_dst(ja, t, d),
                                    jnp.asarray(table), jnp.asarray(dv))
            out.backward(t32(gout))
            jg = vjp(jnp.asarray(gout))
            close(out.detach(), jout, narrow)
            close(tt.grad, jg[0], narrow)
            if not static:
                close(td.grad, jg[1], narrow)
        # per-edge values through the op without static values: the port
        # takes the set's real edges, JAX its padded edge array
        e = top.num_edges
        val = rng.normal(size=e).astype(np.float32)
        jval = np.zeros(jax_edge_count(shard, edges), np.float32)
        jval[:e] = val
        tt, tv = t32(table, True), t32(val, True)
        out = top.apply(tt, tv)
        out.backward(t32(gout))
        jout, vjp = jax.vjp(lambda t, v: jop.apply(ja, t, v), jnp.asarray(table),
                            jnp.asarray(jval))
        jg = vjp(jnp.asarray(gout))
        close(out.detach(), jout, narrow)
        close(tt.grad, jg[0], narrow)
        close(tv.grad, np.asarray(jg[1])[:e], narrow)


def test_shard_edges_is_the_partitions_split(sharded):
    """The split the ranks derive from the combined arrays is the one
    `partition_graph` lays out (the JAX op's input), array for array."""
    for shard in sharded.shards:
        ki, kb = shard.num_int, shard.num_edges - shard.num_int
        for got, want in zip(shard_edges(shard, "interior"),
                             (shard.src_int[:ki], shard.dst_int[:ki], shard.val_int[:ki])):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(shard_edges(shard, "boundary"),
                             (shard.src_bnd[:kb], shard.dst_bnd[:kb], shard.val_bnd[:kb])):
            np.testing.assert_array_equal(got, want)
        assert len(shard_edges(shard, "combined")[0]) == shard.num_edges
    with pytest.raises(ValueError, match="edges='fused'"):
        shard_edges(sharded.shards[0], "fused")


@pytest.mark.parametrize("static", [True, False], ids=["gcn", "gat"])
def test_interior_plus_boundary_is_the_combined_pass(sharded, static):
    sg = sharded
    n, vp, mh = sg.n_shards, sg.vp, sg.max_h
    rng = np.random.default_rng(5)
    for shard in sg.shards:
        ops = {e: ShardedDegreeSpMM(shard, n, edges=e, static_vals=static, device="cpu")
               for e in EDGE_SETS}
        h, gh = t32(rng.normal(size=(vp, 7))), t32(rng.normal(size=(n * mh, 7)))
        dv = t32(rng.normal(size=vp))
        if static:
            both = ops["interior"].apply_static(h) + ops["boundary"].apply_static(gh)
            want = ops["combined"].apply_static(torch.cat([h, gh]))
        else:
            both = ops["interior"].apply_dst(h, dv) + ops["boundary"].apply_dst(gh, dv)
            want = ops["combined"].apply_dst(torch.cat([h, gh]), dv)
        close(both, want, False)
        assert sum(ops[e].num_edges for e in ("interior", "boundary")) == shard.num_edges


def test_plan_without_edges_gives_zeros_and_a_zero_gradient(sharded):
    """A rank without boundary edges: the boundary op returns zeros of the
    right shape and hands the exchange a defined zero gradient (never
    None), through every entry."""
    shard = sharded.shards[0]
    n, vp = sharded.n_shards, sharded.vp
    e = shard.num_edges
    keep = np.asarray(shard.src[:e]) < vp
    local = dataclasses.replace(shard, src=shard.src[:e][keep], dst=shard.dst[:e][keep],
                                edge_val=shard.edge_val[:e][keep], num_edges=int(keep.sum()))
    for static in (True, False):
        op = ShardedDegreeSpMM(local, n, edges="boundary", static_vals=static, device="cpu")
        assert op.num_edges == 0 and op.num_in == n * sharded.max_h
        entries = [lambda g: op.apply_dst(g, torch.ones(vp)), op.apply_unit,
                   lambda g: op.apply(g, torch.zeros(0))]
        for entry in ([op.apply_static] if static else []) + entries:
            ghosts = torch.ones((op.num_in, 3), requires_grad=True)
            out = entry(ghosts)
            assert out.shape == (vp, 3) and float(out.detach().abs().max()) == 0.0
            out.sum().backward()
            assert ghosts.grad is not None and ghosts.grad.shape == ghosts.shape
            assert float(ghosts.grad.abs().max()) == 0.0
        inner = ShardedDegreeSpMM(local, n, edges="interior", static_vals=static, device="cpu")
        assert inner.num_edges == local.num_edges


# ---- the engine ----


@pytest.fixture(scope="module")
def graph():
    return clustered_synthetic_graph(600, 8, 16, 5, seed=11, window=128, cut=0.2)


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
@pytest.mark.parametrize("n", [2, 4])
def test_degree_engine_matches_jax_and_single_device(graph, n, model, lr):
    """kernel="degree": overlap auto -> the (interior, boundary) pair, in
    f32 and with bf16 gather tables, then overlap off (the combined plan),
    in one launch of n ranks; against JAX's sharded engine (which builds
    the same pair) and the port's single-device engine."""
    base = dict(model=model, kernel="degree", learning_rate=lr, eval_every=1)
    runs = [(dict(base), 5, {"predict": True}),
            (dict(base, agg_dtype="bfloat16"), 5, {}),
            (dict(base, overlap=False), 5, {})]
    res = spawn_local(n, ranks.engines_rank,
                      (graph, DIMS, [(dict(k, reuse="off"), e, o) for k, e, o in runs]),
                      backend="gloo", device="cpu", timeout_s=240)
    for r in range(1, n):
        for a, b in zip(res[0], res[r]):
            assert a["losses"] == b["losses"] and a["val_acc"] == b["val_acc"]
    pair, bf16, combined = res[0]
    assert (pair["kernel"], pair["overlap"], pair["plan"]) == ("degree", True, "pair")
    assert (combined["overlap"], combined["plan"]) == (False, "ShardedDegreeSpMM")
    jl, jeng = jax_sharded(graph, n, **base)
    assert isinstance(jeng.model.spmm_split, tuple)
    loss_close(pair["losses"], jl, model, False)
    loss_close(pair["losses"], port_single(graph, **base)[0], model, False)
    loss_close(combined["losses"], pair["losses"], model, False)
    if n == 4:
        jl16, _ = jax_sharded(graph, n, agg_dtype="bfloat16", **base)
        loss_close(bf16["losses"], jl16, model, True)
    else:
        loss_close(bf16["losses"], pair["losses"], model, True)
    jp = jeng.predict()
    scale = float(np.abs(jp).max())
    for r in range(n):
        got = res[r][0]["predict"]
        assert got.shape == (graph.num_vertices, DIMS[-1])
        assert float(np.abs(got - jp).max()) <= (1e-4 if model == "gcn" else 1e-3) * scale


def test_degree_pair_on_the_uneven_hub_graph():
    """V = 403 on 4 ranks: uneven shards and hub rows; the pair trains the
    single-device trajectory and predict() is in global order."""
    g = hub_graph()
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        base = dict(model=model, kernel="degree", learning_rate=lr, eval_every=1)
        res = spawn_local(4, ranks.engine_rank,
                          (g, DIMS, dict(base, reuse="off"), 5, {"predict": True}),
                          backend="gloo", device="cpu", timeout_s=240)
        assert res[0]["plan"] == "pair"
        single_l, single = port_single(g, **base)
        loss_close(res[0]["losses"], single_l, model, False)
        want = single.predict()
        scale = float(np.abs(want).max())
        assert float(np.abs(res[0]["predict"] - want).max()) <= \
            (1e-4 if model == "gcn" else 1e-3) * scale
