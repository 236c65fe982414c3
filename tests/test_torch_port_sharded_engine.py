"""The port's `ShardedEngine` (parallel/train_step.py) on 2 and 4 gloo ranks
against the JAX `ShardedEngine` on a 2- and 4-device virtual CPU mesh and
against the port's single-device `Engine`: loss trajectories, `predict` in
global vertex order, overlap on against off, both halo wires,
kernel="auto" resolving to the edgewise path on a small shard, and a hub
graph whose vertex count does not divide by the ranks.

Tolerances over 5 epochs: GCN train loss atol 1e-4 in f32 and 1e-3 with
bf16 gather tables; GAT, whose losses are O(100) at init, rtol 1e-5 in f32
and 5e-3 in bf16 (only summation orders differ in f32; ~1e-3 relative per
bf16 pass).

Every multi-process run has its own timeout and a file:// rendezvous in a
fresh temp directory (parallel/multihost.py `spawn_local`).
"""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.graph.graph import clustered_synthetic_graph
from dorylus_tpu_torch.parallel.multihost import spawn_local
from test_torch_port_sharded import (DIMS, hub_graph, jax_sharded, loss_close,
                                     port_single)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")


@pytest.fixture(scope="module")
def graph():
    return clustered_synthetic_graph(600, 8, 16, 5, seed=11, window=128, cut=0.2)


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_engine_matches_jax_and_single_device(graph, n, model, lr):
    """kernel="hyb" (overlap auto -> the fused plan, the exact wire) in
    f32 and with bf16 gather tables, then overlap off (the combined plan)
    and the padded wire, all in one launch of n ranks."""
    base = dict(model=model, kernel="hyb", learning_rate=lr, eval_every=1)
    runs = [(dict(base), 5, {"predict": True}),
            (dict(base, agg_dtype="bfloat16"), 5, {}),
            (dict(base, overlap=False), 5, {}),
            (dict(base, halo="padded"), 5, {})]
    res = spawn_local(n, ranks.engines_rank, (graph, DIMS, [(dict(k, reuse="off"), e, o)
                                                           for k, e, o in runs]),
                      backend="gloo", device="cpu", timeout_s=240)
    for r in range(1, n):  # replicated: every rank reports the same numbers
        for a, b in zip(res[0], res[r]):
            assert a["losses"] == b["losses"] and a["val_acc"] == b["val_acc"]
    f32, bf16, combined, padded = res[0]
    assert (f32["kernel"], f32["overlap"], f32["wire"]) == ("hyb", True, "ragged")
    assert (combined["overlap"], padded["wire"]) == (False, "padded")
    jl, jeng = jax_sharded(graph, n, **base)
    assert getattr(jeng.model.spmm_split, "fused", False)
    loss_close(f32["losses"], jl, model, False)
    loss_close(f32["losses"], port_single(graph, **base)[0], model, False)
    jl16, _ = jax_sharded(graph, n, agg_dtype="bfloat16", **base)
    loss_close(bf16["losses"], jl16, model, True)
    # the combined plan and the padded wire compute the same sums
    loss_close(combined["losses"], f32["losses"], model, False)
    loss_close(padded["losses"], f32["losses"], model, False)
    # predictions in global vertex order, on every rank
    jp = jeng.predict()
    scale = float(np.abs(jp).max())
    for r in range(n):
        got = res[r][0]["predict"]
        assert got.shape == (graph.num_vertices, DIMS[-1])
        assert float(np.abs(got - jp).max()) <= (1e-4 if model == "gcn" else 1e-3) * scale
    assert abs(f32["val_acc"] - jeng.report.final_accuracy) <= 2.0 / (0.1 * graph.num_vertices)


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
def test_auto_resolves_to_the_edgewise_path_on_a_small_shard(graph, model, lr):
    """kernel="auto" under 8M edges per shard: the edgewise path; with the
    overlap JAX's auto resolves to off a TPU (False, given explicitly: the
    port's auto reads the card's table), the combined path over
    halo_exchange's table, as JAX's engine."""
    base = dict(model=model, learning_rate=lr, eval_every=1)
    res = spawn_local(4, ranks.engine_rank,
                      (graph, DIMS, dict(base, overlap=False, reuse="off"), 5, {}),
                      backend="gloo", device="cpu", timeout_s=240)
    assert (res[0]["kernel"], res[0]["overlap"]) == ("xla", False)
    jl, jeng = jax_sharded(graph, 4, **base)
    assert jeng.cfg.kernel == "xla" and not jeng.cfg.overlap
    loss_close(res[0]["losses"], jl, model, False)
    loss_close(res[0]["losses"], port_single(graph, kernel="hyb", **base)[0], model, False)


@pytest.mark.parametrize("n", [2, 4])
def test_hub_graph_with_uneven_shards(n):
    """V = 403 does not divide by the ranks, so the last shard is padded
    and the ranks hold uneven edge counts: both models train the
    single-device trajectory and JAX's, and predict() places every
    shard's rows, the last local vertex included, in global order. (The
    hub top under an uneven hub split is held against JAX per shard in
    test_torch_port_sharded.py, at max_width=16.)"""
    g = hub_graph()
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        base = dict(model=model, kernel="hyb", learning_rate=lr, eval_every=1)
        res = spawn_local(n, ranks.engine_rank,
                          (g, DIMS, dict(base, reuse="off"), 5, {"predict": True}),
                          backend="gloo", device="cpu", timeout_s=240)
        single_l, single = port_single(g, **base)
        loss_close(res[0]["losses"], single_l, model, False)
        jl, jeng = jax_sharded(g, n, **base)
        loss_close(res[0]["losses"], jl, model, False)
        want = single.predict()
        scale = float(np.abs(want).max())
        assert float(np.abs(res[0]["predict"] - want).max()) <= \
            (1e-4 if model == "gcn" else 1e-3) * scale
