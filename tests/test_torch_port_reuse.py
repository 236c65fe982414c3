"""dorylus_tpu_torch's pair-reuse aggregation (`kernel="hyb", reuse="pairs"`)
against dorylus_tpu's on the same inputs (CPU).

Both packages mine with the shared `dorylus_tpu/graph/reuse.py`, so they
run the same rewrite; the port's CPU path is the plain torch version of the
pair-table build and of the mask pass. Tolerances: f32 output and dh rtol
1e-5, atol 1e-5 (only the summation order differs); bf16 gather tables
max abs error <= 2e-3 * max|ref|; the budget rule exactly; 5-epoch Engine
losses GCN atol 1e-4 (f32) / 1e-3 (bf16), GAT rtol 1e-5 (f32) / 5e-3
(bf16), as PERF.md section 2 states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.graph.graph import Graph, community_core_edges
from dorylus_tpu.ops import reuse_spmm as jreuse
from dorylus_tpu_torch.engine import engine as teng
from dorylus_tpu_torch.ops import hyb_spmm as thyb
from dorylus_tpu_torch.ops import reuse_spmm as treuse

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def community():
    """The 4,000-vertex community graph: two mining levels with passes=2."""
    return community_core_edges(4000, 20, comm=40, core=30, p_core=0.85, seed=0)


def _close(got, ref, narrow):
    got, ref = np.asarray(got), np.asarray(ref)
    if narrow:
        assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("passes", [1, 2])
def test_reuse_op_matches_jax(community, passes, narrow):
    """apply_static (GCN's rank-1 factorization) and apply_dst (GAT):
    forward, dh and d_dst against JAX's ReuseSpMM on the same rewrite."""
    src, dst = community
    v = 4000
    rng = np.random.default_rng(passes)
    f = rng.uniform(0.1, 1.0, v).astype(np.float32)
    jop = jreuse.ReuseSpMM(src, dst, v, v, rank1_factor=f, passes=passes,
                           gather_dtype=jnp.bfloat16 if narrow else None)
    top = treuse.ReuseSpMM(src, dst, v, v, rank1_factor=f, passes=passes,
                           gather_dtype=torch.bfloat16 if narrow else None, device="cpu")
    levels = [len(p) for p in top.plan_fwd.levels]
    assert levels == [len(p) for p in jop.plan_fwd.levels]
    assert len(levels) == passes and min(levels) > 1000
    h = rng.normal(0, 1, (v, 8)).astype(np.float32)
    gout = rng.normal(0, 1, (v, 8)).astype(np.float32)
    dst_val = rng.normal(0, 1, v).astype(np.float32)

    ref_s, vjp = jax.vjp(lambda hh: jop.apply_static(jop.arrays, hh), jnp.asarray(h))
    (ref_dh_s,) = vjp(jnp.asarray(gout))
    ref_d, vjp = jax.vjp(lambda hh, dv: jop.apply_dst(jop.arrays, hh, dv),
                         jnp.asarray(h), jnp.asarray(dst_val))
    ref_dh_d, ref_ddst = vjp(jnp.asarray(gout))

    hs = torch.tensor(h, requires_grad=True)
    out_s = top.apply_static(hs)
    out_s.backward(torch.tensor(gout))
    hd = torch.tensor(h, requires_grad=True)
    dv = torch.tensor(dst_val, requires_grad=True)
    out_d = top.apply_dst(hd, dv)
    out_d.backward(torch.tensor(gout))
    for got, ref in ((out_s.detach(), ref_s), (hs.grad, ref_dh_s),
                     (out_d.detach(), ref_d), (hd.grad, ref_dh_d), (dv.grad, ref_ddst)):
        _close(got, ref, narrow)


def test_reuse_plans_index_the_pair_table(community):
    """The rewritten plans gather from h plus the appended pair rows: their
    n_src is the table size, and the backward is its own rewrite."""
    src, dst = community
    op = treuse.ReuseSpMM(src, dst, 4000, 4000, passes=2, device="cpu")
    assert op.fwd["n_src"] == op.plan_fwd.table_size > 4000
    assert op.bwd["n_src"] == op.plan_bwd.table_size > 4000
    assert op.plan_fwd.stats["row_reduction"] > 0.25
    assert op.miner in ("native", "numpy") and min(op.mine_seconds) >= 0
    h = np.random.default_rng(2).normal(size=(4000, 3)).astype(np.float32)
    tbl = treuse.build_pair_table(torch.tensor(h, dtype=torch.float64),
                                  op.lvl_fwd, op.fwd_table_size)
    np.testing.assert_allclose(tbl.numpy(), op.plan_fwd.build_table_np(h.astype(np.float64)),
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="factorizable"):
        op.apply(torch.tensor(h), torch.ones(len(src)))
    with pytest.raises(RuntimeError, match="rank1_factor"):
        op.apply_static(torch.tensor(h))


def test_pair_kernel_path_raises_off_cuda(community):
    src, dst = community
    op = treuse.ReuseSpMM(src, dst, 4000, 4000, device="cpu")
    tbl = torch.zeros((op.fwd_table_size, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        treuse._launch_level(tbl, op.lvl_fwd[0], 4000)
    with pytest.raises(ValueError, match="unsupported device"):
        treuse.build_pair_table(torch.zeros((4000, 4), device="meta"), op.lvl_fwd,
                                op.fwd_table_size)
    assert treuse.PAIR_LAUNCHES == thyb.MASK_LAUNCHES == 0


@pytest.mark.parametrize("agg_dtype,base,width,overrides", [
    ("float32", 1000, 16, {}),                      # below the cliff: capped
    ("float32", 2_000_000, 16, {}),                 # past it: unlimited
    ("bfloat16", 1000, 41, {"reuse_passes": 2}),    # cap split over passes
    ("bfloat16", 900_000, 41, {}),                  # past the bf16 cliff
    ("float32", (64 << 20) // 64 - 500, 16, {}),    # under 1,024: off
    ("bfloat16", 1000, 41, {"reuse_max_pairs": 50}),  # explicit budget
], ids=["f32-below", "f32-past", "bf16-passes", "bf16-past", "f32-tiny", "explicit"])
def test_reuse_budget_matches_jax(agg_dtype, base, width, overrides):
    from dorylus_tpu.engine.engine import resolve_reuse_budget as jresolve

    cfg = TrainConfig(reuse="pairs", agg_dtype=agg_dtype, **overrides)
    assert teng.resolve_reuse_budget(cfg, base, width) == jresolve(cfg, base, width)


@pytest.mark.parametrize("model,agg,v", [
    ("gcn", "float32", 4000), ("gcn", "bfloat16", 1_000_000),
    ("gat", "bfloat16", 1_000_000), ("gat", "float32", 4000),
])
def test_max_agg_width_matches_jax(model, agg, v):
    """The width estimate, including the regime widening past the cliff
    (bf16, width 41 < 128, 1M rows)."""
    from dorylus_tpu.engine.engine import _max_agg_width as jwidth

    for dims in ([602, 128, 41], [100, 64, 41], [24, 12, 5]):
        layers = LayerConfig(dims)
        cfg = TrainConfig(model=model, agg_dtype=agg)
        assert teng._max_agg_width(layers, cfg, v) == jwidth(layers, cfg, v)


def _community_graph():
    src, dst = community_core_edges(800, 12, comm=40, core=20, p_core=0.85, seed=1)
    rng = np.random.default_rng(4)
    labels = ((np.arange(800) * 5) // 800).astype(np.int32)
    feats = rng.normal(0, 1, size=(800, 24)).astype(np.float32)
    feats += 0.6 * rng.normal(0, 1, size=(5, 24)).astype(np.float32)[labels]
    return Graph(num_vertices=800, src=src, dst=dst, features=feats,
                 labels=labels, num_classes=5).finalize()


@pytest.mark.parametrize("model,agg_dtype", [
    ("gcn", "float32"), ("gcn", "bfloat16"), ("gat", "float32"), ("gat", "bfloat16"),
], ids=["gcn-f32", "gcn-bf16", "gat-f32", "gat-bf16"])
def test_engine_reuse_matches_jax(model, agg_dtype):
    """5-epoch trajectories on kernel="hyb", reuse="pairs": the same auto
    pair budget, the same mined pairs, the same losses."""
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = _community_graph()
    layers = LayerConfig([24, 12, 5])
    cfg = TrainConfig(epochs=5, eval_every=1, kernel="hyb", reuse="pairs",
                      reuse_passes=2, model=model, agg_dtype=agg_dtype,
                      compile_cache="off",
                      learning_rate=0.005 if model == "gat" else 0.01)
    jeng = JEngine(g, layers, cfg)
    tengine = teng.Engine(g, layers, cfg, device="cpu")
    top = tengine.model.spmm_op
    assert isinstance(top, treuse.ReuseSpMM)
    assert top.plan_fwd.num_pairs == jeng.model.spmm_op.plan_fwd.num_pairs > 0
    assert tengine.batch.src.shape[0] == 0
    jl = [e.loss for e in jeng.run().epochs]
    trep = tengine.run()
    tl = [e.loss for e in trep.epochs]
    bf16 = agg_dtype == "bfloat16"
    if model == "gcn":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3 if bf16 else 1e-4)
    else:
        np.testing.assert_allclose(tl, jl, rtol=5e-3 if bf16 else 1e-5)
    assert trep.notes["kernel"] == "hyb"
