"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (hybrid-ELL static mode), K2 (mask mode: apply_unit, apply_dst), the
edgewise K3 (CSR SpMM), K4 (SDDMM), K5 (sorted segment-sum), K7 (dynamic
values with the fused SDDMM) on hybrid-ELL and degree plans, K1/K2 on
degree plans, K6 (the pair-table build) with K2 over a rewritten plan, and
the sharded engine's K8 (two-table hyb pass), K9 (row gather) and K10
(gathered sorted segment-sum), with a 4-rank run on the one card (gloo).

Marked `gpu`: each test skips where torch sees no CUDA device (the kernel
has no CPU or interpret mode). On a machine with a card and without jax:

    DORYLUS_TEST_TPU=1 python -m pytest -o addopts="" -p no:cacheprovider \
        tests/test_torch_port_gpu.py -q

(DORYLUS_TEST_TPU=1 keeps tests/conftest.py from importing jax.)

Tolerances, max abs error over max |plain|: f32 1e-4, bf16 1e-2 (the
kernels round as the plain versions do; only summation orders differ).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _powerlaw(v, seed):
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, v), 300)
    dst = np.sort(np.repeat(rng.permutation(v).astype(np.int32), deg))
    src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    val = rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    return src, dst, val


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_kernel_matches_plain(cuda, narrow, f):
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    src, dst, val = _powerlaw(3000, seed=f)
    gd = torch.bfloat16 if narrow else None
    op = hyb.HybSpMM(src, dst, 3000, 3000, max_width=16, gather_dtype=gd,
                     static_val=val, lam_slots=256, device=cuda)
    assert op.fwd["top"] is not None and "inv" in op.fwd
    rng = np.random.default_rng(1)
    h = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    before = hyb.KERNEL_LAUNCHES
    hk = h.clone().requires_grad_(True)
    out = op.apply_static(hk)
    out.backward(gout)
    torch.cuda.synchronize()
    assert hyb.KERNEL_LAUNCHES > before
    tol = 1e-2 if narrow else 1e-4
    for got, ref in ((out.detach(), hyb.hyb_static_pass_plain(h, op.fwd, 3000, gd)),
                     (hk.grad, hyb.hyb_static_pass_plain(gout, op.bwd, 3000, gd))):
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_kernel_refuses_what_it_does_not_take(cuda):
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    src, dst, val = _powerlaw(500, seed=3)
    op = hyb.HybSpMM(src, dst, 500, 500, static_val=val, device=cuda)
    part = op.fwd["buckets"][0]
    out = torch.zeros((500, 8), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        hyb._launch_part(torch.zeros((500, 8), dtype=torch.float16, device=cuda),
                         part, out)
    with pytest.raises(ValueError, match="differs"):
        hyb._launch_part(torch.zeros((500, 8), dtype=torch.bfloat16, device=cuda),
                         part, out)
    with pytest.raises(ValueError, match="contiguous"):
        hyb._launch_part(torch.zeros((8, 500), device=cuda).t(), part, out)
    with pytest.raises(ValueError, match="source rows"):
        hyb.hyb_static_pass(torch.zeros((10, 8), device=cuda), op.fwd, 500)


def _close(got, ref, narrow):
    tol = 1e-2 if narrow else 1e-4
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - ref.float()).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_mask_kernel_matches_plain(cuda, narrow, f):
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    src, dst, _ = _powerlaw(3000, seed=f + 5)
    gd = torch.bfloat16 if narrow else None
    op = hyb.HybSpMM(src, dst, 3000, 3000, max_width=16, gather_dtype=gd,
                     lam_slots=256, device=cuda)
    assert op.fwd["top"] is not None and "inv" in op.fwd
    rng = np.random.default_rng(2)
    h = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    dst_val = torch.tensor(rng.normal(size=3000).astype(np.float32), device=cuda)
    before = hyb.MASK_LAUNCHES
    hk = h.clone().requires_grad_(True)
    dk = dst_val.clone().requires_grad_(True)
    out = op.apply_dst(hk, dk)
    out.backward(gout)
    torch.cuda.synchronize()
    assert hyb.MASK_LAUNCHES > before
    u = hyb.hyb_mask_pass_plain(h, op.fwd, 3000, gd)
    _close(out.detach(), u * dst_val[:, None], narrow)
    _close(hk.grad, hyb.hyb_mask_pass_plain(gout * dst_val[:, None], op.bwd, 3000, gd),
           narrow)
    _close(dk.grad, (u * gout).sum(-1), narrow)
    _close(hyb.hyb_mask_pass(h, op.fwd, 3000, gd), u, narrow)


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_edge_kernels_match_plain(cuda, narrow, f):
    from dorylus_tpu_torch.ops import spmm

    src, dst, val = _powerlaw(3000, seed=f + 9)
    dst[:40] = 0  # empty rows are the rule already; add a 40+-edge row 0
    dst = np.sort(dst)
    op = spmm.EdgeSpMM(src, dst, 3000, 3000, device=cuda)
    dt = torch.bfloat16 if narrow else torch.float32
    rng = np.random.default_rng(3)
    h = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda).to(dt)
    gout = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32),
                        device=cuda).to(dt)
    s_t = torch.tensor(src, device=cuda)
    d_t = torch.tensor(dst, device=cuda)
    v_t = torch.tensor(val, device=cuda)
    counts = (spmm.SPMM_LAUNCHES, spmm.SDDMM_LAUNCHES)
    hk = h.clone().requires_grad_(True)
    vk = v_t.clone().requires_grad_(True)
    out = spmm.spmm_edgewise(hk, s_t, d_t, vk, 3000, op=op)
    out.backward(gout)
    torch.cuda.synchronize()
    assert (spmm.SPMM_LAUNCHES, spmm.SDDMM_LAUNCHES) == (counts[0] + 2, counts[1] + 1)
    _close(out.detach(), spmm.csr_spmm_plain(h, op.row_ptr, s_t, v_t), narrow)
    _close(hk.grad, spmm.csr_spmm_plain(gout, op.t_row_ptr, op.t_col, v_t, op.order),
           narrow)
    _close(vk.grad, spmm.sddmm_plain(h, gout, op.row_ptr, s_t), narrow)
    g_e = torch.tensor(rng.normal(size=(len(dst),) + ((f,) if f > 1 else ())
                                  ).astype(np.float32), device=cuda).to(dt)
    before = spmm.SEGSUM_LAUNCHES
    _close(spmm.segment_sum(g_e, op.row_ptr), spmm.segment_sum_plain(g_e, op.row_ptr),
           narrow)
    assert spmm.SEGSUM_LAUNCHES == before + 1


def test_edge_kernels_refuse_what_they_do_not_take(cuda):
    from dorylus_tpu_torch.ops import spmm

    src, dst, val = _powerlaw(500, seed=4)
    op = spmm.EdgeSpMM(src, dst, 500, 500, device=cuda)
    s_t = torch.tensor(src, device=cuda)
    v_t = torch.tensor(val, device=cuda)
    out = torch.zeros((500, 8), device=cuda)
    before = (spmm.SPMM_LAUNCHES, spmm.SDDMM_LAUNCHES, spmm.SEGSUM_LAUNCHES)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_csr_spmm(torch.zeros((500, 8), dtype=bad, device=cuda),
                                  op.row_ptr, s_t, v_t, None, out)
        t = torch.zeros((500, 8), dtype=bad, device=cuda)
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_sddmm(t, t, op.row_ptr, s_t, torch.zeros(len(src), device=cuda))
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_segment_sum(v_t.to(bad), op.row_ptr, torch.zeros(500, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm._launch_csr_spmm(torch.zeros((8, 500), device=cuda).t(), op.row_ptr,
                              s_t, v_t, None, out)
    assert (spmm.SPMM_LAUNCHES, spmm.SDDMM_LAUNCHES, spmm.SEGSUM_LAUNCHES) == before


def _dyn_close_all(res, narrow):
    for got, ref in res:
        _close(got, ref, narrow)


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_dyn_kernel_matches_plain(cuda, narrow, f):
    """K7 on hybrid-ELL plans with hub rows and the inv layout: forward,
    dh and dval (F = 300 walks three column tiles in one warp)."""
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    src, dst, val = _powerlaw(3000, seed=f + 11)
    gd = torch.bfloat16 if narrow else None
    op = hyb.HybSpMM(src, dst, 3000, 3000, max_width=16, gather_dtype=gd,
                     lam_slots=256, dynamic=True, device=cuda)
    assert op.fwd["top"] is not None and "inv" in op.fwd
    rng = np.random.default_rng(6)
    h = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    v_t = torch.tensor(val, device=cuda)
    before = hyb.DYN_LAUNCHES
    hk = h.clone().requires_grad_(True)
    vk = v_t.clone().requires_grad_(True)
    out = op.apply(hk, vk)
    out.backward(gout)
    torch.cuda.synchronize()
    assert hyb.DYN_LAUNCHES > before
    ref_dh, ref_dval = hyb.hyb_dynamic_pass_plain(gout, op.bwd, 3000, v_t, gd, other=h)
    _dyn_close_all([(out.detach(), hyb.hyb_dynamic_pass_plain(h, op.fwd, 3000, v_t, gd)),
                    (hk.grad, ref_dh), (vk.grad, ref_dval)], narrow)


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_degree_kernels_match_plain(cuda, narrow, f):
    """K1 (static), K2 (unit, dst) and K7 (dynamic, with dval) on degree
    plans against the plain degree pass, on a graph with isolated rows
    and vertices of many block rows."""
    from dorylus_tpu_torch.ops import degree_spmm as deg

    src, dst, val = _powerlaw(3000, seed=f + 13)
    keep = dst % 7 != 0  # every seventh vertex loses its in-edges
    src, dst, val = src[keep], dst[keep], val[keep]
    assert (np.bincount(dst, minlength=3000) == 0).any()
    gd = torch.bfloat16 if narrow else None
    op = deg.DegreeSpMM(src, dst, 3000, 3000, gather_dtype=gd, static_val=val,
                        device=cuda)
    rng = np.random.default_rng(7)
    h = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda)
    v_t = torch.tensor(val, device=cuda)
    dst_val = torch.tensor(rng.normal(size=3000).astype(np.float32), device=cuda)
    before = deg.DEGREE_LAUNCHES

    def plain(table, plan, mode, other=None):
        return deg.degree_pass_plain(table, plan, 3000, gd, mode, v_t, other)

    hs = h.clone().requires_grad_(True)
    out_s = op.apply_static(hs)
    out_s.backward(gout)
    hd = h.clone().requires_grad_(True)
    dd = dst_val.clone().requires_grad_(True)
    out_d = op.apply_dst(hd, dd)
    out_d.backward(gout)
    hy = h.clone().requires_grad_(True)
    vy = v_t.clone().requires_grad_(True)
    out_y = op.apply(hy, vy)
    out_y.backward(gout)
    torch.cuda.synchronize()
    assert deg.DEGREE_LAUNCHES == before + 6
    u = plain(h, op.fwd, "mask")
    ref_dh, ref_dval = plain(gout, op.bwd, "dynamic", other=h)
    _dyn_close_all([(out_s.detach(), plain(h, op.fwd, "static")),
                    (hs.grad, plain(gout, op.bwd, "static")),
                    (out_d.detach(), u * dst_val[:, None]),
                    (hd.grad, plain(gout * dst_val[:, None], op.bwd, "mask")),
                    (dd.grad, (u * gout).sum(-1)),
                    (out_y.detach(), plain(h, op.fwd, "dynamic")),
                    (hy.grad, ref_dh), (vy.grad, ref_dval)], narrow)


@pytest.mark.parametrize("f", [128, 41])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_pair_kernel_and_reuse_pass_match_plain(cuda, narrow, f):
    """K6 builds the two-level pair table exactly as the plain version
    (one rounding per row), and the reuse op's K2 passes over it match
    the plain mask pass, forward and dh; at a width that fills the warp
    and at one with a tail of columns."""
    from dorylus_tpu_torch.graph.graph import community_core_edges
    from dorylus_tpu_torch.ops import hyb_spmm as hyb
    from dorylus_tpu_torch.ops import reuse_spmm as reuse

    src, dst = community_core_edges(4000, 20, comm=40, core=30, p_core=0.85, seed=0)
    gd = torch.bfloat16 if narrow else None
    op = reuse.ReuseSpMM(src, dst, 4000, 4000, passes=2, gather_dtype=gd, device=cuda)
    assert len(op.lvl_fwd) == 2
    rng = np.random.default_rng(8)
    dt = torch.bfloat16 if narrow else torch.float32
    h = torch.tensor(rng.normal(size=(4000, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(4000, f)).astype(np.float32), device=cuda)
    before = reuse.PAIR_LAUNCHES
    tbl = reuse.build_pair_table(h.to(dt), op.lvl_fwd, op.fwd_table_size)
    torch.cuda.synchronize()
    assert reuse.PAIR_LAUNCHES == before + 2
    assert torch.equal(tbl, reuse.build_pair_table_plain(h.to(dt), op.lvl_fwd))
    hk = h.clone().requires_grad_(True)
    out = op.apply_unit(hk)
    out.backward(gout)
    torch.cuda.synchronize()
    _close(out.detach(), hyb.hyb_mask_pass_plain(
        reuse.build_pair_table_plain(h, op.lvl_fwd), op.fwd, 4000, gd), narrow)
    _close(hk.grad, hyb.hyb_mask_pass_plain(
        reuse.build_pair_table_plain(gout, op.lvl_bwd), op.bwd, 4000, gd), narrow)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    """K6, K7 and the degree passes raise on float16 and float64 tables and
    count no launch; none falls back to its plain version."""
    from dorylus_tpu_torch.graph.graph import community_core_edges
    from dorylus_tpu_torch.ops import degree_spmm as deg
    from dorylus_tpu_torch.ops import hyb_spmm as hyb
    from dorylus_tpu_torch.ops import reuse_spmm as reuse

    src, dst, val = _powerlaw(500, seed=5)
    hop = hyb.HybSpMM(src, dst, 500, 500, dynamic=True, device=cuda)
    dop = deg.DegreeSpMM(src, dst, 500, 500, static_val=val, device=cuda)
    csrc, cdst = community_core_edges(1000, 20, comm=40, core=30, seed=0)
    rop = reuse.ReuseSpMM(csrc, cdst, 1000, 1000, device=cuda)
    v_t = torch.tensor(val, device=cuda)
    out = torch.zeros((500, 8), device=cuda)
    counts = (hyb.KERNEL_LAUNCHES, hyb.MASK_LAUNCHES, hyb.DYN_LAUNCHES,
              deg.DEGREE_LAUNCHES, reuse.PAIR_LAUNCHES)
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((500, 8), dtype=bad, device=cuda)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_part(tb, hop.fwd["buckets"][0], v_t, out)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_part(tb.float(), hop.fwd["buckets"][0], v_t.to(bad), out)
        for unit in (False, True):
            with pytest.raises(ValueError, match="dtype"):
                hyb._launch_part(tb, dop.fwd["part"], out, unit=unit)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_part(tb, dop.fwd["part"], v_t, out)
        with pytest.raises(ValueError, match="dtype"):
            reuse.build_pair_table(torch.zeros((1000, 8), dtype=bad, device=cuda),
                                   rop.lvl_fwd, rop.fwd_table_size)
    assert (hyb.KERNEL_LAUNCHES, hyb.MASK_LAUNCHES, hyb.DYN_LAUNCHES,
            deg.DEGREE_LAUNCHES, reuse.PAIR_LAUNCHES) == counts


# ---- the sharded engine's kernels: K8, K9, K10 ----


def _hub_shard(n=4, v=1203, seed=5):
    """A power-law graph (V not divisible by n) whose hubs sit near the
    cut, partitioned n ways: (shards, n) with hub rows on every shard."""
    from dorylus_tpu_torch.graph.graph import Graph
    from dorylus_tpu_torch.graph.partition import partition_graph

    src, dst, _ = _powerlaw(v, seed)
    rng = np.random.default_rng(seed)
    g = Graph(num_vertices=v, src=src, dst=dst,
              features=rng.normal(size=(v, 8)).astype(np.float32),
              labels=(np.arange(v) % 3).astype(np.int32), num_classes=3).finalize()
    return partition_graph(g, n)


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "mask"])
def test_fused_kernel_matches_plain(cuda, static, narrow, f):
    """K8 through the fused entries: forward, dh, dghosts (and d_dst in
    mask mode) against the plain passes on the same CUDA tensors."""
    from dorylus_tpu_torch.ops import hyb_sharded as hs
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    sg = _hub_shard()
    shard = sg.shards[1]
    gd = torch.bfloat16 if narrow else None
    op = hs.ShardedHybSpMM(shard, sg.n_shards, edges="fused", static_vals=static,
                           gather_dtype=gd, max_width=16, lam_slots=256, device=cuda)
    assert op.n_pure > 0 and op.fwd["top"] is not None
    rng = np.random.default_rng(f)
    vp, ng = op.vp, op.table - op.vp
    h = torch.tensor(rng.normal(size=(vp, f)).astype(np.float32), device=cuda)
    gh = torch.tensor(rng.normal(size=(ng, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(vp, f)).astype(np.float32), device=cuda)
    dv = torch.tensor(rng.normal(size=vp).astype(np.float32), device=cuda)
    before = hs.FUSED_LAUNCHES
    hk, gk, dk = (t.clone().requires_grad_(True) for t in (h, gh, dv))
    mode = "static" if static else "mask"
    out = op.apply_static_fused(hk, gk) if static else op.apply_dst_fused(hk, gk, dk)
    out.backward(gout)
    torch.cuda.synchronize()
    assert hs.FUSED_LAUNCHES > before
    u = hs.fused_pass_plain(h, gh, op.fwd, op.n_pure, gd, mode)
    scale = 1.0 if static else dv[:, None]
    _close(out.detach(), u * scale, narrow)
    dfull = hyb._hyb_pass_plain(gout * scale, op.bwd, op.table, gd, mode)
    _close(hk.grad, dfull[:vp], narrow)
    _close(gk.grad, dfull[vp:], narrow)
    if not static:
        _close(dk.grad, (u * gout).sum(-1), narrow)


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_halo_kernels_match_plain(cuda, dtype, f):
    """K9 equals the plain gather bit for bit (negative indices give zero
    rows); K10 equals the plain segment-sum within the f32 tolerance, on
    both wires' plans of a hub graph's shard."""
    from dorylus_tpu_torch.parallel import halo

    sg = _hub_shard()
    n = sg.n_shards
    # cnt[owner, receiver]: exact ghost rows per pair
    cnt = np.stack([halo.ghost_counts(s, n, sg.vp, sg.max_h) for s in sg.shards], axis=1)
    rng = np.random.default_rng(f)
    for wire in ("padded", "ragged"):
        plan = halo.HaloPlan(sg.shards[2], n, wire, cuda, counts=(cnt[2], cnt[:, 2]))
        h = torch.tensor(rng.normal(size=(plan.vp, f)).astype(np.float32),
                         device=cuda).to(dtype)
        before = (halo.PACK_LAUNCHES, halo.HALO_BWD_LAUNCHES)
        buf = halo.row_gather(h, plan.pack)
        assert torch.equal(buf, halo.row_gather_plain(h, plan.pack))
        if plan.place is not None:
            recv = torch.tensor(rng.normal(size=(int(plan.recv_cnt.sum()), f))
                                .astype(np.float32), device=cuda).to(dtype)
            placed = halo.row_gather(recv, plan.place)
            assert torch.equal(placed, halo.row_gather_plain(recv, plan.place))
            assert float(placed[plan.place < 0].abs().max()) == 0.0
        back = torch.tensor(rng.normal(size=(plan.pack.shape[0], f)).astype(np.float32),
                            device=cuda).to(dtype)
        dh = halo.segsum_gather(back, plan.order, plan.rows, plan.row_ptr, plan.vp)
        torch.cuda.synchronize()
        assert halo.PACK_LAUNCHES > before[0] and halo.HALO_BWD_LAUNCHES > before[1]
        _close(dh, halo.segsum_gather_plain(back, plan.order, plan.rows, plan.vp), False)


def test_sharded_kernels_refuse_what_they_do_not_take(cuda):
    from dorylus_tpu_torch.ops import hyb_sharded as hs
    from dorylus_tpu_torch.parallel import halo

    sg = _hub_shard()
    op = hs.ShardedHybSpMM(sg.shards[0], sg.n_shards, edges="fused", static_vals=True,
                           max_width=16, lam_slots=256, device=cuda)
    part = op.fwd["buckets"][op.n_pure]
    out = torch.zeros((op.vp, 8), device=cuda)
    counts = (hs.FUSED_LAUNCHES, halo.PACK_LAUNCHES, halo.HALO_BWD_LAUNCHES)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((op.vp, 8), dtype=bad, device=cuda)
        with pytest.raises(ValueError, match="dtype"):
            hs._launch_fused_part(tb, tb, part, out, unit=False)
        with pytest.raises(ValueError, match="dtype"):
            halo._launch_row_gather(tb, idx, torch.zeros((4, 8), dtype=bad, device=cuda))
        with pytest.raises(ValueError, match="dtype"):
            halo._launch_segsum(tb, idx, torch.zeros(op.vp + 1, dtype=torch.int32,
                                                     device=cuda), out)
    with pytest.raises(ValueError, match="ghosts"):
        hs._launch_fused_part(torch.zeros((op.vp, 8), device=cuda),
                              torch.zeros((4, 9), device=cuda), part, out, unit=False)
    with pytest.raises(ValueError, match="source rows"):
        hs.fused_pass(torch.zeros((10, 8), device=cuda), torch.zeros((2, 8), device=cuda),
                      op.fwd, op.n_pure, None, "static")
    with pytest.raises(ValueError, match="int32"):
        halo._launch_row_gather(torch.zeros((4, 8), device=cuda), idx.long(),
                                torch.zeros((4, 8), device=cuda))
    assert counts == (hs.FUSED_LAUNCHES, halo.PACK_LAUNCHES, halo.HALO_BWD_LAUNCHES)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_four_ranks_on_one_card_match_the_cpu(cuda, model):
    """4 gloo ranks on cuda:0 (the kernels, collectives staged through the
    host) against 4 gloo ranks on the CPU (the plain versions): the same
    losses, rtol 1e-5, fused overlap and the exact wire."""
    import _torch_ranks as ranks
    from dorylus_tpu_torch.graph.graph import synthetic_graph
    from dorylus_tpu_torch.ops import cuda_build, hyb_sharded, hyb_spmm
    from dorylus_tpu_torch.parallel import halo
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    cuda_build.compile_sources([hyb_spmm._CSRC, hyb_sharded._CSRC, halo._CSRC])
    g = synthetic_graph(600, 8, 33, 5, seed=2)
    args = (g, [33, 16, 5], dict(model=model, kernel="hyb"), 4, {})
    on_card = spawn_local(4, ranks.engine_rank, args, backend="gloo", device="cuda:0",
                          timeout_s=300)
    on_cpu = spawn_local(4, ranks.engine_rank, args, backend="gloo", device="cpu",
                         timeout_s=300)
    a, b = np.array(on_card[0]["losses"]), np.array(on_cpu[0]["losses"])
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-5)
