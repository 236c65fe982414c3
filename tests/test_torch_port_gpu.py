"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (hybrid-ELL static mode), K2 (mask mode: apply_unit, apply_dst), the
edgewise K3 (CSR SpMM), K4 (SDDMM), K5 (sorted segment-sum), K7 (dynamic
values: forward, dh alone and dh with the fused SDDMM, one launch a pass on
the gather core) on hybrid-ELL and degree plans, K1/K2 on
degree plans, K6 (the pair-table build) with K2 over a rewritten plan, and
the sharded engine's K8 (two-table hyb pass), K9 (row gather) and K10
(gathered sorted segment-sum), with a 4-rank run on the one card (gloo);
a rank's three sharded degree plans, the interior and boundary hyb plans,
the non-square reuse pass of a shard, the probes P1-P4 (P3 at 512- and
256-byte rows), and the degree pair, pair reuse and the edgewise split on 4
ranks of the one card. K1/K2 and K8 share one gather core: one launch a
pass (two for a plan past MAX_PARTS parts), the same bits on a second run,
hub rows of 2,500 slots, fused parts of no ghost or only ghost slots; K8
as the engines launch it, a pure range then a mixed one, bit for bit
against one launch. K9 at
rows of 2, 4, 8 and 16-byte multiples, with -1 slots and a table of one
row; K5's (E,) teams of 4-32
lanes, a hub row of 5,000 edges, views at every offset from a 16-byte
boundary, E = 0, bit for bit against its team-by-team walk; the launchers'
per-call checks (device, width, rows, contiguity, alignment).

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


@pytest.mark.parametrize("f", [1, 8, 41, 128, 300])
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
    out = torch.zeros((500, 8), device=cuda)
    before = (hyb.KERNEL_LAUNCHES, hyb.MASK_LAUNCHES)
    with pytest.raises(ValueError, match="dtype"):
        hyb._launch_pass(torch.zeros((500, 8), dtype=torch.float16, device=cuda), op.fwd, out)
    with pytest.raises(ValueError, match="differs"):
        hyb._launch_pass(torch.zeros((500, 8), dtype=torch.bfloat16, device=cuda), op.fwd, out)
    with pytest.raises(ValueError, match="contiguous"):
        hyb._launch_pass(torch.zeros((8, 500), device=cuda).t(), op.fwd, out)
    with pytest.raises(ValueError, match="widths"):
        hyb._launch_pass(torch.zeros((500, 6), device=cuda), op.fwd, out)
    with pytest.raises(ValueError, match="source rows"):
        hyb.hyb_static_pass(torch.zeros((10, 8), device=cuda), op.fwd, 500)
    assert (hyb.KERNEL_LAUNCHES, hyb.MASK_LAUNCHES) == before


def _close(got, ref, narrow):
    tol = 1e-2 if narrow else 1e-4
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - ref.float()).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("f", [1, 8, 41, 128, 300])
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


def _edge_counts(spmm):
    return (spmm.SPMM_LAUNCHES, spmm.SPMM_T_LAUNCHES, spmm.SPMM_DVAL_LAUNCHES,
            spmm.SDDMM_LAUNCHES, spmm.SEGSUM_LAUNCHES)


def _edge_graph(kind, seed):
    """dst-sorted edges of 3,000 vertices: "powerlaw" (rows of 0 to 300
    edges, one row of 1,200, a group a row) or "dense" (80 edges a row on
    average: the CSR team's wide rows, a warp a row)."""
    if kind == "dense":
        rng = np.random.default_rng(seed)
        dst = np.sort(rng.integers(0, 3000, size=240_000)).astype(np.int32)
        src = rng.integers(0, 3000, size=len(dst)).astype(np.int32)
        return src, dst, rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    src, dst, val = _powerlaw(3000, seed=seed)
    dst[:1200] = 7  # a row of more than 1,000 edges
    return src, np.sort(dst), val


@pytest.mark.parametrize("f", [1, 8, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_edge_kernels_match_plain(cuda, narrow, f):
    """The edgewise op through autograd: the forward (K3), then dh and dval
    in one launch over the src CSR (K3 + K4 fused), and K5."""
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
    counts = _edge_counts(spmm)
    hk = h.clone().requires_grad_(True)
    vk = v_t.clone().requires_grad_(True)
    out = spmm.spmm_edgewise(hk, s_t, d_t, vk, 3000, op=op)
    out.backward(gout)
    torch.cuda.synchronize()
    # one forward; the value gradient on the card in the dh launch
    assert _edge_counts(spmm) == tuple(c + d for c, d in zip(counts, (1, 0, 1, 0, 0)))
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


@pytest.mark.parametrize("mean", [3, 50, 400])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_segment_sum_teams_hubs_and_views(cuda, narrow, mean):
    """K5's (E,) pass against its plain version and its team-by-team walk:
    teams of 4-32 lanes (mean row lengths 3, 50, 400), rows of 0 edges, a
    row of 5,000 edges (the warp's), g as a view at every element offset
    from a 16-byte boundary, the same bits twice; E = 0 writes zeros."""
    from dorylus_tpu_torch.ops import spmm

    rng = np.random.default_rng(mean)
    deg = rng.poisson(mean, size=3000)
    deg[::7] = 0
    deg[11] = 5000
    rp = torch.tensor(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32), device=cuda)
    e = int(deg.sum())
    dt = torch.bfloat16 if narrow else torch.float32
    base = torch.tensor(rng.normal(size=e + 8).astype(np.float32), device=cuda).to(dt)
    for off in range(16 // base.element_size()):
        g = base[off: off + e]
        before = spmm.SEGSUM_LAUNCHES
        got = spmm.segment_sum(g, rp)
        again = spmm.segment_sum(g, rp)
        torch.cuda.synchronize()
        assert spmm.SEGSUM_LAUNCHES == before + 2
        ref = spmm.segment_sum_plain(g, rp)
        _close(got, ref, False)
        assert torch.equal(got, again)
        assert not bool(got[torch.as_tensor(deg == 0, device=cuda)].any())
        if off <= 1 and mean == 50:
            walk, writes, _, hubs = spmm.walk_segment_sum(g.cpu(), rp.cpu(), head=off)
            assert hubs == [11] and bool((writes == 1).all())
            assert torch.equal(got.cpu(), walk)
    empty = torch.zeros(0, device=cuda, dtype=dt)
    zero_rp = torch.zeros(10, dtype=torch.int32, device=cuda)
    out = spmm.segment_sum(empty, zero_rp)
    torch.cuda.synchronize()
    assert out.shape == (9,) and not bool(out.any())


@pytest.mark.parametrize("f", [1, 8, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("graph", ["powerlaw", "dense"])
def test_edge_entries_match_plain_and_repeat_their_bits(cuda, graph, narrow, f):
    """Each CSR entry against its plain version, one launch each, the same
    bits on a second call: K3 forward (dst CSR) and dh (src CSR through
    `order`), K3 + K4 fused, K4 alone; and autograd's choice of entry by
    which input needs a gradient."""
    from dorylus_tpu_torch.ops import spmm

    src, dst, val = _edge_graph(graph, seed=f + 11)
    op = spmm.EdgeSpMM(src, dst, 3000, 3000, device=cuda)
    dt = torch.bfloat16 if narrow else torch.float32
    rng = np.random.default_rng(f)
    h = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda).to(dt)
    gout = torch.tensor(rng.normal(size=(3000, f)).astype(np.float32), device=cuda).to(dt)
    s_t, v_t = torch.tensor(src, device=cuda), torch.tensor(val, device=cuda)
    rp, trp, tc, order, inv = op.row_ptr, op.t_row_ptr, op.t_col, op.order, op.inv_order
    cases = (
        ("fwd", (1, 0, 0, 0, 0), lambda: spmm.csr_spmm(h, rp, s_t, v_t),
         lambda: spmm.csr_spmm_plain(h, rp, s_t, v_t)),
        ("dh", (0, 1, 0, 0, 0), lambda: spmm.csr_spmm(gout, trp, tc, v_t, order),
         lambda: spmm.csr_spmm_plain(gout, trp, tc, v_t, order)),
        ("dh+dval", (0, 0, 1, 0, 0),
         lambda: spmm.csr_spmm_dval(gout, h, trp, tc, v_t, order, inv),
         lambda: spmm.csr_spmm_dval_plain(gout, h, trp, tc, v_t, order, inv)),
        ("dval", (0, 0, 0, 1, 0), lambda: spmm.sddmm(h, gout, rp, s_t),
         lambda: spmm.sddmm_plain(h, gout, rp, s_t)),
    )
    for name, launches, kern, plain in cases:
        before = _edge_counts(spmm)
        got = kern()
        again = kern()
        torch.cuda.synchronize()
        assert _edge_counts(spmm) == tuple(b + 2 * d for b, d in zip(before, launches)), name
        got, again, ref = [x if isinstance(x, tuple) else (x,) for x in (got, again, plain())]
        for a, b, r in zip(got, again, ref):
            _close(a, r, narrow)
            assert torch.equal(a, b), f"{name}: a second call gave other bits"
    # autograd: dh alone, dval alone
    for needs_h, launches in ((True, (1, 1, 0, 0, 0)), (False, (1, 0, 0, 1, 0))):
        hk = h.clone().requires_grad_(needs_h)
        vk = v_t.clone().requires_grad_(not needs_h)
        before = _edge_counts(spmm)
        spmm.spmm_edgewise(hk, s_t, torch.tensor(dst, device=cuda), vk, 3000,
                           op=op).backward(gout)
        torch.cuda.synchronize()
        assert _edge_counts(spmm) == tuple(b + d for b, d in zip(before, launches))
        if needs_h:
            _close(hk.grad, spmm.csr_spmm_plain(gout, trp, tc, v_t, order), narrow)
        else:
            _close(vk.grad, spmm.sddmm_plain(h, gout, rp, s_t), narrow)


def test_edge_pass_pads_rows_that_are_not_a_multiple_of_16_bytes(cuda):
    """F = 41 f32 rows hold 164 bytes: the entries pad the table to 44
    columns (gather_table) and write (rows, 41); the launcher refuses the
    unpadded table without counting a launch."""
    from dorylus_tpu_torch.ops import spmm
    from dorylus_tpu_torch.ops.gather_parts import gather_table

    src, dst, val = _edge_graph("powerlaw", seed=5)
    op = spmm.EdgeSpMM(src, dst, 3000, 3000, device=cuda)
    rng = np.random.default_rng(5)
    h = torch.tensor(rng.normal(size=(3000, 41)).astype(np.float32), device=cuda)
    s_t, v_t = torch.tensor(src, device=cuda), torch.tensor(val, device=cuda)
    tb = gather_table(h, torch.float32)
    assert tb.shape == (3000, 44) and bool((tb[:, 41:] == 0).all())
    out = spmm.csr_spmm(h, op.row_ptr, s_t, v_t)
    assert out.shape == (3000, 41)
    _close(out, spmm.csr_spmm_plain(h, op.row_ptr, s_t, v_t), False)
    before = _edge_counts(spmm)
    with pytest.raises(ValueError, match="16 bytes"):
        spmm._launch_csr_spmm(h, op.row_ptr, s_t, v_t, None, torch.empty_like(h))
    assert _edge_counts(spmm) == before


def test_edge_kernels_refuse_what_they_do_not_take(cuda):
    from dorylus_tpu_torch.ops import spmm

    src, dst, val = _powerlaw(500, seed=4)
    op = spmm.EdgeSpMM(src, dst, 500, 500, device=cuda)
    s_t = torch.tensor(src, device=cuda)
    v_t = torch.tensor(val, device=cuda)
    out = torch.zeros((500, 8), device=cuda)
    before = _edge_counts(spmm)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_csr_spmm(torch.zeros((500, 8), dtype=bad, device=cuda),
                                  op.row_ptr, s_t, v_t, None, out)
        t = torch.zeros((500, 8), dtype=bad, device=cuda)
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_sddmm(t, t, op.row_ptr, s_t, torch.zeros(len(src), device=cuda))
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_csr_spmm_dval(t, t, op.t_row_ptr, op.t_col, v_t, op.order, out,
                                       torch.zeros(len(src), device=cuda))
        with pytest.raises(ValueError, match="dtype"):
            spmm._launch_segment_sum(v_t.to(bad), op.row_ptr, torch.zeros(500, device=cuda))
    # K5's per-call check: the device, the output's shape, contiguity
    with pytest.raises(ValueError, match="expected"):
        spmm._launch_segment_sum(v_t, op.row_ptr.cpu(), torch.zeros(500, device=cuda))
    with pytest.raises(ValueError, match="out"):
        spmm._launch_segment_sum(v_t, op.row_ptr, torch.zeros(499, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm._launch_segment_sum(torch.zeros((8, len(src)), device=cuda).t(), op.row_ptr,
                                 torch.zeros((500, 8), device=cuda))
    with pytest.raises(ValueError, match="int32"):
        spmm._launch_segment_sum(v_t, op.row_ptr.long(), torch.zeros(500, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm._launch_csr_spmm(torch.zeros((8, 500), device=cuda).t(), op.row_ptr,
                              s_t, v_t, None, out)
    good = torch.zeros((500, 8), device=cuda)
    with pytest.raises(ValueError, match="own rows"):
        spmm._launch_sddmm(good, good[:499], op.row_ptr, s_t,
                           torch.zeros(len(src), device=cuda))
    with pytest.raises(ValueError, match="dval"):
        spmm._launch_csr_spmm_dval(good, good, op.t_row_ptr, op.t_col, v_t, op.order, out,
                                   torch.zeros(len(src) - 1, device=cuda))
    assert _edge_counts(spmm) == before


def _dyn_close_all(res, narrow):
    for got, ref in res:
        _close(got, ref, narrow)


def _dyn_counts(hyb):
    return hyb.DYN_LAUNCHES, hyb.DYN_T_LAUNCHES, hyb.DYN_DVAL_LAUNCHES


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_dyn_kernel_matches_plain(cuda, narrow, f):
    """K7 on hybrid-ELL plans with hub rows and the inv layout: forward
    (weights read through s2e), dh alone and dh with dval (weights gathered
    into slot order), each one launch (F = 300 walks three column tiles
    inside the team)."""
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
    fwd, dh, dval = _dyn_counts(hyb)
    hk = h.clone().requires_grad_(True)
    vk = v_t.clone().requires_grad_(True)
    out = op.apply(hk, vk)
    out.backward(gout)
    dh_alone = hyb.hyb_dynamic_pass(gout, op.bwd, 3000, v_t, gd)
    torch.cuda.synchronize()
    assert _dyn_counts(hyb) == (fwd + 1, dh + 1, dval + 1)
    ref_dh, ref_dval = hyb.hyb_dynamic_pass_plain(gout, op.bwd, 3000, v_t, gd, other=h)
    _dyn_close_all([(out.detach(), hyb.hyb_dynamic_pass_plain(h, op.fwd, 3000, v_t, gd)),
                    (hk.grad, ref_dh), (dh_alone, ref_dh), (vk.grad, ref_dval)], narrow)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["fwd", "dh", "dh+dval"])
@pytest.mark.parametrize("kind", ["hyb", "degree"])
def test_dyn_pass_is_one_launch_and_the_same_bits_twice(cuda, kind, mode, narrow):
    """Each K7 pass is one launch over every part of its plan, counted under
    its direction, and two passes give identical bits (one writer per
    output row and per slot, a fixed order of sums)."""
    from dorylus_tpu_torch.ops import degree_spmm as dg
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    gd = torch.bfloat16 if narrow else None
    src, dst, val = _powerlaw(3000, seed=26)
    rng = np.random.default_rng(26)
    h = torch.tensor(rng.normal(size=(3000, 128)).astype(np.float32), device=cuda)
    g = torch.tensor(rng.normal(size=(3000, 128)).astype(np.float32), device=cuda)
    v_t = torch.tensor(val, device=cuda)
    if kind == "hyb":
        op = hyb.HybSpMM(src, dst, 3000, 3000, max_width=16, gather_dtype=gd, lam_slots=256,
                         dynamic=True, device=cuda)
        assert len(op.fwd["parts"].parts) > 1
    else:
        op = dg.DegreeSpMM(src, dst, 3000, 3000, gather_dtype=gd, device=cuda)
    plan, table = (op.fwd, h) if mode == "fwd" else (op.bwd, g)
    other = h if mode == "dh+dval" else None

    def run():
        return op._pass(table, plan, 3000, "dynamic", v_t, other)

    before = _dyn_counts(hyb)
    a = run()
    torch.cuda.synchronize()
    moved = [n - b for n, b in zip(_dyn_counts(hyb), before)]
    assert moved == {"fwd": [1, 0, 0], "dh": [0, 1, 0], "dh+dval": [0, 0, 1]}[mode]
    b = run()
    for x, y in zip(a if other is not None else (a,), b if other is not None else (b,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("f", [8, 128])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_dyn_pass_on_a_hub_of_more_than_2000_slots(cuda, narrow, f):
    """K7 over a hub row of 2,500 edges (five chunk rows of the hub top, a
    warp a row, each slot's dot its own) beside short rows, forward and dh
    with dval, against plain."""
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    rng = np.random.default_rng(27)
    deg = rng.integers(1, 40, size=2000)
    deg[7] = 2500
    dst = np.repeat(np.arange(2000, dtype=np.int32), deg)
    src = rng.integers(0, 2000, size=len(dst)).astype(np.int32)
    src[dst == 7] = 11  # the hub's transposed row: 2,500 slots of vertex 11 too
    gd = torch.bfloat16 if narrow else None
    op = hyb.HybSpMM(src, dst, 2000, 2000, gather_dtype=gd, dynamic=True, device=cuda)
    assert int(op.fwd["top"]["cnt"].sum()) == 2500 and op.bwd["top"] is not None
    h = torch.tensor(rng.normal(size=(2000, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(2000, f)).astype(np.float32), device=cuda)
    v_t = torch.tensor(rng.normal(size=len(dst)).astype(np.float32), device=cuda)
    dh, dv = hyb.hyb_dynamic_pass(gout, op.bwd, 2000, v_t, gd, other=h)
    ref_dh, ref_dv = hyb.hyb_dynamic_pass_plain(gout, op.bwd, 2000, v_t, gd, other=h)
    _dyn_close_all([(hyb.hyb_dynamic_pass(h, op.fwd, 2000, v_t, gd),
                     hyb.hyb_dynamic_pass_plain(h, op.fwd, 2000, v_t, gd)),
                    (dh, ref_dh), (dv, ref_dv)], narrow)


def test_dyn_pass_of_more_parts_than_one_launch_holds(cuda):
    """A dynamic plan of 63 buckets (lam_slots=0) takes two launches a pass,
    forward and dh with dval, and matches plain (slot0 past the first
    launch's parts)."""
    from dorylus_tpu_torch.ops import gather_parts as gp
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    rng = np.random.default_rng(28)
    dst = np.repeat(np.arange(504, dtype=np.int32), np.arange(1, 505))
    src = rng.integers(0, 504, size=len(dst)).astype(np.int32)
    op = hyb.HybSpMM(src, dst, 504, 504, lam_slots=0, dynamic=True, device=cuda)
    assert len(op.fwd["parts"].parts) > gp.MAX_PARTS
    h = torch.tensor(rng.normal(size=(504, 41)).astype(np.float32), device=cuda)
    v_t = torch.tensor(rng.normal(size=len(dst)).astype(np.float32), device=cuda)
    fwd, dh, dval = _dyn_counts(hyb)
    out = hyb.hyb_dynamic_pass(h, op.fwd, 504, v_t)
    # the backward plan (out-degrees about 250) has a hub top: one launch
    got = hyb.hyb_dynamic_pass(h, op.bwd, 504, v_t, other=h)
    torch.cuda.synchronize()
    assert _dyn_counts(hyb)[0] == fwd + 2
    assert _dyn_counts(hyb)[2] == dval + -(-len(op.bwd["parts"].parts) // gp.MAX_PARTS)
    ref = hyb.hyb_dynamic_pass_plain(h, op.bwd, 504, v_t, other=h)
    _dyn_close_all([(out, hyb.hyb_dynamic_pass_plain(h, op.fwd, 504, v_t)),
                    (got[0], ref[0]), (got[1], ref[1])], False)


@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_degree_kernels_match_plain(cuda, narrow, f):
    """K1 (static), K2 (unit, dst) and K7 (dynamic: forward, dh with dval,
    dh alone) on degree plans against the plain degree pass, on a graph
    with isolated rows and vertices of many block rows."""
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
    dh_alone = deg.degree_pass(gout, op.bwd, 3000, gd, "dynamic", v_t)
    torch.cuda.synchronize()
    assert deg.DEGREE_LAUNCHES == before + 7
    u = plain(h, op.fwd, "mask")
    ref_dh, ref_dval = plain(gout, op.bwd, "dynamic", other=h)
    _dyn_close_all([(out_s.detach(), plain(h, op.fwd, "static")),
                    (hs.grad, plain(gout, op.bwd, "static")),
                    (out_d.detach(), u * dst_val[:, None]),
                    (hd.grad, plain(gout * dst_val[:, None], op.bwd, "mask")),
                    (dd.grad, (u * gout).sum(-1)),
                    (out_y.detach(), plain(h, op.fwd, "dynamic")),
                    (hy.grad, ref_dh), (dh_alone, ref_dh), (vy.grad, ref_dval)], narrow)


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
    counts = (hyb.KERNEL_LAUNCHES, hyb.MASK_LAUNCHES, *_dyn_counts(hyb),
              deg.DEGREE_LAUNCHES, reuse.PAIR_LAUNCHES)
    flat = torch.zeros(hop.bwd["parts"].n_slots, device=cuda)
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((500, 8), dtype=bad, device=cuda)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_pass(tb, hop.fwd, v_t, out)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_pass(tb.float(), hop.fwd, v_t.to(bad), out)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_pass(tb, hop.bwd, v_t, out, own=tb, flat=flat)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_pass(tb.float(), hop.bwd, v_t, out, own=tb, flat=flat)
        with pytest.raises(ValueError, match="wslot"):
            hyb._launch_dyn_pass(tb.float(), hop.fwd, v_t, out,
                                 wslot=torch.zeros(hop.fwd["parts"].n_slots, dtype=bad,
                                                   device=cuda))
        for unit in (False, True):
            with pytest.raises(ValueError, match="dtype"):
                hyb._launch_pass(tb, dop.fwd, out, unit=unit)
        with pytest.raises(ValueError, match="dtype"):
            hyb._launch_dyn_pass(tb, dop.fwd, v_t, out)
        with pytest.raises(ValueError, match="dtype"):
            reuse.build_pair_table(torch.zeros((1000, 8), dtype=bad, device=cuda),
                                   rop.lvl_fwd, rop.fwd_table_size)
    good = torch.zeros((500, 8), device=cuda)
    with pytest.raises(ValueError, match="one per slot"):
        hyb._launch_dyn_pass(good, hop.bwd, v_t, out, own=good, flat=flat[:-1])
    with pytest.raises(ValueError, match="go together"):
        hyb._launch_dyn_pass(good, hop.bwd, v_t, out, own=good)
    with pytest.raises(ValueError, match="edges"):
        hyb._launch_dyn_pass(good, hop.fwd, v_t[:-1], out)
    assert (hyb.KERNEL_LAUNCHES, hyb.MASK_LAUNCHES, *_dyn_counts(hyb),
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


@pytest.mark.parametrize("f", [1, 8, 41, 128, 300])
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


@pytest.mark.parametrize("f", [8, 41, 128])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "mask"])
def test_fused_ranges_match_plain_and_one_launch(cuda, static, narrow, f):
    """K8 as the engines launch it, two ranges of its parts either side of
    the exchange's finish: the pure range (h alone), then the mixed
    buckets and the hub top into the same output. Each range against its
    plain half; the two bit for bit against one launch over every part;
    one launch a range, and none for the pure range of a shard without
    pure rows (every source a ghost)."""
    import dataclasses

    from dorylus_tpu_torch.ops import hyb_sharded as hs

    sg = _hub_shard()
    shard = sg.shards[1]
    e = shard.num_edges
    remote = np.asarray(shard.src[:e]) >= sg.vp
    only_ghosts = dataclasses.replace(
        shard, src=shard.src[:e][remote], dst=shard.dst[:e][remote],
        edge_val=shard.edge_val[:e][remote], num_edges=int(remote.sum()))
    gd = torch.bfloat16 if narrow else None
    mode = "static" if static else "mask"
    rng = np.random.default_rng(f)
    for sub in (shard, only_ghosts):
        op = hs.ShardedHybSpMM(sub, sg.n_shards, edges="fused", static_vals=static,
                               gather_dtype=gd, max_width=16, lam_slots=256, device=cuda)
        assert (op.n_pure > 0) == (sub is shard)
        h = torch.tensor(rng.normal(size=(op.vp, f)).astype(np.float32), device=cuda)
        gh = torch.tensor(rng.normal(size=(op.table - op.vp, f)).astype(np.float32),
                          device=cuda)
        before = (hs.FUSED_LAUNCHES, hs.FUSED_PURE_LAUNCHES)
        pure = hs.fused_pure_pass(h, op.fwd, op.n_pure, gd, mode)
        torch.cuda.synchronize()
        want_pure = hs.fused_pure_plain(h, op.fwd, op.n_pure, gd, mode)
        _close(pure.out, want_pure.out, narrow)
        got = hs.fused_mixed_pass(pure, gh, op.fwd, op.n_pure, gd, mode)
        torch.cuda.synchronize()
        n_pure_launch = 1 if op.n_pure else 0
        assert (hs.FUSED_LAUNCHES, hs.FUSED_PURE_LAUNCHES) == (
            before[0] + 1 + n_pure_launch, before[1] + n_pure_launch)
        _close(got, hs.fused_mixed_plain(want_pure, gh, op.fwd, op.n_pure, gd, mode), narrow)
        assert torch.equal(got, hs.fused_pass(h, gh, op.fwd, op.n_pure, gd, mode))


@pytest.mark.parametrize("f", [1, 3, 41, 128, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_halo_kernels_match_plain(cuda, dtype, f):
    """K9 equals the plain gather bit for bit (negative indices give zero
    rows), also from a table of one row and into zero rows; K10 equals the plain segment-sum within the f32
    tolerance, on both wires' plans of a hub graph's shard."""
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
    # -1 slots, rows past the first block's, a table of one row, no rows
    idx = torch.tensor(rng.integers(-1, 900, size=5003).astype(np.int32), device=cuda)
    x = torch.tensor(rng.normal(size=(900, f)).astype(np.float32), device=cuda).to(dtype)
    one = x[:1].clone()
    idx1 = torch.tensor([0, -1, 0, 0, -1], dtype=torch.int32, device=cuda)
    before = halo.PACK_LAUNCHES
    assert torch.equal(halo.row_gather(x, idx), halo.row_gather_plain(x, idx))
    assert torch.equal(halo.row_gather(one, idx1), halo.row_gather_plain(one, idx1))
    assert halo.row_gather(x, idx[:0]).shape == (0, f)
    torch.cuda.synchronize()
    assert halo.PACK_LAUNCHES == before + 2


def test_sharded_kernels_refuse_what_they_do_not_take(cuda):
    from dorylus_tpu_torch.ops import hyb_sharded as hs
    from dorylus_tpu_torch.parallel import halo

    sg = _hub_shard()
    op = hs.ShardedHybSpMM(sg.shards[0], sg.n_shards, edges="fused", static_vals=True,
                           max_width=16, lam_slots=256, device=cuda)
    out = torch.zeros((op.vp, 8), device=cuda)
    counts = (hs.FUSED_LAUNCHES, halo.PACK_LAUNCHES, halo.HALO_BWD_LAUNCHES)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((op.vp, 8), dtype=bad, device=cuda)
        with pytest.raises(ValueError, match="dtype"):
            hs._launch_fused_pass(tb, torch.zeros((op.table - op.vp, 8), dtype=bad,
                                                  device=cuda), op.fwd, out, unit=False)
        with pytest.raises(ValueError, match="dtype"):
            halo._launch_row_gather(tb, idx, torch.zeros((4, 8), dtype=bad, device=cuda))
        with pytest.raises(ValueError, match="dtype"):
            halo._launch_segsum(tb, idx, torch.zeros(op.vp + 1, dtype=torch.int32,
                                                     device=cuda), out)
    with pytest.raises(ValueError, match="ghosts"):
        hs._launch_fused_pass(torch.zeros((op.vp, 8), device=cuda),
                              torch.zeros((4, 12), device=cuda), op.fwd, out, unit=False)
    with pytest.raises(ValueError, match="local rows"):
        hs._launch_fused_pass(torch.zeros((op.vp + 1, 8), device=cuda),
                              torch.zeros((op.table - op.vp, 8), device=cuda), op.fwd, out,
                              unit=False)
    with pytest.raises(ValueError, match="source rows"):
        hs.fused_pass(torch.zeros((10, 8), device=cuda), torch.zeros((2, 8), device=cuda),
                      op.fwd, op.n_pure, None, "static")
    with pytest.raises(ValueError, match="int32"):
        halo._launch_row_gather(torch.zeros((4, 8), device=cuda), idx.long(),
                                torch.zeros((4, 8), device=cuda))
    # what the per-call check keeps: the device, the width, the output rows,
    # contiguity and alignment
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="input on"):
        halo._launch_row_gather(x, idx.cpu(), torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError, match="widths differ"):
        halo._launch_row_gather(x, idx, torch.zeros((4, 6), device=cuda))
    with pytest.raises(ValueError, match="one index per output row"):
        halo._launch_row_gather(x, idx, torch.zeros((5, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        halo._launch_row_gather(torch.zeros((8, 4), device=cuda).t(), idx,
                                torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError, match="16-byte aligned"):
        halo._launch_row_gather(torch.zeros(40, device=cuda)[1:33].view(4, 8), idx,
                                torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError, match="rows \\+ 1"):
        halo._launch_segsum(x, idx, idx, torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError, match="input on"):
        halo._launch_segsum(x, idx, torch.zeros(5, dtype=torch.int32),
                            torch.zeros((4, 8), device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        halo._launch_row_gather(x.cpu(), idx.cpu(), torch.zeros((4, 8)))
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


@pytest.mark.parametrize("f", [41, 128, 300])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edges", ["combined", "interior", "boundary"])
def test_sharded_degree_plans_match_plain(cuda, edges, narrow, f):
    """A rank's three degree plans on the card (K1 static, K2 dst, K7
    dynamic: forward, gradients and dh alone) against `degree_pass_plain`;
    and the interior and boundary passes add up to the combined one."""
    from dorylus_tpu_torch.ops import degree_spmm as dg
    from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM

    sg = _hub_shard()
    shard, n = sg.shards[1], sg.n_shards
    gd = torch.bfloat16 if narrow else None
    op = ShardedDegreeSpMM(shard, n, edges=edges, static_vals=True, gather_dtype=gd,
                           device=cuda)
    rng = np.random.default_rng(f)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32), device=cuda)

    table, gout, dv, val = t(op.num_in, f), t(op.vp, f), t(op.vp), t(op.num_edges)
    before = dg.DEGREE_LAUNCHES

    def plain(tb, plan, num, mode, other=None):
        return dg.degree_pass_plain(tb, plan, num, gd, mode, val, other)

    tk = table.clone().requires_grad_(True)
    out = op.apply_static(tk)
    out.backward(gout)
    _close(out.detach(), plain(table, op.fwd, op.vp, "static"), narrow)
    _close(tk.grad, plain(gout, op.bwd, op.num_in, "static"), narrow)
    tk, dk = table.clone().requires_grad_(True), dv.clone().requires_grad_(True)
    out = op.apply_dst(tk, dk)
    out.backward(gout)
    u = plain(table, op.fwd, op.vp, "mask")
    _close(out.detach(), u * dv[:, None], narrow)
    _close(tk.grad, plain(gout * dv[:, None], op.bwd, op.num_in, "mask"), narrow)
    _close(dk.grad, (u * gout).sum(-1), narrow)
    tk, vk = table.clone().requires_grad_(True), val.clone().requires_grad_(True)
    out = op.apply(tk, vk)
    out.backward(gout)
    _close(out.detach(), plain(table, op.fwd, op.vp, "dynamic"), narrow)
    ref_dh, ref_dval = plain(gout, op.bwd, op.num_in, "dynamic", other=table)
    _close(tk.grad, ref_dh, narrow)
    _close(vk.grad, ref_dval, narrow)
    _close(dg.degree_pass(gout, op.bwd, op.num_in, gd, "dynamic", val), ref_dh, narrow)
    torch.cuda.synchronize()
    assert dg.DEGREE_LAUNCHES >= before + 6
    if edges == "combined":
        op_i, op_b = (ShardedDegreeSpMM(shard, n, edges=e, static_vals=True, gather_dtype=gd,
                                        device=cuda) for e in ("interior", "boundary"))
        both = op_i.apply_static(table[: op.vp]) + op_b.apply_static(table[op.vp:])
        _close(both, op.apply_static(table), narrow)


def test_sharded_degree_plan_without_edges(cuda):
    """A rank without boundary edges: the boundary op launches nothing,
    returns zeros and hands the exchange a zero gradient of its shape."""
    import dataclasses

    from dorylus_tpu_torch.ops import degree_spmm as dg
    from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM

    sg = _hub_shard()
    shard = sg.shards[0]
    e = shard.num_edges
    keep = np.asarray(shard.src[:e]) < sg.vp
    local = dataclasses.replace(shard, src=shard.src[:e][keep], dst=shard.dst[:e][keep],
                                edge_val=shard.edge_val[:e][keep], num_edges=int(keep.sum()))
    for static in (True, False):
        op = ShardedDegreeSpMM(local, sg.n_shards, edges="boundary", static_vals=static,
                               device=cuda)
        ghosts = torch.ones((op.num_in, 8), device=cuda, requires_grad=True)
        before = dg.DEGREE_LAUNCHES
        out = (op.apply_static(ghosts) if static
               else op.apply_dst(ghosts, torch.ones(op.vp, device=cuda)))
        out.sum().backward()
        assert dg.DEGREE_LAUNCHES == before
        assert out.shape == (op.vp, 8) and float(out.detach().abs().max()) == 0.0
        assert ghosts.grad.shape == ghosts.shape and float(ghosts.grad.abs().max()) == 0.0


@pytest.mark.parametrize("f", [41, 128])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edges", ["interior", "boundary"])
def test_sharded_hyb_split_plans_match_plain(cuda, edges, narrow, f):
    """ShardedHybSpMM's interior and boundary plans on K1/K2 against the
    plain pass."""
    from dorylus_tpu_torch.ops import hyb_sharded as hs
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    sg = _hub_shard()
    gd = torch.bfloat16 if narrow else None
    op = hs.ShardedHybSpMM(sg.shards[1], sg.n_shards, edges=edges, static_vals=True,
                           gather_dtype=gd, max_width=16, lam_slots=256, device=cuda)
    rng = np.random.default_rng(f + 1)
    table = torch.tensor(rng.normal(size=(op.num_in, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(op.vp, f)).astype(np.float32), device=cuda)
    dv = torch.tensor(rng.normal(size=op.vp).astype(np.float32), device=cuda)
    tk = table.clone().requires_grad_(True)
    out = op.apply_static(tk)
    out.backward(gout)
    _close(out.detach(), hyb._hyb_pass_plain(table, op.fwd, op.vp, gd, "static"), narrow)
    _close(tk.grad, hyb._hyb_pass_plain(gout, op.bwd, op.num_in, gd, "static"), narrow)
    tk, dk = table.clone().requires_grad_(True), dv.clone().requires_grad_(True)
    out = op.apply_dst(tk, dk)
    out.backward(gout)
    u = hyb._hyb_pass_plain(table, op.fwd, op.vp, gd, "mask")
    _close(out.detach(), u * dv[:, None], narrow)
    _close(dk.grad, (u * gout).sum(-1), narrow)


def _community_shard(n=4):
    from dorylus_tpu_torch.graph.graph import Graph, community_core_edges
    from dorylus_tpu_torch.graph.partition import partition_graph

    v = 4000
    src, dst = community_core_edges(v, 20, comm=40, core=30, p_core=0.85, seed=0)
    rng = np.random.default_rng(4)
    g = Graph(num_vertices=v, src=src, dst=dst,
              features=rng.normal(size=(v, 8)).astype(np.float32),
              labels=(np.arange(v) % 3).astype(np.int32), num_classes=3).finalize()
    return partition_graph(g, n, method="hash")


@pytest.mark.parametrize("f", [41, 128])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("passes", [1, 2])
def test_sharded_reuse_pass_matches_plain(cuda, passes, narrow, f):
    """The non-square reuse op of a shard on the card (K6 at base
    vp + n * max_h forward and vp backward, then K2) against the plain
    build and pass, and against the unrewritten combined plan."""
    from dorylus_tpu_torch.ops import hyb_spmm as hyb
    from dorylus_tpu_torch.ops import reuse_spmm as ru
    from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
    from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM

    sg = _community_shard()
    shard, n = sg.shards[1], sg.n_shards
    gd = torch.bfloat16 if narrow else None
    rng = np.random.default_rng(f + passes)
    f_local = rng.uniform(0.2, 1.0, size=sg.vp).astype(np.float32)
    f_ghost = rng.uniform(0.2, 1.0, size=n * sg.max_h).astype(np.float32)
    op = ShardedReuseSpMM(shard, n, rank1_factor=np.concatenate([f_local, f_ghost]),
                          gather_dtype=gd, passes=passes, device=cuda)
    assert op.num_pairs > 0 and op.plan_bwd.num_pairs > 0
    assert (op.num_in, op.num_out) == (sg.vp + n * sg.max_h, sg.vp)
    table = torch.tensor(rng.normal(size=(op.num_in, f)).astype(np.float32), device=cuda)
    gout = torch.tensor(rng.normal(size=(op.vp, f)).astype(np.float32), device=cuda)
    before = (ru.PAIR_LAUNCHES, hyb.MASK_LAUNCHES)
    tk = table.clone().requires_grad_(True)
    out = op.apply_unit(tk)
    out.backward(gout)
    torch.cuda.synchronize()
    assert ru.PAIR_LAUNCHES > before[0] and hyb.MASK_LAUNCHES > before[1]
    tbl = ru.build_pair_table(table, op.lvl_fwd, op.fwd_table_size)
    assert torch.equal(tbl, ru.build_pair_table_plain(table, op.lvl_fwd))
    _close(out.detach(), hyb.hyb_mask_pass_plain(tbl, op.fwd, op.vp, gd), narrow)
    gtbl = ru.build_pair_table(gout, op.lvl_bwd, op.bwd_table_size)
    assert torch.equal(gtbl, ru.build_pair_table_plain(gout, op.lvl_bwd))
    _close(tk.grad, hyb.hyb_mask_pass_plain(gtbl, op.bwd, op.num_in, gd), narrow)
    plain_op = ShardedHybSpMM(shard, n, gather_dtype=gd, device=cuda)
    tk2 = table.clone().requires_grad_(True)
    ref = plain_op.apply_unit(tk2)
    ref.backward(gout)
    _close(out.detach(), ref.detach(), narrow)
    _close(tk.grad, tk2.grad, narrow)
    fi, fo = op.f_in[:, None], op.f_out[:, None]
    _close(op.apply_static(table), plain_op.apply_unit(table * fi) * fo, narrow)


def _probe_inputs(cuda, streams, n_ops, hi, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, hi, size=(streams, n_ops)).astype(np.int32),
                        device=cuda)


def test_probe_shared_memory_kernels_match_plain(cuda):
    """P1 (to 1e-4 * max|ref|) and P2 (bit for bit) on a table that fills a
    block's shared memory and on a small one, ops not a multiple of the
    staged chunk."""
    from dorylus_tpu_torch.tools import probe_prims as pp

    full = pp.table_blocks(cuda)
    assert 48 <= full <= 64  # 227 KB of shared memory: 56 row-blocks of 4 KB
    rng = np.random.default_rng(0)
    for blocks, streams, n_ops in ((full, 5, 1000), (3, 2, 255), (full, 1, 1)):
        tab = torch.tensor(rng.normal(size=(blocks * 8, 128)).astype(np.float32), device=cuda)
        idx = _probe_inputs(cuda, streams, n_ops, blocks, seed=n_ops)
        before = dict(pp.LAUNCHES)
        got, ref = pp.dyn_load(tab, idx), pp.dyn_load_plain(tab, idx)
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
        assert torch.equal(pp.dyn_rmw(idx, blocks), pp.dyn_rmw_plain(idx, blocks))
        assert (pp.LAUNCHES["P1"], pp.LAUNCHES["P2"]) == (before["P1"] + 1, before["P2"] + 1)


def test_probe_row_copy_matches_plain(cuda):
    """P3 bit for bit: each stream's ring holds the rows of its last 16
    ops, for streams that do not fill the last block and ops not a multiple
    of 32."""
    from dorylus_tpu_torch.tools import probe_prims as pp

    rng = np.random.default_rng(1)
    for cols in (128, 64):  # 512- and 256-byte rows
        tab = torch.tensor(rng.normal(size=(5000, cols)).astype(np.float32), device=cuda)
        for streams, n_ops in ((11, 1000), (8, 16), (3, 77)):
            idx = _probe_inputs(cuda, streams, n_ops, 5000, seed=n_ops)
            assert torch.equal(pp.row_copy(tab, idx), pp.row_copy_plain(tab, idx))


def test_probe_lane_gather_matches_plain(cuda):
    """P4 to 1e-4 * max|ref|: indexed shuffles over a register tile."""
    from dorylus_tpu_torch.tools import probe_prims as pp

    rng = np.random.default_rng(2)
    tab = torch.tensor(rng.normal(size=(11, 8, 128)).astype(np.float32), device=cuda)
    ids = torch.tensor(rng.integers(0, 128, size=(64, 128)).astype(np.int32), device=cuda)
    for n_ops in (1, 64, 333):
        got, ref = pp.lane_gather(tab, ids, n_ops), pp.lane_gather_plain(tab, ids, n_ops)
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_probe_kernels_refuse_what_they_do_not_take(cuda):
    from dorylus_tpu_torch.tools import probe_prims as pp

    tab = torch.zeros((16, 128), device=cuda)
    idx = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    before = dict(pp.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        pp.dyn_load(tab.half(), idx)
    with pytest.raises(ValueError, match="int32"):
        pp.dyn_load(tab, idx.long())
    with pytest.raises(ValueError, match="outside"):
        pp.dyn_load(tab, idx + 2)
    with pytest.raises(ValueError, match="shared memory"):
        pp.dyn_load(torch.zeros((8 * 100, 128), device=cuda), idx)
    with pytest.raises(ValueError, match="shared memory"):
        pp.dyn_rmw(idx, 100)
    with pytest.raises(ValueError, match="at least 16"):
        pp.row_copy(tab, idx[:, :8])
    with pytest.raises(ValueError, match="float32"):
        pp.row_copy(tab.double(), idx)
    with pytest.raises(ValueError, match="ids"):
        pp.lane_gather(torch.zeros((2, 8, 128), device=cuda), idx, 4)
    assert pp.LAUNCHES == before


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_new_sharded_paths_on_one_card_match_the_cpu(cuda, model):
    """4 gloo ranks on cuda:0 against 4 on the CPU for the degree pair, the
    combined degree plan, pair reuse and the edgewise split: the same
    losses, rtol 1e-5."""
    import _torch_ranks as ranks
    from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph
    from dorylus_tpu_torch.ops import cuda_build, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    cuda_build.compile_sources([hyb_spmm._CSRC, hyb_spmm._DYN_CSRC, reuse_spmm._CSRC,
                                spmm._CSRC, halo._CSRC])
    g = clustered_synthetic_graph(600, 8, 33, 5, seed=11, window=128, cut=0.2)
    base = dict(model=model, reuse="off", learning_rate=0.01 if model == "gcn" else 0.005)
    runs = [(dict(base, kernel="degree"), 3, {}),
            (dict(base, kernel="degree", overlap=False), 3, {}),
            (dict(base, kernel="hyb", reuse="pairs", reuse_max_pairs=0), 3, {}),
            (dict(base, kernel="xla", overlap=True), 3, {})]
    args = (g, [33, 16, 5], runs)
    on_card = spawn_local(4, ranks.engines_rank, args, backend="gloo", device="cuda:0",
                          timeout_s=300)
    on_cpu = spawn_local(4, ranks.engines_rank, args, backend="gloo", device="cpu",
                         timeout_s=300)
    for a, b in zip(on_card[0], on_cpu[0]):
        assert np.isfinite(a["losses"]).all()
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_overlapped_backward_on_one_card(cuda, model):
    """2 gloo ranks on cuda:0, the degree pair and the edgewise split: the
    reverse exchange in two steps (started in HaloRecvFn's backward,
    finished in the join's) equals both exchanges called whole at their
    finish bit for bit, and multihost.EXCHANGES counts one split reverse
    exchange a layer and train epoch, none for the whole ones."""
    import _torch_ranks as ranks
    from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph
    from dorylus_tpu_torch.ops import cuda_build, hyb_spmm, spmm
    from dorylus_tpu_torch.parallel import halo
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    cuda_build.compile_sources([hyb_spmm._CSRC, hyb_spmm._DYN_CSRC, spmm._CSRC, halo._CSRC])
    g = clustered_synthetic_graph(2000, 8, 16, 5, seed=11, window=256, cut=0.1)
    epochs, layers = 3, 2
    base = dict(model=model, reuse="off", overlap=True, eval_every=1,
                learning_rate=0.01 if model == "gcn" else 0.005)
    cases = [(dict(base, kernel=k), epochs, how) for k in ("degree", "xla")
             for how in ("two-step", "one-call")]
    res = spawn_local(2, ranks.bwd_exchanges_rank, (g, [16, 8, 5], cases), backend="gloo",
                      device="cuda:0", timeout_s=300)
    for r in range(2):
        for k in range(2):
            two, one = res[r][2 * k: 2 * k + 2]
            assert two["overlap"] and np.isfinite(two["losses"]).all()
            assert two["losses"] == one["losses"] and all(
                np.array_equal(two["params"][n], one["params"][n]) for n in two["params"])
            ex, ex1 = two["exchanges"], one["exchanges"]
            assert ex["bwd_started"] == epochs * layers, ex
            assert 0 <= ex["bwd_held"] <= ex["bwd_started"] and ex["bwd_host_ms"] > 0, ex
            assert ex["started"] >= epochs * layers, ex
            assert ex1["started"] == ex1["bwd_started"] == 0, ex1


# ---- the one-launch gather core (K1/K2 and K8, csrc/gather_pass.cuh) ----


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["hyb static", "hyb mask", "degree", "fused static",
                                  "fused mask"])
def test_gather_pass_is_one_launch_and_the_same_bits_twice(cuda, kind, narrow):
    """A pass is one launch over every part of its plan, and two passes
    give identical bits (one writer per output row, a fixed order of
    sums)."""
    from dorylus_tpu_torch.ops import degree_spmm as dg
    from dorylus_tpu_torch.ops import hyb_sharded as hs
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    gd = torch.bfloat16 if narrow else None
    rng = np.random.default_rng(21)
    if kind.startswith("fused"):
        sg = _hub_shard()
        mode = kind.split()[1]
        op = hs.ShardedHybSpMM(sg.shards[1], sg.n_shards, edges="fused",
                               static_vals=mode == "static", gather_dtype=gd, max_width=16,
                               lam_slots=256, device=cuda)
        assert len(op.fwd["parts"].parts) > 1
        h = torch.tensor(rng.normal(size=(op.vp, 128)).astype(np.float32), device=cuda)
        gh = torch.tensor(rng.normal(size=(op.table - op.vp, 128)).astype(np.float32),
                          device=cuda)

        def run():
            return hs.fused_pass(h, gh, op.fwd, op.n_pure, gd, mode)

        counter = (hs, "FUSED_LAUNCHES")
    else:
        src, dst, val = _powerlaw(3000, seed=22)
        h = torch.tensor(rng.normal(size=(3000, 128)).astype(np.float32), device=cuda)
        if kind == "degree":
            op = dg.DegreeSpMM(src, dst, 3000, 3000, gather_dtype=gd, static_val=val,
                               device=cuda)

            def run():
                return dg.degree_pass(h, op.fwd, 3000, gd, "static")

            counter = (hyb, "KERNEL_LAUNCHES")
        else:
            op = hyb.HybSpMM(src, dst, 3000, 3000, max_width=16, gather_dtype=gd,
                             static_val=val, lam_slots=256, device=cuda)
            assert len(op.fwd["parts"].parts) > 1
            mode = kind.split()[1]

            def run():
                return hyb._hyb_pass(h, op.fwd, 3000, gd, mode)

            counter = (hyb, "MASK_LAUNCHES" if mode == "mask" else "KERNEL_LAUNCHES")
    before = getattr(*counter)
    a = run()
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    assert torch.equal(a, run())


@pytest.mark.parametrize("f", [8, 128])
@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
def test_gather_pass_on_a_hub_of_more_than_2000_slots(cuda, narrow, f):
    """A hub row of 2,500 edges (five chunk rows of the hub top, a warp
    per row) beside short rows, static and mask mode, against plain."""
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    rng = np.random.default_rng(23)
    deg = rng.integers(1, 40, size=2000)
    deg[7] = 2500
    dst = np.repeat(np.arange(2000, dtype=np.int32), deg)
    src = rng.integers(0, 2000, size=len(dst)).astype(np.int32)
    val = rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    gd = torch.bfloat16 if narrow else None
    op = hyb.HybSpMM(src, dst, 2000, 2000, gather_dtype=gd, static_val=val, device=cuda)
    top = op.fwd["top"]
    assert top is not None and int(top["cnt"].sum()) == 2500
    h = torch.tensor(rng.normal(size=(2000, f)).astype(np.float32), device=cuda)
    for mode in ("static", "mask"):
        _close(hyb._hyb_pass(h, op.fwd, 2000, gd, mode),
               hyb._hyb_pass_plain(h, op.fwd, 2000, gd, mode), narrow)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ghosts", ["none", "only"])
def test_fused_pass_with_parts_of_no_ghost_or_only_ghosts(cuda, ghosts, narrow):
    """K8 on a shard whose mixed parts read no ghost row (every source
    local, only hubs mixed) or only ghost rows (every source remote)."""
    import dataclasses

    from dorylus_tpu_torch.ops import hyb_sharded as hs

    sg = _hub_shard()
    shard = sg.shards[1]
    e = shard.num_edges
    keep = (np.asarray(shard.src[:e]) < sg.vp) == (ghosts == "none")
    sub = dataclasses.replace(shard, src=shard.src[:e][keep], dst=shard.dst[:e][keep],
                              edge_val=shard.edge_val[:e][keep], num_edges=int(keep.sum()))
    gd = torch.bfloat16 if narrow else None
    rng = np.random.default_rng(24)
    for static in (True, False):
        op = hs.ShardedHybSpMM(sub, sg.n_shards, edges="fused", static_vals=static,
                               gather_dtype=gd, max_width=16, lam_slots=256, device=cuda)
        pt = op.fwd["parts"]
        mixed = [k for k, s in enumerate(pt.splits) if s == op.vp]
        assert mixed, "no mixed part"
        if ghosts == "only":
            assert op.n_pure == 0
        h = torch.tensor(rng.normal(size=(op.vp, 41)).astype(np.float32), device=cuda)
        gh = torch.tensor(rng.normal(size=(op.table - op.vp, 41)).astype(np.float32),
                          device=cuda)
        mode = "static" if static else "mask"
        _close(hs.fused_pass(h, gh, op.fwd, op.n_pure, gd, mode),
               hs.fused_pass_plain(h, gh, op.fwd, op.n_pure, gd, mode), narrow)


def test_gather_pass_of_more_parts_than_one_launch_holds(cuda):
    """A plan of 63 buckets (lam_slots=0) takes two launches of the
    descriptor table, each with its own block prefix, and matches plain."""
    from dorylus_tpu_torch.ops import gather_parts as gp
    from dorylus_tpu_torch.ops import hyb_spmm as hyb

    rng = np.random.default_rng(25)
    dst = np.repeat(np.arange(504, dtype=np.int32), np.arange(1, 505))
    src = rng.integers(0, 504, size=len(dst)).astype(np.int32)
    val = rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    op = hyb.HybSpMM(src, dst, 504, 504, static_val=val, lam_slots=0, device=cuda)
    assert len(op.fwd["parts"].parts) > gp.MAX_PARTS
    h = torch.tensor(rng.normal(size=(504, 41)).astype(np.float32), device=cuda)
    before = hyb.KERNEL_LAUNCHES
    out = hyb.hyb_static_pass(h, op.fwd, 504)
    torch.cuda.synchronize()
    assert hyb.KERNEL_LAUNCHES == before + 2
    _close(out, hyb.hyb_static_pass_plain(h, op.fwd, 504), False)


# ---- the epoch groups' CUDA graphs (engine/graphs.py) ----


def _graph_engines(cuda, path, stale):
    """Two engines of one configuration from one init on the card."""
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.graph.graph import (Graph, community_core_edges,
                                               synthetic_graph)

    model, kernel, kw = {
        "hyb gcn": ("gcn", "hyb", dict(agg_dtype="bfloat16")),
        "hyb gat": ("gat", "hyb", dict(agg_dtype="bfloat16")),
        "degree bf16": ("gcn", "degree", dict(agg_dtype="bfloat16")),
        "degree f32": ("gcn", "degree", {}),
        "reuse pairs gcn": ("gcn", "hyb", dict(reuse="pairs", reuse_max_pairs=0)),
        "reuse pairs gat": ("gat", "hyb", dict(reuse="pairs", reuse_max_pairs=0)),
        "xla gcn": ("gcn", "xla", {}),
        "xla gat": ("gat", "xla", {}),
    }[path]
    if "reuse" in path:
        src, dst = community_core_edges(1500, 10, comm=30, core=15, seed=2)
        g = Graph(num_vertices=1500, src=src, dst=dst,
                  features=np.random.default_rng(0).normal(size=(1500, 24)).astype(np.float32),
                  labels=(np.arange(1500) % 6).astype(np.int32), num_classes=6).finalize()
    else:
        g = synthetic_graph(1500, 8, 24, 6, seed=4)
    kw.setdefault("reuse", "off")
    cfg = TrainConfig(model=model, kernel=kernel, epochs=7, eval_every=2, epochs_per_call=3,
                      staleness=stale, learning_rate=0.005 if model == "gat" else 0.01, **kw)
    return [Engine(g, LayerConfig([24, 16, 6]), cfg, device=cuda) for _ in range(2)]


@pytest.mark.parametrize("stale", [0, 1])
@pytest.mark.parametrize("path", ["hyb gcn", "hyb gat", "degree bf16", "degree f32",
                                  "reuse pairs gcn", "reuse pairs gat", "xla gcn", "xla gat"])
def test_graph_run_equals_the_eager_loop(cuda, path, stale):
    """Engine.run through EpochGraphs (groups of 3, eval every 2 epochs)
    against the eager loop from the same init: losses, accuracies, params
    and Adam's state bit for bit; the launch counts of the two runs equal
    (a replay counts the kernels its capture counted); one train graph for
    the staleness variant and one eval graph."""
    from dorylus_tpu_torch.ops import degree_spmm, hyb_spmm, reuse_spmm, spmm

    def counts():
        return {m.__name__ + "." + k: v for m in (hyb_spmm, degree_spmm, reuse_spmm, spmm)
                for k, v in vars(m).items() if k.endswith("_LAUNCHES")}

    graphed, eager = _graph_engines(cuda, path, stale)
    runs = []
    for eng, use in ((graphed, True), (eager, False)):
        before = counts()
        rep = eng.run(graphs=use)
        torch.cuda.synchronize()
        runs.append((rep, {k: n - before[k] for k, n in counts().items()}))
    (rg, cg), (re, ce) = runs
    assert [e.loss for e in rg.epochs] == [e.loss for e in re.epochs]
    assert [e.accuracy for e in rg.epochs] == [e.accuracy for e in re.epochs]
    assert (rg.final_accuracy, rg.test_accuracy) == (re.final_accuracy, re.test_accuracy)
    for k, p in graphed.params.items():
        assert torch.equal(p, eager.params[k]), k
        assert torch.equal(graphed.opt_state.v[k], eager.opt_state.v[k]), k
    assert graphed.opt_state.step == eager.opt_state.step == 7
    assert cg == ce and sum(cg.values()) > 0
    assert set(graphed._graphs.train) == {bool(stale)} and graphed._graphs.eval is not None
    assert eager._graphs is None


def test_capture_survives_a_collection(cuda, monkeypatch):
    """Another run's graphs left in a fresh reference cycle just after a
    capture begins, with the collector's threshold at 1 (a collection at
    nearly every allocation): the captures succeed (no collection runs
    inside one, which would destroy those graphs there and end the
    capture) and the run equals the eager loop bit for bit."""
    import gc

    old, _ = _graph_engines(cuda, "hyb gcn", 0)
    old.run()
    holder = [old._graphs]
    del old
    real_graph = torch.cuda.graph

    class graph_leaving_a_cycle(real_graph):
        def __enter__(self):
            super().__enter__()
            if holder:
                box = {"graphs": holder.pop()}
                box["box"] = box

    monkeypatch.setattr(torch.cuda, "graph", graph_leaving_a_cycle)
    graphed, eager = _graph_engines(cuda, "hyb gcn", 0)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        rg = graphed.run()
    finally:
        gc.set_threshold(*threshold)
    re_ = eager.run(graphs=False)
    assert not holder
    assert [e.loss for e in rg.epochs] == [e.loss for e in re_.epochs]


def test_a_failed_capture_raises(cuda):
    """A host read inside the captured epoch fails the capture, and run()
    raises: nothing falls back to the eager loop."""
    graphed, _ = _graph_engines(cuda, "hyb gcn", 0)
    loss = graphed.model.loss_and_logits  # what the training step calls

    def loss_with_a_host_read(*args, **kw):
        out = loss(*args, **kw)
        float(out[0])  # a device wait: refused while the stream is captured
        return out

    graphed.model.loss_and_logits = loss_with_a_host_read
    with pytest.raises(RuntimeError):
        graphed.run()


# ---- the sharded engine's epoch graphs, kept for the engine's life ----


def _sharded_engines(cuda, model):
    """Two ShardedEngines without a process group (one shard) of one
    configuration from one init on the card: hyb, bf16 gather tables, S=1,
    groups of 3, eval every 2."""
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.graph.graph import synthetic_graph
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    g = synthetic_graph(1500, 8, 24, 6, seed=4)
    cfg = TrainConfig(model=model, kernel="hyb", agg_dtype="bfloat16", epochs=7, eval_every=2,
                      epochs_per_call=3, staleness=1, reuse="off",
                      learning_rate=0.005 if model == "gat" else 0.01)
    return [ShardedEngine(g, LayerConfig([24, 16, 6]), cfg, device=cuda) for _ in range(2)]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_sharded_graph_run_equals_the_eager_loop(cuda, model):
    """The no-group ShardedEngine through its CUDA graphs against the eager
    loop from the same init, two run()s each: losses, accuracies, params,
    Adam's state and launch counts bit for bit; the second run captures
    nothing."""
    from dorylus_tpu_torch.ops import hyb_spmm

    def counts():
        return {k: v for k, v in vars(hyb_spmm).items() if k.endswith("_LAUNCHES")}

    graphed, eager = _sharded_engines(cuda, model)
    assert graphed.graph_refusal is None
    runs = []
    for eng, use in ((graphed, True), (eager, False)):
        for second in (False, True):
            before = counts()
            rep = eng.run(graphs=use)
            torch.cuda.synchronize()
            runs.append(([e.loss for e in rep.epochs], [e.accuracy for e in rep.epochs],
                         {k: n - before[k] for k, n in counts().items()}))
            if use and not second:
                captures, kept = graphed._graphs.captures, graphed._graphs
    assert runs[:2] == runs[2:] and sum(runs[0][2].values()) > 0
    assert graphed._graphs is kept and kept.captures == captures == 2
    for k, p in graphed.params.items():
        assert torch.equal(p, eager.params[k]), k
        assert torch.equal(graphed.opt_state.m[k], eager.opt_state.m[k]), k
    assert graphed.opt_state.step == eager.opt_state.step == 14


def test_engine_second_run_captures_nothing(cuda):
    """Engine's graphs outlive run(): the second run replays from its first
    epoch; new Adam tensors lead to a new capture of train alone."""
    graphed, eager = _graph_engines(cuda, "hyb gcn", 1)
    graphed.run()
    kept = graphed._graphs
    graphed.run()
    assert graphed._graphs is kept and kept.captures == 2
    st = graphed.opt_state
    graphed.opt_state = st._replace(m={k: t.clone() for k, t in st.m.items()},
                                    v={k: t.clone() for k, t in st.v.items()})
    rep = graphed.run()
    assert kept.captures == 3
    for _ in range(3):
        want = eager.run(graphs=False)
    assert [e.loss for e in rep.epochs] == [e.loss for e in want.epochs]


def test_one_nccl_rank_replays_as_eager(cuda):
    """A world of one over NCCL: the rank's engine captures its epochs and
    equals an eager engine from the same init bit for bit; its collectives
    captured in one graph replay exactly."""
    import _torch_ranks as ranks
    from dorylus_tpu_torch.graph.graph import synthetic_graph
    from dorylus_tpu_torch.ops import cuda_build, hyb_sharded, hyb_spmm
    from dorylus_tpu_torch.parallel import halo
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    cuda_build.compile_sources([hyb_spmm._CSRC, hyb_sharded._CSRC, halo._CSRC])
    g = synthetic_graph(600, 8, 33, 5, seed=2)
    kw = dict(model="gcn", kernel="hyb", eval_every=2, epochs_per_call=3, staleness=1)
    runs = [(kw, 6, {}), (kw, 6, {"sequence": [{"graphs": False}]})]
    res = spawn_local(1, ranks.engines_rank, (g, [33, 16, 5], runs), backend="nccl",
                      device="cuda:{rank}", timeout_s=300)[0]
    graphed, eager = res
    assert graphed["graph_refusal"] is None and graphed["runs"][0]["graphed"]
    assert not eager["runs"][0]["graphed"]
    assert graphed["losses"] == eager["losses"] and np.isfinite(graphed["losses"]).all()
    exact = spawn_local(1, ranks.collective_capture_rank, (), backend="nccl",
                        device="cuda:{rank}", timeout_s=300)[0]
    assert exact == [True] * 3


def test_a_failed_sharded_capture_raises(cuda):
    """A host read inside the sharded engine's captured epoch fails the
    capture, and run() raises: nothing falls back to the eager loop."""
    graphed, _ = _sharded_engines(cuda, "gcn")
    loss = graphed.model.loss

    def loss_with_a_host_read(*args, **kw):
        out = loss(*args, **kw)
        float(out)  # a device wait: refused while the stream is captured
        return out

    graphed.model.loss = loss_with_a_host_read
    with pytest.raises(RuntimeError):
        graphed.run()
