"""The edgewise CSR pass of the gather core (K3, K4 and the two fused; ops/spmm.py on
csrc/gather_pass.cuh `csr_team`) without a card, and its plain fused version
against JAX.

  * what the host builds for the CSR team: the launch geometry
    (`gather_parts.csr_geometry`: lanes a group, the wide-row rule, blocks)
    and the padded table (`gather_table`: rows of a multiple of 16 bytes,
    an aligned table used as it is);
  * `gather_parts.walk_csr_plain`, the pass walked team by team in plain
    torch as the kernel runs it (the slots each group takes, the column
    tiles, the reduce-scatter that hands each edge's dot to the lane that
    loaded it), against `csr_spmm_plain`, `sddmm_plain` and
    `csr_spmm_dval_plain`: every output row and every edge value written
    once;
  * `csr_spmm_dval_plain` (K3's dh and K4's dval composed) against
    `jax.vjp` of dorylus_tpu.ops.spmm.spmm_edgewise on the same numpy
    inputs.

Graphs: "powerlaw" (Zipf in-degrees, empty rows, a row of 1,200 edges; the
src-sorted order is a permutation), "identity" (src and dst both sorted:
the order is the identity) and "dense" (80 edges a row: the wide rows,
a warp a row). F in {1, 8, 41, 128, 300} (300 walks column tiles), f32 and
bf16. Tolerances: f32 1e-5 of max|ref| (summation order only); bf16 2e-3
of max|ref| (the port rounds each product val * gout to bf16 and sums in
f32; JAX is fed the bf16 values in f32 and forms f32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.ops import spmm as jspmm
from dorylus_tpu_torch.ops import spmm as tspmm
from dorylus_tpu_torch.ops.gather_parts import (WIDE_SLOTS, csr_geometry, gather_table,
                                                walk_csr_plain)

torch.set_num_threads(1)

FS = [1, 8, 41, 128, 300]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


def _graph(kind, seed=0):
    """(src, dst, val, v): dst-sorted edges of v vertices."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        v = 60
        dst = np.sort(rng.integers(0, v, size=v * 80)).astype(np.int32)
        src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    elif kind == "identity":
        v = 150
        dst = np.sort(rng.integers(0, v, size=900)).astype(np.int32)
        src = dst // 2  # non-decreasing with dst: the src-sorted order is the identity
    else:
        v = 150
        deg = np.minimum(rng.zipf(1.6, v), 40)
        deg[:4] = 0
        deg[7] = 1200  # a row of more than 1,000 edges
        dst = np.repeat(np.arange(v, dtype=np.int32), deg)
        src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    return src, dst, rng.normal(0, 1, size=len(dst)).astype(np.float32), v


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()) / float(ref.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("f", FS)
def test_csr_geometry_and_padded_table(f, dtype):
    """Rows of g lanes at 16 bytes each; a warp a row where rows average
    WIDE_SLOTS edges; the blocks cover every row once; the table padded to
    a multiple of 16 bytes with zero columns, an aligned one not copied."""
    h = torch.randn(37, f).to(dtype)
    tb = gather_table(h, dtype)
    vec = 16 // tb.element_size()
    assert tb.shape == (37, -(-f // vec) * vec) and bool((tb[:, f:] == 0).all())
    assert torch.equal(tb[:, :f], h)
    if f % vec == 0:
        assert tb.data_ptr() == h.data_ptr()  # used as it is
    ld = tb.shape[1]
    pieces = ld * tb.element_size() // 16
    for n_rows, n_edges in ((1000, 50_000), (1000, WIDE_SLOTS * 1000), (0, 0), (7, 1)):
        geo = csr_geometry(ld, tb.element_size(), n_rows, n_edges)
        g, r = geo["g"], geo["r"]
        assert g in (8, 16, 32) and (g >= pieces or g == 32)
        assert r == (32 // g if n_edges >= WIDE_SLOTS * n_rows else 1)
        assert geo["rows_a_block"] * g * r == 256
        assert geo["blocks"] * geo["rows_a_block"] >= n_rows
        assert (geo["blocks"] - 1) * geo["rows_a_block"] < max(n_rows, 1)
        assert geo["unroll"] == (8 if tb.element_size() == 4 and g == 32 else 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("kind", ["powerlaw", "identity", "dense"])
def test_walk_matches_the_plain_passes(kind, f, dtype):
    """K3's forward (dst CSR), K3's dh alone and fused with K4's dval (src
    CSR through `order`), K4 alone (dst CSR), walked as the kernel runs
    them, against the plain versions; each dval entry written once."""
    src, dst, val, v = _graph(kind, seed=f)
    op = tspmm.EdgeSpMM(src, dst, v, v, device="cpu")
    if kind == "identity":
        assert torch.equal(op.order, torch.arange(len(src), dtype=torch.int32))
    rng = np.random.default_rng(f + 1)
    h = torch.tensor(rng.normal(size=(v, f)).astype(np.float32)).to(dtype)
    gout = torch.tensor(rng.normal(size=(v, f)).astype(np.float32)).to(dtype)
    s_t, v_t = torch.tensor(src), torch.tensor(val)
    tb_h, tb_g = gather_table(h, dtype), gather_table(gout, dtype)
    tol = TOL[dtype]

    out, _, _ = walk_csr_plain(tb_h, None, op.row_ptr, s_t, v_t, None, f)
    assert _rel(out, tspmm.csr_spmm_plain(h, op.row_ptr, s_t, v_t)) <= tol
    dh_ref, dval_ref = tspmm.csr_spmm_dval_plain(gout, h, op.t_row_ptr, op.t_col, v_t,
                                                 op.order, op.inv_order)
    out, _, _ = walk_csr_plain(tb_g, None, op.t_row_ptr, op.t_col, v_t, op.order, f)
    assert _rel(out, dh_ref) <= tol
    out, dval, writes = walk_csr_plain(tb_g, tb_h, op.t_row_ptr, op.t_col, v_t, op.order, f)
    # the pass writes dval in the src CSR's order; inv_order puts it in the edges'
    assert _rel(out, dh_ref) <= tol and _rel(dval[op.inv_order.long()], dval_ref) <= tol
    assert bool((writes == 1).all())
    _, dval, writes = walk_csr_plain(tb_h, tb_g, op.row_ptr, s_t, None, None, f)
    assert _rel(dval, tspmm.sddmm_plain(h, gout, op.row_ptr, s_t)) <= tol
    assert bool((writes == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("kind", ["powerlaw", "identity"])
def test_fused_plain_matches_jax_vjp(kind, f, dtype):
    """The plain fused dh + dval against jax.vjp of spmm_edgewise: dh over
    the src CSR, dval in the dst-sorted edge order; and the edgewise op's
    backward, which runs it when both inputs need a gradient. JAX runs in
    f32 on the values the port holds (bf16 h and gout, as f32): its dval is
    then the port's f32 dot of the bf16 rows. In bf16 its dh would add the
    1,200-edge row in bf16 (tests/test_torch_port_edgewise.py), so dh is
    held against the vjp's transpose formed as the port forms it: each
    product gout * val rounded to bf16, the sums in f32."""
    src, dst, val, v = _graph(kind, seed=f + 2)
    rng = np.random.default_rng(f + 3)
    h = torch.tensor(rng.normal(size=(v, f)).astype(np.float32)).to(dtype)
    gout = torch.tensor(rng.normal(size=(v, f)).astype(np.float32)).to(dtype)

    def jf(hh, vv):
        return jspmm.spmm_edgewise(hh, jnp.asarray(src), jnp.asarray(dst), vv, v,
                                   sorted_dst=True)

    @jax.jit
    def grads(hh, vv, gg):
        return jax.vjp(jf, hh, vv)[1](gg)

    ref_dh, ref_dval = grads(jnp.asarray(h.float().numpy()), jnp.asarray(val),
                             jnp.asarray(gout.float().numpy()))
    if dtype == torch.bfloat16:
        msgs = (jnp.asarray(gout.float().numpy(), jnp.bfloat16)[dst]
                * jnp.asarray(val).astype(jnp.bfloat16)[:, None])
        ref_dh = jax.ops.segment_sum(msgs.astype(jnp.float32), src, v)
    ref_dh, ref_dval = torch.tensor(np.asarray(ref_dh)), torch.tensor(np.asarray(ref_dval))

    op = tspmm.EdgeSpMM(src, dst, v, v, device="cpu")
    dh, dval = tspmm.csr_spmm_dval_plain(gout, h, op.t_row_ptr, op.t_col, torch.tensor(val),
                                         op.order, op.inv_order)
    assert torch.equal(op.order.long()[op.inv_order.long()], torch.arange(len(src)))
    assert _rel(dh, ref_dh) <= TOL[dtype] and _rel(dval, ref_dval) <= TOL[dtype]
    hk = h.clone().requires_grad_(True)
    vk = torch.tensor(val, requires_grad=True)
    tspmm.spmm_edgewise(hk, torch.tensor(src), torch.tensor(dst), vk, v, op=op).backward(gout)
    assert torch.equal(hk.grad, dh.to(dtype)) and torch.equal(vk.grad, dval)
