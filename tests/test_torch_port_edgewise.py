"""dorylus_tpu_torch's edgewise path (ops/spmm.py: the CSR op behind
kernel="xla") against dorylus_tpu/ops/spmm.py on the same inputs (CPU),
and GCN on that path against the JAX GCN with no op bound.

Inputs come from numpy seeds and go to both packages; the port's CPU path
is the plain torch version of each kernel. Tolerances:
  * f32: rtol/atol 1e-5 (only the summation order differs);
  * bf16 h: JAX's bf16 segment-sum accumulates IN bf16 on the CPU (1,000
    ones sum to 256, test_jax_bf16_segment_sum_accumulates_in_bf16),
    while the port sums in f32. Each of a row's d adds in JAX rounds at
    2^-9 relative, so the two differ by up to ~d·2^-9 of a row's partial
    sums: with ~10 edges per row, max abs error <= 2e-2 * max|ref|. dh
    takes the same bound. dval: JAX rounds each of the F products and the
    result to bf16 (2^-9 relative each), the port forms f32 products of
    the bf16 rows; the dots cancel, so the bound is 1e-2 of the largest
    sum of |products|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu.engine.batch import build_batch as jbuild_batch
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.models.gcn import GCN as JGCN
from dorylus_tpu.ops import spmm as jspmm
from dorylus_tpu_torch import interop
from dorylus_tpu_torch.engine.batch import build_batch as tbuild_batch
from dorylus_tpu_torch.models.gcn import GCN as TGCN
from dorylus_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)


def _edges(v_in, v_out, e, seed, powerlaw=False):
    """dst-sorted random edges; powerlaw: Zipf in-degrees with empty rows
    and one row of 1,500 edges."""
    rng = np.random.default_rng(seed)
    if powerlaw:
        deg = np.minimum(rng.zipf(1.7, v_out), 60)
        deg[rng.integers(0, v_out)] = 1500
        deg[:3] = 0
        dst = np.repeat(np.arange(v_out, dtype=np.int32), deg)
    else:
        dst = np.sort(rng.integers(0, v_out, size=e).astype(np.int32))
    src = rng.integers(0, v_in, size=len(dst)).astype(np.int32)
    val = rng.normal(0, 1, size=len(dst)).astype(np.float32)
    return src, dst, val


def _inputs(case, seed=0):
    if case == "uniform":
        src, dst, val = _edges(57, 41, 400, seed=3)
        v_in, v_out = 57, 41
    else:
        src, dst, val = _edges(70, 50, 0, seed=5, powerlaw=True)
        v_in, v_out = 70, 50
    rng = np.random.default_rng(seed)
    f = 9
    h = rng.normal(0, 1, (v_in, f)).astype(np.float32)
    gout = rng.normal(0, 1, (v_out, f)).astype(np.float32)
    return src, dst, val, v_in, v_out, h, gout


def _close(got, ref, narrow, bound=2e-2):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if narrow:
        assert np.abs(got - ref).max() <= bound * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["uniform", "powerlaw"])
def test_spmm_edgewise_fwd_dh_dval_match_jax(case, narrow):
    src, dst, val, v_in, v_out, h, gout = _inputs(case)
    jdt = jnp.bfloat16 if narrow else jnp.float32
    tdt = torch.bfloat16 if narrow else torch.float32

    def jf(hh, vv):
        return jspmm.spmm_edgewise(hh, jnp.asarray(src), jnp.asarray(dst), vv,
                                   v_out, sorted_dst=True)

    ref, vjp = jax.vjp(jf, jnp.asarray(h, jdt), jnp.asarray(val))
    ref_dh, ref_dval = vjp(jnp.asarray(gout, jdt))
    if narrow and case == "powerlaw":
        # A 1,500-edge row is past what JAX's bf16 accumulation holds to
        # 2e-2: hold the port to the same bf16 products summed in f32.
        def sums(table, idx, seg, n):
            msgs = table[idx] * jnp.asarray(val).astype(jnp.bfloat16)[:, None]
            return jax.ops.segment_sum(msgs.astype(jnp.float32), seg, n)

        ref = sums(jnp.asarray(h, jdt), src, dst, v_out)
        ref_dh = sums(jnp.asarray(gout, jdt), dst, src, v_in)

    op = tspmm.EdgeSpMM(src, dst, v_in, v_out, device="cpu")
    ht = torch.tensor(h).to(tdt).requires_grad_(True)
    vt = torch.tensor(val, requires_grad=True)
    out = tspmm.spmm_edgewise(ht, torch.tensor(src), torch.tensor(dst), vt, v_out,
                              op=op)
    out.backward(torch.tensor(gout).to(tdt))
    assert out.dtype == ht.grad.dtype == tdt and vt.grad.dtype == torch.float32
    _close(out.detach().float(), ref.astype(jnp.float32), narrow)
    _close(ht.grad.float(), ref_dh.astype(jnp.float32), narrow)
    if narrow:
        # bf16 dots cancel: bound the error by their sums of |terms|
        terms = np.abs(np.asarray(jnp.asarray(h, jdt)[src] * jnp.asarray(gout, jdt)[dst],
                                  np.float32)).sum(-1)
        assert np.abs(vt.grad.numpy() - np.asarray(ref_dval)).max() <= 1e-2 * terms.max()
    else:
        _close(vt.grad, ref_dval, narrow)


def test_jax_bf16_segment_sum_accumulates_in_bf16():
    """What the bf16 tolerance above rests on: JAX's bf16 segment_sum adds
    in bf16 (a run of 1,000 ones stops at 256), the port's in f32."""
    ones = np.ones(1000, np.float32)
    seg = np.zeros(1000, np.int32)
    ref = jax.ops.segment_sum(jnp.asarray(ones, jnp.bfloat16)[:, None],
                              jnp.asarray(seg), num_segments=1,
                              indices_are_sorted=True)
    assert float(ref[0, 0]) == 256.0
    row_ptr = torch.tensor([0, 1000], dtype=torch.int32)
    got = tspmm.segment_sum_plain(torch.ones(1000, 1, dtype=torch.bfloat16), row_ptr)
    assert float(got[0, 0]) == 1000.0


@pytest.mark.parametrize("with_table", [False, True], ids=["h", "h_table"])
def test_aggregate_matches_jax(with_table):
    src, dst, val, v_in, v_out, h, _ = _inputs("uniform", seed=1)
    # aggregate's output rows are h's: a square graph over h's rows, the
    # gather table optionally wider (extra rows, as a halo table has)
    keep = (dst < v_in) & (src < (v_in if not with_table else v_in + 10))
    src, dst, val = src[keep], dst[keep], val[keep]
    hh = h[:v_out]
    table = np.concatenate([hh, h[: v_in - v_out + 10]]) if with_table else hh
    src = src % table.shape[0]
    self_val = np.random.default_rng(2).uniform(0.1, 1, v_out).astype(np.float32)
    ref = jspmm.aggregate(jnp.asarray(hh), jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(val), jnp.asarray(self_val),
                          h_table=jnp.asarray(table) if with_table else None,
                          sorted_dst=True)
    op = tspmm.EdgeSpMM(src, dst, table.shape[0], v_out, device="cpu")
    got = tspmm.aggregate(torch.tensor(hh), torch.tensor(src), torch.tensor(dst),
                          torch.tensor(val), torch.tensor(self_val),
                          h_table=torch.tensor(table) if with_table else None,
                          op=op)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ["N", "NF"])
def test_take_sorted_fwd_bwd_match_jax(shape):
    src, dst, _, v_in, v_out, h, _ = _inputs("powerlaw", seed=4)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(v_out,) if shape == "N" else (v_out, 5)).astype(np.float32)
    g = rng.normal(size=(len(dst),) + x.shape[1:]).astype(np.float32)
    ref, vjp = jax.vjp(lambda xx: jspmm.take_sorted(xx, jnp.asarray(dst), v_out),
                       jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    op = tspmm.EdgeSpMM(src, dst, v_in, v_out, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    out = tspmm.take_sorted(xt, torch.tensor(dst), v_out, op=op)
    out.backward(torch.tensor(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-5,
                               atol=1e-5)
    assert float(xt.grad[:3].abs().sum()) == 0.0  # rows with no edges


@pytest.mark.parametrize("val_flat", [False, True], ids=["baked", "val_flat"])
def test_spmm_dst_blocked_matches_jax(val_flat):
    """JAX's blocked form with 16-row blocks against the port's CSR op."""
    src, dst, val, v_in, v_out, h, _ = _inputs("powerlaw", seed=7)
    blk, rows = jspmm.build_dst_blocks(src, dst, val, v_out, block_rows=16)
    assert blk["src"].shape[0] == -(-v_out // 16) > 1
    flat = (np.random.default_rng(8).normal(size=len(src)).astype(np.float32)
            if val_flat else None)
    ref = jspmm.spmm_dst_blocked(jnp.asarray(h), jax.tree.map(jnp.asarray, blk),
                                 v_out, rows,
                                 val_flat=None if flat is None else jnp.asarray(flat))
    op = tspmm.EdgeSpMM(src, dst, v_in, v_out, device="cpu")
    got = tspmm.spmm_dst_blocked(torch.tensor(h), torch.tensor(src),
                                 torch.tensor(dst),
                                 torch.tensor(val if flat is None else flat),
                                 v_out, 16, op=op)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_csr_plain_versions_on_empty_and_long_rows():
    """The plain kernels against numpy on rows of 0 and 1,500 edges."""
    src, dst, val, v_in, v_out, h, gout = _inputs("powerlaw", seed=9)
    assert np.bincount(dst, minlength=v_out).max() == 1500
    op = tspmm.EdgeSpMM(src, dst, v_in, v_out, device="cpu")
    want = np.zeros((v_out, h.shape[1]), np.float64)
    np.add.at(want, dst, val[:, None].astype(np.float64) * h[src])
    got = tspmm.csr_spmm(torch.tensor(h), op.row_ptr, torch.tensor(src),
                         torch.tensor(val))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    want_dh = np.zeros_like(h, dtype=np.float64)
    np.add.at(want_dh, src, val[:, None].astype(np.float64) * gout[dst])
    got_dh = tspmm.csr_spmm(torch.tensor(gout), op.t_row_ptr, op.t_col,
                            torch.tensor(val), op.order)
    np.testing.assert_allclose(got_dh.numpy(), want_dh, rtol=1e-5, atol=1e-4)
    dval = tspmm.sddmm(torch.tensor(h), torch.tensor(gout), op.row_ptr,
                       torch.tensor(src))
    np.testing.assert_allclose(dval.numpy(), (h[src] * gout[dst]).sum(-1),
                               rtol=1e-5, atol=1e-5)
    seg = tspmm.segment_sum(torch.tensor(val), op.row_ptr)
    np.testing.assert_allclose(seg.numpy(), np.bincount(dst, val, minlength=v_out),
                               rtol=1e-5, atol=1e-4)


def test_edge_op_validates_and_kernels_refuse_cpu_tensors():
    src, dst, val, v_in, v_out, h, gout = _inputs("uniform")
    with pytest.raises(ValueError, match="dst-sorted"):
        tspmm.EdgeSpMM(src, dst[::-1].copy(), v_in, v_out, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tspmm.EdgeSpMM(src, dst, 10, v_out, device="cpu")
    op = tspmm.EdgeSpMM(src, dst, v_in, v_out, device="cpu")
    args = (torch.tensor(h), torch.tensor(src), torch.tensor(dst), torch.tensor(val))
    with pytest.raises(ValueError, match="dst-sorted"):
        tspmm.spmm_edgewise(*args, v_out, sorted_dst=False, op=op)
    with pytest.raises(ValueError, match="does not match"):
        tspmm.spmm_edgewise(args[0], args[1][:-1], args[2], args[3], v_out, op=op)
    ht, rp, col, vt = args[0], op.row_ptr, args[1], args[3]
    out = torch.zeros((v_out, h.shape[1]))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm._launch_csr_spmm(ht, rp, col, vt, None, out)
    with pytest.raises(ValueError, match="CUDA"):
        tspmm._launch_sddmm(ht, torch.tensor(gout), rp, col, torch.zeros(len(src)))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm._launch_csr_spmm_dval(torch.tensor(gout), ht, op.t_row_ptr, op.t_col, vt,
                                    op.order, torch.zeros((v_in, h.shape[1])),
                                    torch.zeros(len(src)))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm._launch_segment_sum(vt, rp, torch.zeros(v_out))
    with pytest.raises(ValueError, match="unsupported device"):
        tspmm.csr_spmm(torch.zeros((v_in, 4), device="meta"), rp, col, vt)
    with pytest.raises(ValueError, match="unsupported device"):
        tspmm.csr_spmm_dval(torch.zeros((v_out, 4), device="meta"), torch.zeros((v_in, 4)),
                            op.t_row_ptr, op.t_col, vt, op.order, op.inv_order)
    assert (tspmm.SPMM_LAUNCHES == tspmm.SPMM_T_LAUNCHES == tspmm.SPMM_DVAL_LAUNCHES
            == tspmm.SDDMM_LAUNCHES == tspmm.SEGSUM_LAUNCHES == 0)


DIMS = [32, 16, 6]


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(300, 6, DIMS[0], DIMS[-1], seed=23)


def _gcn_models(g, blk_rows=0):
    layers = LayerConfig(DIMS)
    jbatch = jbuild_batch(g)
    if blk_rows:
        blk, _ = jspmm.build_dst_blocks(g.src, g.dst, g.edge_norm, g.num_vertices,
                                        block_rows=blk_rows)
        jbatch = jbatch._replace(aux={"blk": jax.tree.map(jnp.asarray, blk)})
    jmodel = JGCN(layers, blk_rows=blk_rows)
    op = tspmm.EdgeSpMM(g.src, g.dst, g.num_vertices, g.num_vertices, device="cpu")
    tmodel = TGCN(layers, edge_op=op, blk_rows=blk_rows)
    jparams = jmodel.init_params(seed=8888)
    tmodel.load_state_dict(interop.params_from_numpy(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu"))
    return jmodel, jbatch, jparams, tmodel, tbuild_batch(g, "cpu")


@pytest.mark.parametrize("blk_rows", [0, 64], ids=["edgewise", "dst_blocked"])
def test_gcn_edgewise_loss_and_grads_match_jax(graph, blk_rows):
    jmodel, jbatch, jparams, tmodel, tbatch = _gcn_models(graph, blk_rows)
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(jparams)
    tloss = tmodel.loss(tbatch)
    names = list(tmodel.params())
    tgrads = torch.autograd.grad(tloss, [tmodel.params()[k] for k in names])
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for k, tg in zip(names, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jgrads[k]), rtol=1e-5,
                                   atol=1e-7)
    # aggregate-first ordering and bf16 compute give the same logits
    jmodel.optimize_order = tmodel.optimize_order = False
    for cd, jcd, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2e-2)):
        ref = np.asarray(jmodel.forward(jparams, jbatch, compute_dtype=jcd))
        got = tmodel.forward(tbatch, compute_dtype=cd).detach().numpy()
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
