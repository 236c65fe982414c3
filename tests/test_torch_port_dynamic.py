"""dorylus_tpu_torch's dynamic-value hybrid-ELL mode (`HybSpMM(dynamic=True)
.apply`) against dorylus_tpu's `hyb_spmm_apply` on the same inputs (CPU),
and GCN on an op without static values against the JAX GCN's branch for
one (`models/gcn.py:214-216`).

The port's CPU path is the plain torch version of the dynamic pass.
Tolerances: f32 output, dh and dval rtol 1e-5, atol 1e-5 (only the
summation order differs); bf16 gather tables max abs error <= 2e-3 *
max|ref| (the same bf16 weights and products summed in another order);
GCN loss rtol 1e-5 and gradients rtol 1e-5 (f32), 2e-3 of the largest
entry (bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu.engine.batch import build_batch as jbuild_batch
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.graph.reorder import apply_order, degree_order
from dorylus_tpu.models.gcn import GCN as JGCN
from dorylus_tpu.ops import degree_spmm as jdeg
from dorylus_tpu.ops import hyb_spmm as jhyb
from dorylus_tpu_torch import interop
from dorylus_tpu_torch.engine.batch import build_batch as tbuild_batch
from dorylus_tpu_torch.models.gcn import GCN as TGCN
from dorylus_tpu_torch.ops import degree_spmm as tdeg
from dorylus_tpu_torch.ops import hyb_spmm as thyb

torch.set_num_threads(1)


def _random_edges(v_in, v_out, e, seed, powerlaw=False):
    rng = np.random.default_rng(seed)
    if powerlaw:
        deg = np.minimum(rng.zipf(1.5, v_out), 200)
        dst = np.sort(np.repeat(rng.permutation(v_out).astype(np.int32), deg)[:e])
    else:
        dst = np.sort(rng.integers(0, v_out, size=e).astype(np.int32))
    src = rng.integers(0, v_in, size=len(dst)).astype(np.int32)
    val = rng.normal(0, 1, size=len(dst)).astype(np.float32)
    return src, dst, val


# case -> (src, dst, val, num_in, num_out, builder kwargs)
def _case(name):
    if name == "uniform":
        return (*_random_edges(57, 41, 400, seed=3), 57, 41, {"lam_slots": 16})
    if name == "hubs":  # hub chunk rows and the inv layout in both plans
        return (*_random_edges(60, 40, 500, seed=5, powerlaw=True), 60, 40,
                {"max_width": 8, "lam_slots": 4})
    if name == "sorted":  # the _n_iso layout (degree-ascending vertex ids)
        g0 = synthetic_graph(300, 6, 8, 4, seed=51)
        g = apply_order(g0, degree_order(g0, ascending=True))
        val = np.random.default_rng(9).normal(size=g.num_edges).astype(np.float32)
        return g.src, g.dst, val, g.num_vertices, g.num_vertices, {"lam_slots": 64}
    raise KeyError(name)


def _close(got, ref, narrow):
    got, ref = np.asarray(got), np.asarray(ref)
    if narrow:
        assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["uniform", "hubs", "sorted"])
def test_hyb_dynamic_matches_jax(case, narrow):
    """Forward, dh and dval of `apply` against JAX's `hyb_spmm_apply` and
    its fused-SDDMM backward."""
    src, dst, val, num_in, num_out, kw = _case(case)
    jop = jhyb.HybSpMM(src, dst, num_in, num_out, dynamic=True,
                       gather_dtype=jnp.bfloat16 if narrow else None, **kw)
    top = thyb.HybSpMM(src, dst, num_in, num_out, dynamic=True,
                       gather_dtype=torch.bfloat16 if narrow else None, device="cpu", **kw)
    if case == "hubs":
        assert top.fwd["top"] is not None and "inv" in top.fwd and "inv" in top.bwd
        assert "s2e" in top.fwd["top"] and top.fwd["n_edges"] == len(src)
    if case == "sorted":
        assert "n_iso" in top.fwd
    rng = np.random.default_rng(19)
    f = 9
    h = rng.normal(0, 1, (num_in, f)).astype(np.float32)
    gout = rng.normal(0, 1, (num_out, f)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda hh, vv: jop.apply(jop.arrays, hh, vv),
                           jnp.asarray(h), jnp.asarray(val))
    ref_dh, ref_dval = vjp(jnp.asarray(gout))

    ht = torch.tensor(h, requires_grad=True)
    vt = torch.tensor(val, requires_grad=True)
    out = top.apply(ht, vt)
    out.backward(torch.tensor(gout))
    assert out.dtype == ht.grad.dtype == vt.grad.dtype == torch.float32
    for got, ref in ((out.detach(), ref_out), (ht.grad, ref_dh), (vt.grad, ref_dval)):
        _close(got, ref, narrow)


def test_dynamic_backward_skips_the_sddmm_without_val_grad():
    """With val not requiring a gradient the backward runs the pass
    without the fused SDDMM; dh is unchanged."""
    src, dst, val, num_in, num_out, kw = _case("hubs")
    op = thyb.HybSpMM(src, dst, num_in, num_out, dynamic=True, device="cpu", **kw)
    rng = np.random.default_rng(23)
    h = rng.normal(0, 1, (num_in, 5)).astype(np.float32)
    gout = torch.tensor(rng.normal(0, 1, (num_out, 5)).astype(np.float32))
    grads = []
    for needs_val in (True, False):
        ht = torch.tensor(h, requires_grad=True)
        vt = torch.tensor(val, requires_grad=needs_val)
        op.apply(ht, vt).backward(gout)
        grads.append(ht.grad)
        assert (vt.grad is not None) == needs_val
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    out, dval = thyb.hyb_dynamic_pass(gout, op.bwd, num_in, torch.tensor(val),
                                      other=torch.tensor(h))
    np.testing.assert_allclose(out.numpy(), grads[1].numpy(), rtol=0, atol=0)
    assert dval.shape == (len(src),)


def test_dynamic_kernel_path_raises_off_cuda():
    """K7's launcher never computes on a non-CUDA tensor; the dispatcher
    raises for devices that are neither CPU nor CUDA."""
    src, dst, val, num_in, num_out, kw = _case("hubs")
    op = thyb.HybSpMM(src, dst, num_in, num_out, dynamic=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        thyb._launch_dyn_pass(torch.zeros((num_in, 4)), op.fwd, torch.tensor(val),
                              torch.zeros((num_out, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        thyb.hyb_dynamic_pass(torch.zeros((num_in, 4), device="meta"), op.fwd,
                              num_out, torch.tensor(val))
    assert thyb.DYN_LAUNCHES == thyb.DYN_T_LAUNCHES == thyb.DYN_DVAL_LAUNCHES == 0


DIMS = [32, 16, 6]


@pytest.mark.parametrize("narrow", [False, True], ids=["agg_f32", "agg_bf16"])
@pytest.mark.parametrize("kind", ["hyb", "degree"])
def test_gcn_on_op_without_static_values_matches_jax(kind, narrow):
    """GCN aggregating through `op.apply(h, edge_val)`: a dynamic HybSpMM
    or a DegreeSpMM built without static values, with the batch's COO
    arrays shipped (the JAX engine's rule for such an op)."""
    g = synthetic_graph(300, 6, DIMS[0], DIMS[-1], seed=27)
    layers = LayerConfig(DIMS)
    v = g.num_vertices
    jgd = jnp.bfloat16 if narrow else None
    tgd = torch.bfloat16 if narrow else None
    if kind == "hyb":
        jop = jhyb.HybSpMM(g.src, g.dst, v, v, dynamic=True, gather_dtype=jgd,
                           lam_slots=64)
        top = thyb.HybSpMM(g.src, g.dst, v, v, dynamic=True, gather_dtype=tgd,
                           lam_slots=64, device="cpu")
    else:
        jop = jdeg.DegreeSpMM(g.src, g.dst, v, v, gather_dtype=jgd)
        top = tdeg.DegreeSpMM(g.src, g.dst, v, v, gather_dtype=tgd, device="cpu")
    assert not top.has_static_vals
    jmodel = JGCN(layers, spmm_op=jop)
    jbatch = jbuild_batch(g)._replace(aux={"spmm": jop.arrays})
    tmodel = TGCN(layers, spmm_op=top)
    tbatch = tbuild_batch(g, "cpu")
    jparams = jmodel.init_params(seed=8888)
    tmodel.load_state_dict(interop.params_from_numpy(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu"))
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(jparams)
    tloss = tmodel.loss(tbatch)
    names = list(tmodel.params())
    tgrads = torch.autograd.grad(tloss, [tmodel.params()[k] for k in names])
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=2e-3 if narrow else 1e-5)
    for k, tg in zip(names, tgrads):
        ref = np.asarray(jgrads[k])
        if narrow:
            assert np.abs(tg.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()
        else:
            np.testing.assert_allclose(tg.numpy(), ref, rtol=1e-5, atol=1e-7)
