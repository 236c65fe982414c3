"""dorylus_tpu_torch GAT against dorylus_tpu's GAT on the same graph, plans
and params (CPU), and against the dense numpy oracle (tests/oracle.py).

Both aggregation paths: hyb (mask-mode HybSpMM, apply_dst) and edgewise
(take_sorted + the CSR op), plus JAX's dst-blocked branch routed to the
edgewise op. The JAX params cross over as numpy arrays.

GAT's losses are O(100) at init by design (unnormalised LeakyReLU
attention), so every comparison is relative. Tolerances: f32 loss rtol
1e-5, gradients rtol 1e-5 with atol 1e-6 of the largest entry; bf16 gather
tables 5e-3 of the largest entry (bf16 tables rounded at 2^-9, summed in
another order; attention multiplies the error through two layers);
bf16 compute 2e-2 of the largest logit; oracle (f64) rtol 1e-3, atol 1e-4
of the largest logit, as tests/test_gat_oracle.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu.engine.batch import build_batch as jbuild_batch
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.models.gat import GAT as JGAT
from dorylus_tpu.ops import spmm as jspmm
from dorylus_tpu.ops.hyb_spmm import HybSpMM as JHyb
from dorylus_tpu_torch import interop
from dorylus_tpu_torch.engine.batch import build_batch as tbuild_batch
from dorylus_tpu_torch.models.gat import GAT as TGAT
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM as THyb
from dorylus_tpu_torch.ops.spmm import EdgeSpMM

from oracle import gat_forward

torch.set_num_threads(1)

DIMS = [24, 12, 5]
BLK_ROWS = 64


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(200, 5, DIMS[0], DIMS[-1], seed=41)


def _models(g, path, narrow=False):
    """(jmodel, jbatch, jparams, tmodel, tbatch) for path "hyb",
    "edgewise" or "dst_blocked"."""
    layers = LayerConfig(DIMS)
    v = g.num_vertices
    if path == "hyb":
        jop = JHyb(g.src, g.dst, v, v, dynamic=False, lam_slots=64,
                   gather_dtype=jnp.bfloat16 if narrow else None)
        jmodel = JGAT(layers, spmm_op=jop)
        jbatch = jbuild_batch(g, for_gat=True, edge_arrays=False)._replace(
            aux={"spmm": jop.arrays})
        top = THyb(g.src, g.dst, v, v, lam_slots=64,
                   gather_dtype=torch.bfloat16 if narrow else None, device="cpu")
        tmodel = TGAT(layers, spmm_op=top)
        tbatch = tbuild_batch(g, "cpu", for_gat=True, edge_arrays=False)
    else:
        blk_rows = BLK_ROWS if path == "dst_blocked" else 0
        jmodel = JGAT(layers, blk_rows=blk_rows)
        jbatch = jbuild_batch(g, for_gat=True)
        if blk_rows:
            blk, _ = jspmm.build_dst_blocks(g.src, g.dst, np.ones(g.num_edges, np.float32),
                                            v, block_rows=blk_rows)
            jbatch = jbatch._replace(aux={"blk": jax.tree.map(jnp.asarray, blk)})
        tmodel = TGAT(layers, edge_op=EdgeSpMM(g.src, g.dst, v, v, device="cpu"), blk_rows=blk_rows)
        tbatch = tbuild_batch(g, "cpu", for_gat=True)
    jparams = jmodel.init_params(seed=8888)
    tmodel.load_state_dict(interop.params_from_numpy(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu"))
    return jmodel, jbatch, jparams, tmodel, tbatch


@pytest.mark.parametrize("path,narrow", [("hyb", False), ("hyb", True),
                                         ("edgewise", False), ("dst_blocked", False)],
                         ids=["hyb_f32", "hyb_bf16", "edgewise", "dst_blocked"])
def test_gat_logits_and_grads_match_jax(graph, path, narrow):
    jmodel, jbatch, jparams, tmodel, tbatch = _models(graph, path, narrow)
    jlogits = np.asarray(jmodel.forward(jparams, jbatch))
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(jparams)
    tlogits = tmodel(tbatch).detach().numpy()
    tloss = tmodel.loss(tbatch)
    names = list(tmodel.params())
    assert names == list(jparams) == ["w0", "a0", "w1", "a1"]
    tgrads = torch.autograd.grad(tloss, [tmodel.params()[k] for k in names])
    assert float(jloss) > 10  # the O(100) regime these tolerances are for
    tol = 5e-3 if narrow else 1e-5
    assert np.abs(tlogits - jlogits).max() <= tol * np.abs(jlogits).max()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=tol)
    for k, tg in zip(names, tgrads):
        ref = np.asarray(jgrads[k])
        if narrow:
            assert np.abs(tg.numpy() - ref).max() <= tol * np.abs(ref).max(), k
        else:
            np.testing.assert_allclose(tg.numpy(), ref, rtol=1e-5,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=k)


@pytest.mark.parametrize("path", ["hyb", "edgewise"])
def test_gat_bf16_compute_matches_jax(graph, path):
    """compute_dtype=bfloat16: operands rounded to bf16, z and za in f32,
    hidden layers back in bf16, f32 logits."""
    jmodel, jbatch, jparams, tmodel, tbatch = _models(graph, path, narrow=True)
    jlogits = np.asarray(jmodel.forward(jparams, jbatch, compute_dtype=jnp.bfloat16))
    tlogits = tmodel.forward(tbatch, compute_dtype=torch.bfloat16)
    assert tlogits.dtype == torch.float32
    err = np.abs(tlogits.detach().numpy() - jlogits).max()
    assert err <= 2e-2 * np.abs(jlogits).max()


@pytest.mark.parametrize("path", ["hyb", "edgewise"])
def test_gat_forward_matches_oracle(graph, path):
    _, _, jparams, tmodel, tbatch = _models(graph, path)
    v = graph.num_vertices
    adj = np.zeros((v, v))
    adj[graph.dst, graph.src] = 1.0
    ws = [np.asarray(jparams[f"w{l}"], np.float64) for l in range(2)]
    avs = [np.asarray(jparams[f"a{l}"], np.float64) for l in range(2)]
    oracle = gat_forward(adj, np.asarray(graph.features, np.float64), ws, avs)
    ref = oracle[-1][2]
    got = tmodel(tbatch).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())


def test_gat_init_and_predict_match_jax(graph):
    jmodel, jbatch, jparams, tmodel, tbatch = _models(graph, "hyb")
    tmodel2 = TGAT(LayerConfig(DIMS), spmm_op=tmodel.spmm_op)
    for k, p in tmodel2.init_params(seed=8888).items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jparams[k]))
    np.testing.assert_allclose(tmodel.predict(tbatch).detach().numpy(),
                               np.asarray(jmodel.predict(jparams, jbatch)),
                               rtol=1e-5, atol=1e-6)


def test_build_batch_for_gat_matches_jax(graph):
    jb = jbuild_batch(graph, for_gat=True)
    tb = tbuild_batch(graph, "cpu", for_gat=True)
    for name in tb._fields:
        if getattr(tb, name) is None:  # the overlap split: unused on one device
            assert getattr(jb, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    assert float(tb.edge_val.min()) == float(tb.edge_val.max()) == 1.0
