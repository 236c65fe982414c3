"""dorylus_tpu_torch GCN against dorylus_tpu's GCN on the same graph, plan
and weights (CPU).

The JAX model's params come from its own `init_params` and cross over as
numpy arrays through `interop.params_from_numpy`. Tolerances: f32
aggregation, loss and gradients rtol 1e-5; bf16 gather tables 2e-3 of the
largest gradient entry (bf16 products summed in another order).
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
from dorylus_tpu.ops.hyb_spmm import HybSpMM as JHyb
from dorylus_tpu_torch import interop
from dorylus_tpu_torch.engine.batch import build_batch as tbuild_batch
from dorylus_tpu_torch.models.gcn import GCN as TGCN
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM as THyb
from dorylus_tpu_torch.optim.adam import adam_init

torch.set_num_threads(1)

DIMS = [32, 16, 6]


@pytest.fixture(scope="module")
def graph():
    return synthetic_graph(300, 6, DIMS[0], DIMS[-1], seed=21)


def _models(g, narrow, compute_dtype="float32"):
    layers = LayerConfig(DIMS)
    v = g.num_vertices
    jop = JHyb(g.src, g.dst, v, v, static_val=g.edge_norm, dynamic=False,
               gather_dtype=jnp.bfloat16 if narrow else None, lam_slots=64)
    jmodel = JGCN(layers, spmm_op=jop)
    jbatch = jbuild_batch(g, edge_arrays=False)._replace(aux={"spmm": jop.arrays})
    top = THyb(g.src, g.dst, v, v, static_val=g.edge_norm,
               gather_dtype=torch.bfloat16 if narrow else None, lam_slots=64, device="cpu")
    tmodel = TGCN(layers, spmm_op=top)
    tbatch = tbuild_batch(g, "cpu", edge_arrays=False)
    jparams = jmodel.init_params(seed=8888)
    tmodel.load_state_dict(interop.params_from_numpy(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu"))
    return jmodel, jbatch, jparams, tmodel, tbatch


@pytest.mark.parametrize("narrow", [False, True], ids=["agg_f32", "agg_bf16"])
def test_gcn_loss_and_grads_match_jax(graph, narrow):
    jmodel, jbatch, jparams, tmodel, tbatch = _models(graph, narrow)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch))(jparams)
    tloss = tmodel.loss(tbatch)
    names = list(tmodel.params())
    tgrads = torch.autograd.grad(tloss, [tmodel.params()[k] for k in names])
    if not narrow:
        np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
        for k, tg in zip(names, tgrads):
            np.testing.assert_allclose(tg.numpy(), np.asarray(jgrads[k]),
                                       rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-3)
        for k, tg in zip(names, tgrads):
            ref = np.asarray(jgrads[k])
            assert np.abs(tg.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()


def test_gcn_bf16_compute_matches_jax(graph):
    """compute_dtype=bfloat16: operands rounded to bf16, products in f32
    (JAX's preferred_element_type), hidden activations back in bf16."""
    jmodel, jbatch, jparams, tmodel, tbatch = _models(graph, narrow=True)
    jlogits = np.asarray(jmodel.forward(jparams, jbatch,
                                        compute_dtype=jnp.bfloat16))
    tlogits = tmodel.forward(tbatch, compute_dtype=torch.bfloat16)
    assert tlogits.dtype == torch.float32
    err = np.abs(tlogits.detach().numpy() - jlogits).max()
    assert err <= 1e-2 * np.abs(jlogits).max()


def test_gcn_forward_predict_and_init_match_jax(graph):
    jmodel, jbatch, jparams, tmodel, tbatch = _models(graph, narrow=False)
    # the port's own init reproduces the JAX weights bit for bit
    tmodel2 = TGCN(LayerConfig(DIMS), spmm_op=tmodel.spmm_op)
    for k, p in tmodel2.init_params(seed=8888).items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jparams[k]))
    np.testing.assert_allclose(tmodel.predict(tbatch).detach().numpy(),
                               np.asarray(jmodel.predict(jparams, jbatch)),
                               rtol=1e-5, atol=1e-6)
    # aggregate-first ordering gives the same logits
    tmodel.optimize_order = False
    jmodel.optimize_order = False
    np.testing.assert_allclose(tmodel(tbatch).detach().numpy(),
                               np.asarray(jmodel.forward(jparams, jbatch)),
                               rtol=1e-5, atol=1e-5)


def test_build_batch_matches_jax(graph):
    jb = jbuild_batch(graph, edge_arrays=True)
    tb = tbuild_batch(graph, "cpu", edge_arrays=True)
    for name in tb._fields:
        if getattr(tb, name) is None:  # the overlap split: unused on one device
            assert getattr(jb, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    assert tb.onehot.dtype == torch.uint8
    stub = tbuild_batch(graph, "cpu", edge_arrays=False)
    assert stub.src.shape == stub.dst.shape == stub.edge_val.shape == (0,)


def test_interop_roundtrip():
    rng = np.random.default_rng(0)
    arrays = {"w0": rng.normal(size=(4, 3)).astype(np.float32),
              "w1": rng.normal(size=(3, 2)).astype(np.float32)}
    params = interop.params_from_numpy(arrays, "cpu")
    back = interop.params_to_numpy(params)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    state = adam_init(params)._replace(step=3)
    d = interop.adam_state_to_numpy(state)
    again = interop.adam_state_from_numpy(d, "cpu")
    assert again.step == 3 and set(again.m) == set(arrays)
