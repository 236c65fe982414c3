"""The port against the JAX package where its tests held it at one setting
only (CPU): models of depth other than 2, engine trajectories with
`compute_dtype="bfloat16"` (with and without `reuse="pairs"`, whose VJP
returns dh in h's dtype), and `Engine.output()`.

Tolerances: logits and gradients in f32, rtol 1e-5 with atol 1e-6 of the
largest entry (only summation orders differ); 5-epoch trajectories in bf16
compute, GCN losses atol 2e-3 and GAT losses rtol 5e-3 (bf16 operands and
hidden activations round at 2^-9, and the two packages sum their products in
other orders), val accuracy equal up to one vertex an epoch.
"""

import json

import jax
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.batch import build_batch as jbuild_batch
from dorylus_tpu.engine.engine import Engine as JEngine
from dorylus_tpu.graph.graph import clustered_synthetic_graph, synthetic_graph
from dorylus_tpu.models.gat import GAT as JGAT
from dorylus_tpu.models.gcn import GCN as JGCN
from dorylus_tpu.ops.hyb_spmm import HybSpMM as JHyb
from dorylus_tpu_torch import interop
from dorylus_tpu_torch.engine.batch import build_batch as tbuild_batch
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.models.gat import GAT as TGAT
from dorylus_tpu_torch.models.gcn import GCN as TGCN
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM as THyb

torch.set_num_threads(1)


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max() + 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("dims", [[24, 16, 8, 5], [10, 4]], ids=["3-layer", "1-layer"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_depth_logits_and_gradients_match_jax(model, dims):
    g = synthetic_graph(200, 5, dims[0], dims[-1], seed=51)
    v, layers, gat = g.num_vertices, LayerConfig(dims), model == "gat"
    static = None if gat else g.edge_norm
    jop = JHyb(g.src, g.dst, v, v, static_val=static, dynamic=False, lam_slots=64)
    top = THyb(g.src, g.dst, v, v, static_val=static, lam_slots=64, device="cpu")
    jmodel = (JGAT if gat else JGCN)(layers, spmm_op=jop)
    tmodel = (TGAT if gat else TGCN)(layers, spmm_op=top)
    jbatch = jbuild_batch(g, for_gat=gat, edge_arrays=False)._replace(
        aux={"spmm": jop.arrays})
    tbatch = tbuild_batch(g, "cpu", for_gat=gat, edge_arrays=False)
    jparams = jmodel.init_params(seed=8888)
    tmodel.load_state_dict(interop.params_from_numpy(
        {k: np.asarray(a) for k, a in jparams.items()}, "cpu"))
    _close(tmodel(tbatch).detach().numpy(), np.asarray(jmodel.forward(jparams, jbatch)))
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jbatch))(jparams)
    tloss = tmodel.loss(tbatch)
    names = list(tmodel.params())
    assert sorted(names) == sorted(jgrads)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for k, tg in zip(names, torch.autograd.grad(tloss, [tmodel.params()[k] for k in names])):
        _close(tg.numpy(), np.asarray(jgrads[k]))


@pytest.mark.parametrize("reuse", ["off", "pairs"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_bf16_compute_trajectory_matches_jax(model, reuse):
    """compute_dtype=bfloat16 on hyb (bf16 gather tables), 5 epochs; with
    pair reuse on a clustered graph, so the rewrite has pairs to mine."""
    g = (clustered_synthetic_graph(400, 8, 24, 5, seed=11, window=64, cut=0.1)
         if reuse == "pairs" else synthetic_graph(400, 6, 24, 5, seed=31))
    cfg = TrainConfig(epochs=5, eval_every=1, kernel="hyb", reuse=reuse, model=model,
                      compute_dtype="bfloat16", agg_dtype="bfloat16",
                      learning_rate=0.01 if model == "gcn" else 0.005,
                      reuse_max_pairs=0, compile_cache="off")
    layers = LayerConfig([24, 12, 5])
    jrep = JEngine(g, layers, cfg).run()
    teng = TEngine(g, layers, cfg, device="cpu")
    trep = teng.run()
    if reuse == "pairs":
        assert teng.model.spmm_op.num_pairs > 0
    jl, tl = [e.loss for e in jrep.epochs], [e.loss for e in trep.epochs]
    assert len(jl) == len(tl) == 5 and np.isfinite(tl).all()
    if model == "gcn":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-3)
    else:
        np.testing.assert_allclose(tl, jl, rtol=5e-3)
    n_val = int(g.masks()[1].sum())
    for je, te in zip(jrep.epochs, trep.epochs):
        assert abs(je.accuracy - te.accuracy) <= 1.0 / n_val + 1e-9


def test_engine_output_writes_and_returns_the_report(tmp_path):
    """`Engine.output()` as the JAX engine has it: the summary, and with a
    path the report's JSON written there."""
    g = synthetic_graph(200, 5, 12, 3, seed=7)
    cfg = TrainConfig(epochs=2, eval_every=1, kernel="hyb", reuse="off", compile_cache="off")
    layers = LayerConfig([12, 6, 3])
    teng, jeng = TEngine(g, layers, cfg, device="cpu"), JEngine(g, layers, cfg)
    teng.run()
    jeng.run()
    tpath, jpath = tmp_path / "port.json", tmp_path / "jax.json"
    assert teng.output(str(tpath)) == teng.report.summary() == teng.output()
    jeng.output(str(jpath))
    got, want = json.loads(tpath.read_text()), json.loads(jpath.read_text())
    assert set(got) == set(want) and len(got["epochs"]) == len(want["epochs"]) == 2
    assert got["final_accuracy"] == teng.report.final_accuracy
    assert teng.output().splitlines()[0] == jeng.output().splitlines()[0]
