"""dorylus_tpu_torch's degree-padded SpMM (`kernel="degree"`) against
dorylus_tpu's on the same inputs (CPU).

Inputs come from numpy seeds and go to both packages; the port's CPU path
is the plain torch version of the degree pass. Tolerances:
  * plan builder: array for array, exact (it is a copy, built with
    out_block_rows=0 on both sides);
  * f32 output, dh, dval and d_dst: rtol 1e-5, atol 1e-5 (only the
    summation order differs);
  * bf16 gather tables: max abs error <= 2e-3 * max|ref| (the same bf16
    products summed in another order);
  * 5-epoch Engine losses: GCN atol 1e-4 (f32) / 1e-3 (bf16), GAT rtol
    1e-5 (f32) / 5e-3 (bf16), as PERF.md section 2 states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.ops import degree_spmm as jdeg
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.ops import degree_plan as tplan
from dorylus_tpu_torch.ops import degree_spmm as tdeg
from dorylus_tpu_torch.ops import hyb_spmm as thyb

torch.set_num_threads(1)


def _powerlaw(v_in, v_out, e, seed):
    """dst-sorted edges with Zipf in-degrees (vertices of up to 200 edges,
    many block rows each) and isolated vertices (every fifth one)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.5, v_out), 200)
    deg[::5] = 0
    dst = np.repeat(rng.permutation(v_out).astype(np.int32), deg)
    dst = np.sort(dst[: e])
    src = rng.integers(0, v_in, size=len(dst)).astype(np.int32)
    val = rng.normal(0, 1, size=len(dst)).astype(np.float32)
    return src, dst, val


def _case(name):
    if name == "powerlaw":
        return (*_powerlaw(60, 40, 500, seed=3), 60, 40)
    if name == "isolated":
        return (np.array([0, 1, 2], np.int32), np.array([1, 1, 3], np.int32),
                np.array([0.5, -1.0, 2.0], np.float32), 5, 5)
    if name == "empty":
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), 4, 4)
    raise KeyError(name)


def _assert_same_plan(ref, got):
    assert set(ref) == set(got), set(ref) ^ set(got)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("block", [4, 8, 16])
@pytest.mark.parametrize("case", ["powerlaw", "isolated", "empty"])
def test_build_degree_plan_copy_matches_original(case, block):
    src, dst, _, num_in, num_out = _case(case)
    ref = jdeg.build_degree_plan(src, dst, None, num_out, block, out_block_rows=0)
    fwd = tplan.build_degree_plan(src, dst, None, num_out, block)
    _assert_same_plan(ref, fwd)
    # the transposed (backward) plan with its edge-id permutation
    order = np.argsort(src, kind="stable")
    ref = jdeg.build_degree_plan(dst[order], src[order], order, num_in, block,
                                 out_block_rows=0)
    got = tplan.build_degree_plan(dst[order], src[order], order, num_in, block)
    _assert_same_plan(ref, got)
    if case == "powerlaw":
        assert np.bincount(fwd["block_row"]).max() > 1  # multi-row vertices
        assert len(np.unique(fwd["block_row"])) < num_out  # isolated vertices


def _close(got, ref, narrow):
    got, ref = np.asarray(got), np.asarray(ref)
    if narrow:
        assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("entry", ["apply", "static", "unit", "dst"])
def test_degree_entries_match_jax(entry, narrow):
    """Forward, dh and dval / d_dst of the four custom-VJP entries against
    JAX's DegreeSpMM, on a power-law graph with multi-row vertices and
    isolated ones."""
    src, dst, val, num_in, num_out = _case("powerlaw")
    static = val if entry == "static" else None
    jop = jdeg.DegreeSpMM(src, dst, num_in, num_out, static_val=static,
                          gather_dtype=jnp.bfloat16 if narrow else None)
    top = tdeg.DegreeSpMM(src, dst, num_in, num_out, static_val=static,
                          gather_dtype=torch.bfloat16 if narrow else None, device="cpu")
    rng = np.random.default_rng(17)
    f = 9
    h = rng.normal(0, 1, (num_in, f)).astype(np.float32)
    gout = rng.normal(0, 1, (num_out, f)).astype(np.float32)
    dst_val = rng.normal(0, 1, num_out).astype(np.float32)
    second = {"apply": val, "dst": dst_val}.get(entry)

    def jfn(*args):
        if entry == "apply":
            return jop.apply(jop.arrays, *args)
        if entry == "dst":
            return jop.apply_dst(jop.arrays, *args)
        if entry == "unit":
            return jop.apply_unit(jop.arrays, *args)
        return jop.apply_static(jop.arrays, *args)

    jargs = [jnp.asarray(h)] + ([] if second is None else [jnp.asarray(second)])
    ref_out, vjp = jax.vjp(jfn, *jargs)
    ref_grads = vjp(jnp.asarray(gout))

    targs = [torch.tensor(h, requires_grad=True)]
    if second is not None:
        targs.append(torch.tensor(second, requires_grad=True))
    tfn = {"apply": top.apply, "dst": top.apply_dst, "unit": top.apply_unit,
           "static": top.apply_static}[entry]
    out = tfn(*targs)
    out.backward(torch.tensor(gout))
    assert out.dtype == torch.float32
    _close(out.detach(), ref_out, narrow)
    for t, r in zip(targs, ref_grads):
        assert t.grad.dtype == torch.float32
        _close(t.grad, r, narrow)
    isolated = np.bincount(dst, minlength=num_out) == 0
    assert isolated.any() and not out.detach()[isolated].any()


def test_degree_isolated_rows_and_zero_edges():
    """Vertices without in-edges have no block row and stay zero in every
    entry; a zero-edge op returns zeros and empty gradients (the JAX
    cases tests/test_degree_spmm.py:98-115)."""
    src, dst, val, v, _ = _case("isolated")
    h = torch.eye(v)
    op = tdeg.DegreeSpMM(src, dst, v, v, block=4, static_val=val, device="cpu")
    want = np.zeros((v, v), np.float32)
    np.add.at(want, dst, val[:, None] * np.eye(v, dtype=np.float32)[src])
    np.testing.assert_allclose(op.apply_static(h).numpy(), want, atol=1e-7)
    np.testing.assert_allclose(op.apply(h, torch.tensor(val)).numpy(), want, atol=1e-7)
    unit = op.apply_unit(h).numpy()
    assert not unit[[0, 2, 4]].any() and unit[1, 0] == unit[1, 1] == 1
    empty = tdeg.DegreeSpMM(np.zeros(0, np.int32), np.zeros(0, np.int32), 4, 4,
                            static_val=np.zeros(0, np.float32), device="cpu")
    hk = torch.eye(4, requires_grad=True)
    vk = torch.zeros(0, requires_grad=True)
    out = empty.apply(hk, vk)
    out.sum().backward()
    assert not out.detach().any() and not empty.apply_static(torch.eye(4)).any()
    assert hk.grad.shape == (4, 4) and not hk.grad.any() and vk.grad.shape == (0,)
    assert empty.fwd["part"]["v"].shape == (0,)  # no output row to launch for


def test_degree_plan_as_hub_part():
    """On the card a degree plan is one hub part: each vertex with block
    rows owns a contiguous run of them through row_ptr."""
    src, dst, _, num_in, num_out = _case("powerlaw")
    op = tdeg.DegreeSpMM(src, dst, num_in, num_out, device="cpu")
    part, br = op.fwd["part"], op.fwd["block_row"].numpy()
    verts, ptr = part["v"].numpy(), part["row_ptr"].numpy()
    assert ptr[0] == 0 and ptr[-1] == len(br) and (np.diff(ptr) > 0).all()
    for i, vtx in enumerate(verts):
        assert (br[ptr[i]: ptr[i + 1]] == vtx).all()
    assert part["rows"].shape == part["s2e"].shape == (len(br), 16)
    assert int(part["cnt"].sum()) == len(src)


def test_degree_kernel_path_raises_off_cuda():
    """The degree pass launches on CUDA tensors only: another device
    raises, and the launchers count nothing."""
    src, dst, val, num_in, num_out = _case("powerlaw")
    op = tdeg.DegreeSpMM(src, dst, num_in, num_out, static_val=val, device="cpu")
    meta = torch.zeros((num_in, 4), device="meta")
    for mode in ("static", "mask", "dynamic"):
        with pytest.raises(ValueError, match="unsupported device"):
            tdeg.degree_pass(meta, op.fwd, num_out, None, mode, torch.tensor(val))
    with pytest.raises(ValueError, match="CUDA tensor"):
        thyb._launch_pass(torch.zeros((num_in, 4)), op.fwd, torch.zeros((num_out, 4)))
    assert tdeg.DEGREE_LAUNCHES == thyb.KERNEL_LAUNCHES == thyb.MASK_LAUNCHES == 0
    assert thyb.DYN_LAUNCHES == 0


@pytest.mark.parametrize("model,agg_dtype", [
    ("gcn", "float32"), ("gcn", "bfloat16"), ("gat", "float32"), ("gat", "bfloat16"),
], ids=["gcn-f32", "gcn-bf16", "gat-f32", "gat-bf16"])
def test_engine_degree_matches_jax(model, agg_dtype):
    """5-epoch trajectories on kernel="degree": GCN on static plans (K1 on
    the card), GAT on plans without values (K2)."""
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = synthetic_graph(400, 6, 24, 5, seed=41)
    layers = LayerConfig([24, 12, 5])
    cfg = TrainConfig(epochs=5, eval_every=1, kernel="degree", reuse="off",
                      model=model, agg_dtype=agg_dtype, compile_cache="off",
                      learning_rate=0.005 if model == "gat" else 0.01)
    jrep = JEngine(g, layers, cfg).run()
    teng = TEngine(g, layers, cfg, device="cpu")
    assert isinstance(teng.model.spmm_op, tdeg.DegreeSpMM)
    assert teng.batch.src.shape[0] == 0  # the plans carry what aggregation reads
    trep = teng.run()
    jl = [e.loss for e in jrep.epochs]
    tl = [e.loss for e in trep.epochs]
    bf16 = agg_dtype == "bfloat16"
    if model == "gcn":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3 if bf16 else 1e-4)
    else:
        np.testing.assert_allclose(tl, jl, rtol=5e-3 if bf16 else 1e-5)
    n_val = int(g.masks()[1].sum())
    for je, te in zip(jrep.epochs, trep.epochs):
        assert abs(je.accuracy - te.accuracy) <= 1.0 / n_val + 1e-9
    assert trep.notes["kernel"] == jrep.notes["kernel"] == "degree"
