"""dorylus_tpu_torch ops against dorylus_tpu on the same inputs (CPU).

Inputs come from numpy seeds and go to both packages. JAX runs on the CPU
as the rest of the suite runs it (tests/conftest.py); the port's CPU path
is the plain torch version of each kernel.

Tolerances:
  * plan builder: array for array, exact (it is a copy);
  * f32 aggregation and dh: rtol 1e-5, atol 1e-5 (only the summation
    order differs);
  * bf16 aggregation: max abs error <= 2e-3 * max|ref| (the same bf16
    products summed in another order; common/config.py documents ~1e-3);
  * activations, loss, Adam: rtol 1e-6 / atol 1e-6 (f32 elementwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.graph.reorder import apply_order, degree_order
from dorylus_tpu.ops import activations as jact
from dorylus_tpu.ops import hyb_spmm as jhyb
from dorylus_tpu.optim import adam as jadam
from dorylus_tpu_torch.ops import activations as tact
from dorylus_tpu_torch.ops import hyb_plan as thyb_plan
from dorylus_tpu_torch.ops import hyb_spmm as thyb
from dorylus_tpu_torch.optim import adam as tadam

torch.set_num_threads(1)


def _random_edges(v_in, v_out, e, seed, powerlaw=False):
    rng = np.random.default_rng(seed)
    if powerlaw:
        deg = np.minimum(rng.zipf(1.5, v_out), 200)
        dst = np.sort(np.repeat(np.arange(v_out, dtype=np.int32), deg)[:e])
    else:
        dst = np.sort(rng.integers(0, v_out, size=e).astype(np.int32))
    src = rng.integers(0, v_in, size=len(dst)).astype(np.int32)
    val = rng.normal(0, 1, size=len(dst)).astype(np.float32)
    return src, dst, val


def _sorted_graph_edges():
    g0 = synthetic_graph(300, 6, 8, 4, seed=51)
    g = apply_order(g0, degree_order(g0, ascending=True))
    return g.src, g.dst, g.edge_norm, g.num_vertices


# case -> (src, dst, val, num_in, num_out, builder kwargs)
def _case(name):
    if name == "uniform":
        return (*_random_edges(57, 41, 400, seed=3), 57, 41, {"lam_slots": 16})
    if name == "hubs":
        return (*_random_edges(60, 40, 500, seed=5, powerlaw=True), 60, 40,
                {"max_width": 8, "lam_slots": 4})
    if name == "sorted":
        src, dst, val, v = _sorted_graph_edges()
        return src, dst, val, v, v, {"lam_slots": 64}
    if name == "widths":
        src, dst, val = _random_edges(50, 30, 200, seed=7)
        return src, dst, val, 50, 30, {"widths": [8, 16, 24, 32, 48]}
    raise KeyError(name)


def _assert_same_tree(a, b, path="plan"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (int, np.integer)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("case", ["uniform", "hubs", "sorted", "widths"])
def test_build_hyb_plan_copy_matches_original(case):
    src, dst, val, num_in, num_out, kw = _case(case)
    widths = kw.get("widths")
    empty_kept = widths is not None
    for sv in (None, val):
        ref = jhyb.build_hyb_plan(src, dst, None, num_out, static_val=sv, **kw)
        got = thyb_plan.build_hyb_plan(src, dst, None, num_out, static_val=sv, **kw)
        _assert_same_tree(ref, got)
    # the transposed (backward) plan with its edge-id permutation
    order = np.argsort(src, kind="stable")
    ref = jhyb.build_hyb_plan(dst[order], src[order], order, num_in,
                              static_val=val, **kw)
    got = thyb_plan.build_hyb_plan(dst[order], src[order], order, num_in,
                                   static_val=val, **kw)
    _assert_same_tree(ref, got)
    if case == "hubs":
        assert got["top"] is not None
    if case == "sorted":
        assert "_n_iso" in got and "inv" not in got
    if case in ("uniform", "hubs"):
        assert "inv" in got
    if empty_kept:
        assert len(got["buckets"]) == len(widths)
        assert any(len(b["v"]) == 0 for b in got["buckets"])


def test_choose_widths_copy_matches_original():
    deg = np.sort(np.r_[np.full(100, 5), np.full(3, 60), np.arange(1, 90)])
    for lam in (0, 64, 10**9):
        assert thyb_plan._choose_widths(deg, lam) == jhyb._choose_widths(deg, lam)


def _ops(case, narrow):
    src, dst, val, num_in, num_out, kw = _case(case)
    kw = {k: v for k, v in kw.items() if k != "widths"}
    jop = jhyb.HybSpMM(src, dst, num_in, num_out, static_val=val, dynamic=False,
                       gather_dtype=jnp.bfloat16 if narrow else None, **kw)
    top = thyb.HybSpMM(src, dst, num_in, num_out, static_val=val,
                       gather_dtype=torch.bfloat16 if narrow else None, **kw)
    return jop, top, num_in, num_out


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["uniform", "hubs", "sorted"])
def test_hyb_static_forward_and_dh_match_jax(case, narrow):
    jop, top, num_in, num_out = _ops(case, narrow)
    rng = np.random.default_rng(11)
    f = 9
    h = rng.normal(0, 1, (num_in, f)).astype(np.float32)
    gout = rng.normal(0, 1, (num_out, f)).astype(np.float32)

    def jloss(hh):
        return (jop.apply_static(jop.arrays, hh) * gout).sum()

    ref_out = np.asarray(jop.apply_static(jop.arrays, jnp.asarray(h)))
    ref_dh = np.asarray(jax.grad(jloss)(jnp.asarray(h)))

    ht = torch.tensor(h, requires_grad=True)
    out = top.apply_static(ht)
    out.backward(torch.tensor(gout))
    got_out, got_dh = out.detach().numpy(), ht.grad.numpy()
    assert out.dtype == torch.float32 and ht.grad.dtype == torch.float32
    if narrow:
        for got, ref in ((got_out, ref_out), (got_dh, ref_dh)):
            assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got_out, ref_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_dh, ref_dh, rtol=1e-5, atol=1e-5)


def test_hyb_static_isolated_and_empty():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 1, 3], np.int32)
    val = np.array([0.5, -1.0, 2.0], np.float32)
    op = thyb.HybSpMM(src, dst, 5, 5, static_val=val, lam_slots=4)
    out = op.apply_static(torch.eye(5)).numpy()
    want = np.zeros((5, 5), np.float32)
    np.add.at(want, dst, val[:, None] * np.eye(5, dtype=np.float32)[src])
    np.testing.assert_allclose(out, want, atol=1e-7)
    empty = thyb.HybSpMM(np.zeros(0, np.int32), np.zeros(0, np.int32), 4, 4,
                         static_val=np.zeros(0, np.float32))
    assert torch.count_nonzero(empty.apply_static(torch.eye(4))) == 0


def test_hyb_plan_vals_precast_like_jax():
    """Narrow mode ships bf16 static values: the port's upload rounding
    (torch f32 -> bf16) equals the JAX op's pre-cast array."""
    jop, top, _, _ = _ops("hubs", narrow=True)
    for jp, tp in ((jop.arrays["fwd"], top.fwd), (jop.arrays["bwd"], top.bwd)):
        parts = list(zip(jp["buckets"], tp["buckets"])) + [(jp["top"], tp["top"])]
        for jb, tb in parts:
            assert tb["vals"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                np.asarray(jb["vals"].astype(jnp.float32)),
                tb["vals"].float().numpy())


def test_hyb_static_kernel_path_raises_off_cuda():
    """The kernel launcher never computes on a non-CUDA tensor, and the
    dispatcher raises for devices that are neither CPU nor CUDA."""
    _, top, num_in, _ = _ops("hubs", narrow=False)
    tb = torch.zeros((num_in, 4))
    out = torch.zeros((top.num_out, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        thyb._launch_part(tb, top.fwd["buckets"][0], out)
    with pytest.raises(ValueError, match="unsupported device"):
        thyb.hyb_static_pass(torch.zeros((num_in, 4), device="meta"), top.fwd,
                             top.num_out)
    assert thyb.KERNEL_LAUNCHES == 0


def test_hybspmm_static_only_and_validates_edges():
    src, dst, val = _random_edges(10, 10, 30, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thyb.HybSpMM(src, dst, 10, 10)
    with pytest.raises(ValueError, match="dst-sorted"):
        thyb.HybSpMM(src, dst[::-1].copy(), 10, 10, static_val=val)
    with pytest.raises(ValueError, match="out of range"):
        thyb.HybSpMM(src, dst, 5, 10, static_val=val)


def _logits_and_labels(seed=0, v=37, c=6):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (v, c)).astype(np.float32)
    logits[3] = 1.5  # an all-tied row: argmax must take the first maximum
    labels = rng.integers(0, c, v)
    labels[5] = -1  # unlabelled row
    onehot = np.zeros((v, c), np.uint8)
    onehot[np.arange(v)[labels >= 0], labels[labels >= 0]] = 1
    mask = (rng.random(v) < 0.6).astype(np.float32)
    return logits, onehot, mask


def test_activations_and_loss_match_jax():
    logits, onehot, mask = _logits_and_labels()
    denom = np.float32(37 * 0.66)
    lt = torch.tensor(logits, requires_grad=True)

    np.testing.assert_allclose(tact.row_softmax(torch.tensor(logits)).numpy(),
                               np.asarray(jact.row_softmax(logits)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tact.leaky_relu(torch.tensor(logits)).numpy(),
                               np.asarray(jact.leaky_relu(logits)), rtol=1e-7)

    def jloss(z):
        return jact.masked_softmax_xent(z, onehot, mask, denom)

    loss = tact.masked_softmax_xent(lt, torch.tensor(onehot), torch.tensor(mask),
                                    torch.tensor(denom))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(logits)), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jax.grad(jloss)(logits)),
                               rtol=1e-5, atol=1e-7)

    # row_softmax's gradient (max detached) through a data-dependent cotangent
    cot = np.random.default_rng(1).normal(size=logits.shape).astype(np.float32)
    lt2 = torch.tensor(logits, requires_grad=True)
    (tact.row_softmax(lt2) * torch.tensor(cot)).sum().backward()
    jg = jax.grad(lambda z: (jact.row_softmax(z) * cot).sum())(logits)
    np.testing.assert_allclose(lt2.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)

    probs = np.asarray(jact.row_softmax(logits))
    ref = jact.accuracy_and_loss(probs, onehot, mask)
    got = tact.accuracy_and_loss(torch.tensor(probs), torch.tensor(onehot),
                                 torch.tensor(mask))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)


def test_adam_sgd_decay_match_jax():
    rng = np.random.default_rng(4)
    params = {"w0": rng.normal(size=(7, 5)).astype(np.float32),
              "w1": rng.normal(size=(5, 3)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadam.adam_init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = tadam.adam_init(tp)
    for i, g in enumerate(grads):
        lr = tadam.decay_lr(0.01, i, every=2, factor=0.7)
        assert lr == jadam.decay_lr(0.01, i, every=2, factor=0.7)
        jp, js = jadam.adam_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                   js, lr=jnp.float32(lr), weight_decay=1e-3)
        tp, ts = tadam.adam_update(tp, {k: torch.tensor(v) for k, v in g.items()},
                                   ts, lr=lr, weight_decay=1e-3)
        assert ts.step == int(js.step) == i + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                       rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                       rtol=1e-6, atol=1e-9)
    jsgd = jadam.sgd_update(jp, {k: jnp.asarray(v) for k, v in grads[0].items()}, 0.1)
    tsgd = tadam.sgd_update(tp, {k: torch.tensor(v) for k, v in grads[0].items()}, 0.1)
    for k in params:
        np.testing.assert_allclose(tsgd[k].numpy(), np.asarray(jsgd[k]), rtol=1e-6)
