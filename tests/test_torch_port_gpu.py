"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 (hybrid-ELL static mode), K2 (mask mode: apply_unit, apply_dst), and the
edgewise K3 (CSR SpMM), K4 (SDDMM), K5 (sorted segment-sum).

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
