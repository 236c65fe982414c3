"""The hybrid-ELL CUDA kernel against its plain PyTorch version, on a card.

Marked `gpu`: each test skips where torch sees no CUDA device (the kernel
has no CPU or interpret mode). On a machine with a card and without jax:

    DORYLUS_TEST_TPU=1 python -m pytest -o addopts="" -p no:cacheprovider \
        tests/test_torch_port_gpu.py -q

(DORYLUS_TEST_TPU=1 keeps tests/conftest.py from importing jax.)

Tolerances, max abs error over max |plain|: f32 1e-4, bf16 1e-2.
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
