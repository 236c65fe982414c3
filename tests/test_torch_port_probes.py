"""The plain versions of the primitive probes P1-P4
(dorylus_tpu_torch/tools/probe_prims.py) against numpy, on the CPU, and the
probe functions' dispatch: a CPU tensor takes the plain version, indices
out of range raise, and the measuring entry point refuses to run without a
card. The kernels themselves are held against these plain versions on the
card (tests/test_torch_port_gpu.py, chip_smoke.py phase 3j).

What each computes is what the Mosaic probe of tools/probe_pallas_prims.py
computes: A the sum of dynamically indexed (8, 128) row-blocks, B their
counts as a read-modify-write, C the ring of the last 16 copied rows, D the
sum of lane gathers of an (8, 128) tile. Exact in f32 except the two sums
(1e-6 relative to max|ref|). The last tests run the Mosaic kernel bodies
themselves (`pl.pallas_call(..., interpret=True)` on the CPU, over the same
seeded inputs) and hold the plain versions against what those write: the
whole (8, 128) sum for A and D; for B and C the slice the Mosaic kernel
writes out, scratch row-block 0 and ring slot 0 (broadcast over 8 rows),
where the port writes the whole scratch and the whole ring.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dorylus_tpu_torch.tools import probe_prims as pp

torch.set_num_threads(1)


def _idx(rng, hi, *shape):
    return rng.integers(0, hi, size=shape).astype(np.int32)


@pytest.mark.parametrize("blocks,streams,n_ops", [(56, 3, 500), (4, 1, 5000), (7, 2, 1)])
def test_dyn_load_plain_is_the_sum_of_indexed_row_blocks(blocks, streams, n_ops):
    rng = np.random.default_rng(n_ops)
    tab = rng.normal(size=(blocks * 8, 128)).astype(np.float32)
    idx = _idx(rng, blocks, streams, n_ops)
    want = np.stack([tab.reshape(blocks, 8, 128)[row].astype(np.float64).sum(0)
                     for row in idx])
    got = pp.dyn_load(torch.tensor(tab), torch.tensor(idx))  # CPU: the plain version
    assert got.shape == (streams, 8, 128) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * n_ops ** 0.5 * np.abs(want).max()
    assert torch.equal(got, pp.dyn_load_plain(torch.tensor(tab), torch.tensor(idx)))


@pytest.mark.parametrize("blocks,streams,n_ops", [(56, 3, 500), (4, 2, 3000)])
def test_dyn_rmw_plain_counts_every_index(blocks, streams, n_ops):
    rng = np.random.default_rng(n_ops)
    idx = _idx(rng, blocks, streams, n_ops)
    got = pp.dyn_rmw(torch.tensor(idx), blocks).numpy()
    assert got.shape == (streams, blocks, 8, 128)
    for s in range(streams):
        scratch = np.zeros((blocks * 8, 128), np.float32)
        for r in idx[s]:  # the Mosaic loop: scratch[r * 8 : r * 8 + 8] += 1
            scratch[r * 8: r * 8 + 8] += 1.0
        np.testing.assert_array_equal(got[s].reshape(blocks * 8, 128), scratch)
    assert float(got.sum()) == streams * n_ops * 8 * 128


@pytest.mark.parametrize("streams,n_ops", [(3, 16), (2, 77), (1, 1000)])
def test_row_copy_plain_is_the_ring_after_the_last_op(streams, n_ops):
    rng = np.random.default_rng(n_ops)
    tab = rng.normal(size=(300, 128)).astype(np.float32)
    idx = _idx(rng, 300, streams, n_ops)
    got = pp.row_copy(torch.tensor(tab), torch.tensor(idx)).numpy()
    for s in range(streams):
        ring = np.zeros((16, 128), np.float32)
        for i, r in enumerate(idx[s]):  # the Mosaic loop: slot i % depth takes row r
            ring[i % 16] = tab[r]
        np.testing.assert_array_equal(got[s], ring)


@pytest.mark.parametrize("streams,n_ops", [(2, 1), (3, 64), (1, 150)])
def test_lane_gather_plain_sums_take_along_axis(streams, n_ops):
    rng = np.random.default_rng(n_ops)
    tab = rng.normal(size=(streams, 8, 128)).astype(np.float32)
    ids = _idx(rng, 128, 64, 128)
    want = np.zeros((streams, 8, 128), np.float64)
    for i in range(n_ops):
        rows = np.broadcast_to(ids[i % 64], (streams, 8, 128))
        want += np.take_along_axis(tab, rows, axis=2)
    got = pp.lane_gather(torch.tensor(tab), torch.tensor(ids), n_ops).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6 * max(1.0, np.abs(want).max())


def test_probe_functions_check_their_indices():
    tab = torch.zeros((16, 128))
    idx = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"outside \[0, 2\)"):
        pp.dyn_load(tab, idx + 2)
    with pytest.raises(ValueError, match="outside"):
        pp.dyn_rmw(idx - 1, 4)
    with pytest.raises(ValueError, match="outside"):
        pp.row_copy(tab, idx + 16)
    with pytest.raises(ValueError, match="at least 16"):
        pp.row_copy(tab, idx[:, :15])
    with pytest.raises(ValueError, match="outside"):
        pp.lane_gather(torch.zeros((1, 8, 128)), torch.full((64, 128), 128, dtype=torch.int32),
                       3)
    assert pp.LAUNCHES == {"P1": 0, "P2": 0, "P3": 0, "P4": 0}  # no kernel ran here


def test_the_measuring_entry_point_needs_a_card():
    """`run` and `main` measure the card: without one they fail and print
    no result, instead of timing the plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: run() measures it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.run("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.run("cpu")
    assert pp.main([]) == 1


def test_the_probe_source_holds_four_kernels_and_calls_no_library():
    src = (pp._CSRC).read_text()
    for kernel in ("dyn_load_kernel", "dyn_rmw_kernel", "row_copy_kernel",
                   "lane_gather_kernel"):
        assert f"{kernel}<<<" in src, kernel
    assert "cp.async.cg.shared.global" in src and "__shfl_sync" in src
    for banned in ("cublas", "cusparse", "cutlass", "thrust", "cub::", "#include <torch",
                   "#include <aten"):
        assert banned not in src.lower(), banned


# ---- against the Mosaic kernel bodies, interpreted on the CPU ----


@pytest.fixture(scope="module")
def mosaic():
    path = Path(__file__).resolve().parent.parent / "tools" / "probe_pallas_prims.py"
    spec = importlib.util.spec_from_file_location("probe_pallas_prims", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(body, *args, scratch=(), **kw):
    call = pl.pallas_call(functools.partial(body, **kw),
                          out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                          scratch_shapes=list(scratch), interpret=True)
    return np.asarray(call(*args))


@pytest.mark.parametrize("blocks,n_ops", [(7, 300), (56, 1000)])
def test_dyn_load_and_rmw_plain_match_the_mosaic_bodies(mosaic, blocks, n_ops):
    rng = np.random.default_rng(n_ops)
    idx = _idx(rng, blocks, 1, n_ops)
    tab = rng.normal(size=(blocks * 8, 128)).astype(np.float32)
    a = _interpret(mosaic.dyn_rows_kernel, idx, tab, n_ops=n_ops, rmw=False)
    got = pp.dyn_load(torch.tensor(tab), torch.tensor(idx))[0].numpy()
    # f32 sums in another order (the Mosaic loop adds one block at a time)
    assert float(np.abs(got - a).max()) <= 1e-5 * np.abs(a).max()
    b = _interpret(mosaic.dyn_rmw_kernel, idx, tab, n_ops=n_ops,
                   scratch=[pltpu.VMEM((blocks * 8, 128), jnp.float32)])
    np.testing.assert_array_equal(pp.dyn_rmw(torch.tensor(idx), blocks)[0, 0].numpy(), b)


@pytest.mark.parametrize("n_ops", [16, 77, 400])
def test_row_copy_plain_matches_the_mosaic_body(mosaic, n_ops):
    rng = np.random.default_rng(n_ops)
    idx = _idx(rng, 300, 1, n_ops)
    tab = rng.normal(size=(300, 128)).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(mosaic.dma_rows_kernel, n_ops=n_ops, depth=16),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((16, 128), jnp.float32), pltpu.SemaphoreType.DMA((16,))],
        interpret=True)
    c = np.asarray(call(idx, tab))  # ring slot 0, broadcast over the 8 rows
    ring = pp.row_copy(torch.tensor(tab), torch.tensor(idx))[0].numpy()
    np.testing.assert_array_equal(np.broadcast_to(ring[0], (8, 128)), c)


@pytest.mark.parametrize("n_ops", [1, 64, 150])
def test_lane_gather_plain_matches_the_mosaic_body(mosaic, n_ops):
    rng = np.random.default_rng(n_ops)
    ids = _idx(rng, 128, 64, 128)
    tab = rng.normal(size=(8, 128)).astype(np.float32)
    d = _interpret(mosaic.lane_gather_kernel, ids, tab, n_ops=n_ops)
    got = pp.lane_gather(torch.tensor(tab)[None], torch.tensor(ids), n_ops)[0].numpy()
    assert float(np.abs(got - d).max()) <= 1e-5 * max(1.0, np.abs(d).max())
