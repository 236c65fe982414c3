"""The port's halo exchange (dorylus_tpu_torch/parallel/halo.py) on 4 gloo
ranks against the JAX package's `halo_recv` with its planned backward under
shard_map on 4 virtual CPU devices, the same shards, rows and cotangents.

Tolerances: the forward moves rows and adds nothing, so it is exact, in
f32 and bf16. dh in f32 within 1e-6 (both sum the same f32 terms per local
row, in the order of the same stable sort; XLA may still pair them
differently); in bf16 within one bf16 rounding of the f32 sum (2^-8
relative). The two wires agree exactly on the live ghost slots, and both
leave the slots past a pair's count at zero (JAX's padded wire carries row
0 there; no edge reads those slots, so the cotangent is zero on them).

Every multi-process run has its own timeout and a file:// rendezvous in a
fresh temp directory (parallel/multihost.py `spawn_local`).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_ranks as ranks
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.parallel.halo import build_ragged_plan, build_recv_plan, halo_recv
from dorylus_tpu.parallel.mesh import GRAPH_AXIS, make_mesh
from dorylus_tpu_torch.graph import partition as tpart
from dorylus_tpu_torch.parallel import halo as thalo
from dorylus_tpu_torch.parallel.multihost import spawn_local

torch.set_num_threads(1)

N, F = 4, 5
METHOD = "hash"  # uneven per-pair counts


@pytest.fixture(scope="module")
def setup():
    g = synthetic_graph(400, 6, 16, 5, seed=13)
    sg = partition_graph(g, N, method=METHOD)
    rg = build_ragged_plan(sg)
    rng = np.random.default_rng(7)
    h = rng.normal(size=(N, sg.vp, F)).astype(np.float32)
    gout = rng.normal(size=(N, N * sg.max_h, F)).astype(np.float32)
    # live[p, q*max_h + j]: ghost slot j of owner q is referenced on shard p
    live = np.zeros((N, N * sg.max_h), bool)
    for p in range(N):
        for q in range(N):
            live[p, q * sg.max_h: q * sg.max_h + int(rg["recv_sz"][p, q])] = True
    return g, sg, rg, h, gout, live


def jax_halo(sg, h, gout, dtype):
    """(ghosts, dh) per shard from the JAX package: halo_recv with the
    host-built plan, its custom VJP applied to gout."""
    send = np.stack([s.send_idx for s in sg.shards])
    plans = [build_recv_plan(s.send_idx) for s in sg.shards]
    order, rows = (np.stack([p[i] for p in plans]) for i in (0, 1))
    spec = P(GRAPH_AXIS)

    @partial(shard_map, mesh=make_mesh(N), in_specs=(spec,) * 5, out_specs=(spec, spec),
             check_vma=False)
    def run(h, s, o, r, g):
        out, vjp = jax.vjp(lambda x: halo_recv(x, s[0], plan=(o[0], r[0])), h[0])
        return out[None], vjp(g[0])[0][None]

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, dh = jax.jit(run)(jnp.asarray(h, jdt), jnp.asarray(send), jnp.asarray(order),
                           jnp.asarray(rows), jnp.asarray(gout, jdt))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dh.astype(jnp.float32))


def port_halo(g, wire, h, gout, dtype):
    return spawn_local(N, ranks.halo_rank, (g, METHOD, wire, h, gout, dtype),
                       backend="gloo", device="cpu", timeout_s=120)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_wire_matches_jax(setup, dtype):
    """The padded wire is JAX's own on every live ghost slot; the pad
    slots ship zero rows (JAX ships row 0 there) and, with the cotangent
    zero on them as no edge reads them, dh is JAX's."""
    g, sg, rg, h, gout, live = setup
    gl = gout * live[:, :, None]
    want_out, want_dh = jax_halo(sg, h, gl, dtype)
    res = port_halo(g, "padded", h, gl, dtype)
    for p, r in enumerate(res):
        np.testing.assert_array_equal(r["ghosts"][live[p]], want_out[p][live[p]])
        assert not r["ghosts"][~live[p]].any()
        np.testing.assert_array_equal(r["table"][: sg.vp],
                                      np.asarray(torch.tensor(h[p]).to(getattr(torch, dtype))
                                                 .float()))
        np.testing.assert_array_equal(r["table"][sg.vp:], r["ghosts"])
        if dtype == "float32":
            np.testing.assert_allclose(r["dh"], want_dh[p], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(r["dh"], want_dh[p], rtol=2 ** -7, atol=1e-6)
        assert r["wire_rows"] == (N - 1) * sg.max_h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_wire_ignores_the_pad_slots_cotangent(setup, dtype):
    """A cotangent on the pad slots changes nothing: they are not in the
    backward's plan (JAX adds them into row 0, where real runs add zero)."""
    g, sg, rg, h, gout, live = setup
    full = port_halo(g, "padded", h, gout, dtype)
    masked = port_halo(g, "padded", h, gout * live[:, :, None], dtype)
    for r, rm in zip(full, masked):
        np.testing.assert_array_equal(r["dh"], rm["dh"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_wire_matches_jax_and_the_padded_wire(setup, dtype):
    """The exact wire ships each pair's exact count: live slots equal
    JAX's (and the padded wire's) exactly, the rest stay zero; with the
    cotangent zero past each pair's count (no edge reads those slots) dh
    equals JAX's."""
    g, sg, rg, h, gout, live = setup
    gl = gout * live[:, :, None]
    want_out, want_dh = jax_halo(sg, h, gl, dtype)
    exact = port_halo(g, "ragged", h, gl, dtype)
    padded = port_halo(g, "padded", h, gl, dtype)
    for p, (r, rp) in enumerate(zip(exact, padded)):
        np.testing.assert_array_equal(r["ghosts"][live[p]], want_out[p][live[p]])
        np.testing.assert_array_equal(r["ghosts"][live[p]], rp["ghosts"][live[p]])
        assert not r["ghosts"][~live[p]].any()
        np.testing.assert_array_equal(r["send_cnt"], rg["send_sz"][p])
        np.testing.assert_array_equal(r["recv_cnt"], rg["recv_sz"][p])
        assert r["wire_rows"] == int(rg["send_sz"][p].sum() - rg["send_sz"][p, p])
        assert r["wire_rows"] < rp["wire_rows"]
        tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7,
                                                                          atol=1e-6)
        np.testing.assert_allclose(r["dh"], want_dh[p], **tol)
        np.testing.assert_allclose(r["dh"], rp["dh"], **tol)


def test_rank_plan_is_a_slice_of_the_ragged_plan(setup):
    """A rank's HaloPlan from the counts equals its slice of the stacked
    plan (JAX's `build_ragged_plan`): send rows, split sizes, the sorted
    backward plan."""
    g, sg, rg, *_ = setup
    tsg = tpart.partition_graph(g, N, method=METHOD)
    for p, shard in enumerate(tsg.shards):
        plan = thalo.HaloPlan(shard, N, "ragged", counts=(rg["send_sz"][p], rg["recv_sz"][p]))
        s = int(rg["send_sz"][p].sum())
        np.testing.assert_array_equal(plan.pack.numpy(), rg["rows"][p, :s])
        assert plan.in_splits == rg["send_sz"][p].tolist()
        assert plan.out_splits == rg["recv_sz"][p].tolist()
        # the stacked plan pads rows to the largest shard's count with row
        # 0, which sorts first: the rank's order is what follows the pads
        pad = rg["rows"].shape[1] - s
        np.testing.assert_array_equal(plan.rows.numpy(), rg["rsort"][p, pad:])
        np.testing.assert_array_equal(plan.pack.numpy()[plan.order.numpy()],
                                      plan.rows.numpy())
        rp = plan.row_ptr.numpy()
        assert rp[0] == 0 and rp[-1] == s and (np.diff(rp) >= 0).all()
        padded = thalo.HaloPlan(shard, N, "padded", counts=(rg["send_sz"][p],
                                                            rg["recv_sz"][p]))
        # JAX's plan over the padded send lists, less the pad slots
        # (slot >= the pair's count), which the port leaves out
        order, rows = build_recv_plan(np.asarray(shard.send_idx))
        keep = (order % sg.max_h) < rg["send_sz"][p][order // sg.max_h]
        np.testing.assert_array_equal(padded.order.numpy(), order[keep])
        np.testing.assert_array_equal(padded.rows.numpy(), rows[keep])
        assert padded.place is None and padded.in_splits == [sg.max_h] * N


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_versions(dtype):
    """K9's and K10's plain versions against numpy: a negative index gives
    a zero row; the segment-sum adds in f32 and fills unreferenced rows
    with zero."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(20, 7)).astype(np.float32)).to(dtype)
    idx = torch.tensor([3, -1, 0, 19, -1, 3], dtype=torch.int32)
    out = thalo.row_gather(x, idx)
    assert out.dtype == dtype
    want = x.float().numpy()[np.maximum(idx.numpy(), 0)] * (idx.numpy() >= 0)[:, None]
    np.testing.assert_array_equal(out.float().numpy(), want)
    pack = np.array([5, 2, 2, 9, 5, 5, 0], np.int32)
    order, rows = build_recv_plan(pack)
    gq = torch.tensor(rng.normal(size=(7, 7)).astype(np.float32)).to(dtype)
    row_ptr = torch.tensor(np.searchsorted(rows, np.arange(11)).astype(np.int32))
    dh = thalo.segsum_gather(gq, torch.tensor(order), torch.tensor(rows), row_ptr, 10)
    assert dh.dtype == torch.float32 and dh.shape == (10, 7)
    want = np.zeros((10, 7), np.float32)
    np.add.at(want, pack, gq.float().numpy())
    np.testing.assert_allclose(dh.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not dh.numpy()[[1, 3, 4, 6, 7, 8]].any()


@pytest.mark.parametrize("wire", ["padded", "ragged"])
@pytest.mark.parametrize("p", range(N))
def test_no_run_of_the_backward_plan_is_longer_than_the_peers(setup, wire, p):
    """K10 gives one warp to a local row's run. Both wires plan over the
    live send slots only, so a run holds at most one entry per peer (the
    padded wire's pad slots are -1 in the pack list and absent from the
    plan), and the plan sums what `index_add_` over the live slots does."""
    g, sg, rg, *_ = setup
    shard = tpart.partition_graph(g, N, method=METHOD).shards[p]
    plan = thalo.HaloPlan(shard, N, wire, counts=(rg["send_sz"][p], rg["recv_sz"][p]))
    pack, order, rows = (t.numpy() for t in (plan.pack, plan.order, plan.rows))
    row_ptr = plan.row_ptr.numpy()
    assert np.diff(row_ptr).max() <= N - 1
    assert row_ptr[0] == 0 and row_ptr[-1] == len(order) == int(rg["send_sz"][p].sum())
    assert (pack[order] == rows).all() and (rows >= 0).all()
    if wire == "padded":
        assert (pack < 0).sum() == N * sg.max_h - len(order)
    rng = np.random.default_rng(p)
    back = rng.normal(size=(len(pack), 3)).astype(np.float32)
    want = np.zeros((sg.vp, 3), np.float32)
    np.add.at(want, pack[pack >= 0], back[pack >= 0])
    got = thalo.segsum_gather(torch.tensor(back), plan.order, plan.rows, plan.row_ptr, sg.vp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_other_devices_and_bad_wires():
    x = torch.zeros((4, 3), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        thalo.row_gather(x, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        thalo.segsum_gather(x, idx, idx, idx, 4)
    g = synthetic_graph(100, 4, 8, 3, seed=1)
    shard = tpart.partition_graph(g, 2).shards[0]
    with pytest.raises(ValueError, match="wire"):
        thalo.HaloPlan(shard, 2, "exact", counts=(np.zeros(2), np.zeros(2)))
    with pytest.raises(ValueError, match="peers"):
        thalo.HaloPlan(shard, 3, "padded", counts=(np.zeros(3), np.zeros(3)))
    assert thalo.make_halo_fn(None, True, multi=False) is None


def test_the_launcher_means_the_card_unless_told_the_cpu():
    """spawn_local with no device runs on the card and raises without one,
    before it starts a rank; the backend is always the caller's to name."""
    with pytest.raises(TypeError, match="backend"):
        spawn_local(2, ranks.sleeping_rank, (0.0,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn_local(2, ranks.sleeping_rank, (0.0,), backend="gloo")


def test_a_failing_rank_fails_the_run():
    """spawn_local raises with the failing rank's traceback and leaves no
    rank waiting in a collective."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn_local(3, ranks.failing_rank, (1,), backend="gloo", device="cpu",
                    timeout_s=60)


def test_a_run_past_its_timeout_is_stopped():
    with pytest.raises(RuntimeError, match="still running"):
        spawn_local(2, ranks.sleeping_rank, (30.0,), backend="gloo", device="cpu",
                    timeout_s=8)
