"""K9 (the halo row gather, csrc/halo.cu) and K5's (E,) pass (the sorted
segment-sum, csrc/edge_spmm.cu) without a card: each kernel's launch
geometry and its pass walked team by team in plain torch as the kernel runs
it (parallel/halo.py `walk_row_gather`, ops/spmm.py `walk_segment_sum`),
against the plain versions and, through the ops that run them, against JAX.

  * K9: the unit and team for rows of 2, 4, 8 and 16-byte multiples (F = 1,
    3, 41, 128, 300 in f32 and bf16), -1 slots, no output rows, a table of
    one row: bit for bit, every output byte written once;
  * K9 through `HaloRecvFn` on a 4-shard graph, the walk in place of the
    kernel and the collective's rows handed over in-process, against JAX's
    `halo_recv` with its planned VJP under shard_map: the ghosts bit for
    bit on both wires, dh in f32 within 1e-5;
  * K5: the team from the mean row length, the warp's hub rows, rows of 0
    edges, a row of 5,000 edges, E = 0, g as a view at each element offset
    from a 16-byte boundary (the chunks that reach past g's ends read
    element by element): within f32 1e-5 of max|ref| of the plain version,
    every row written once;
  * K5 through `take_sorted`'s backward (the walk in place of the kernel)
    against JAX's `take_sorted` VJP, f32 1e-5.

About 20 s in one process.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.ops import spmm as jspmm
from dorylus_tpu.parallel.halo import build_recv_plan, halo_recv
from dorylus_tpu.parallel.mesh import GRAPH_AXIS, make_mesh
from dorylus_tpu_torch.graph import partition as tpart
from dorylus_tpu_torch.ops import spmm as tspmm
from dorylus_tpu_torch.parallel import halo as thalo
from dorylus_tpu_torch.parallel import multihost

torch.set_num_threads(1)

FS = [1, 3, 41, 128, 300]
DTYPES = [torch.float32, torch.bfloat16]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


# ---- K9 ----


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("f", FS)
def test_row_gather_geometry(f, dtype):
    """The unit is the widest of 16, 8, 4, 2 bytes that divides the row; a
    team is the row's units rounded up to a power of two in 4..32, 2 units
    a lane a chunk past 32 units; the blocks hold every row."""
    rb = f * dtype.itemsize
    geo = thalo.row_gather_geometry(rb, 1000)
    assert rb % geo.unit == 0 and all(rb % u for u in (16, 8, 4, 2) if u > geo.unit)
    units = rb // geo.unit
    assert geo.g == min(32, max(4, 1 << (units - 1).bit_length()))
    assert geo.steps == (2 if units > 32 else 1)
    assert geo.blocks * (thalo.THREADS // geo.g) * thalo.TEAM_ROWS >= 1000
    # F = 41: 164 bytes in 4-byte units, 82 in 2-byte units, a warp a row,
    # two units a lane; F = 128 moves 16 bytes a lane
    if f == 41:
        assert (geo.unit, geo.g, geo.steps) == ((4 if dtype == torch.float32 else 2), 32, 2)
    if f == 128:
        assert geo.unit == 16 and geo.g == (32 if dtype == torch.float32 else 16)
    with pytest.raises(ValueError, match="even"):
        thalo.row_gather_geometry(rb * 2 + 1, 10)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("f", FS)
def test_row_gather_walk_matches_plain(f, dtype):
    """Walked team by team, K9 equals the plain gather bit for bit and
    writes every output byte once (a -1 slot writes zeros); also from a
    table of one row and into no rows."""
    rng = np.random.default_rng(f)
    x = torch.tensor(rng.normal(size=(29, f)).astype(np.float32)).to(dtype)
    rb = f * x.element_size()
    cases = [(x, rng.integers(-1, 29, size=300)),  # rows past the first block's
             (x[:1].clone(), np.array([0, -1, 0, 0, -1, 0])),
             (x, np.zeros(0, np.int64))]
    for table, ids in cases:
        idx = torch.tensor(ids.astype(np.int32))
        got, writes = thalo.walk_row_gather(table, idx, thalo.row_gather_geometry(rb, len(ids)))
        ref = thalo.row_gather_plain(table, idx)
        assert got.shape == ref.shape and torch.equal(_bits(got), _bits(ref))
        assert bool((writes == 1).all())
        assert not bool(_bits(got)[idx < 0].any())


N = 4


@pytest.fixture(scope="module")
def shards():
    g = synthetic_graph(300, 6, 16, 5, seed=17)
    sg = partition_graph(g, N, method="hash")
    cnt = np.stack([thalo.ghost_counts(s, N, sg.vp, sg.max_h) for s in
                    tpart.partition_graph(g, N, method="hash").shards], axis=1)
    return g, sg, cnt


def _jax_halo(sg, h, gout):
    """(ghosts, dh) per shard: JAX's halo_recv with the host-built plan and
    its custom VJP, under shard_map on N virtual CPU devices."""
    send = np.stack([s.send_idx for s in sg.shards])
    plans = [build_recv_plan(s.send_idx) for s in sg.shards]
    order, rows = (np.stack([p[i] for p in plans]) for i in (0, 1))
    spec = P(GRAPH_AXIS)

    @partial(shard_map, mesh=make_mesh(N), in_specs=(spec,) * 5, out_specs=(spec, spec),
             check_vma=False)
    def run(h, s, o, r, g):
        out, vjp = jax.vjp(lambda x: halo_recv(x, s[0], plan=(o[0], r[0])), h[0])
        return out[None], vjp(g[0])[0][None]

    out, dh = jax.jit(run)(jnp.asarray(h), jnp.asarray(send), jnp.asarray(order),
                           jnp.asarray(rows), jnp.asarray(gout))
    return np.asarray(out), np.asarray(dh)


@pytest.mark.parametrize("f", [41, 128])
@pytest.mark.parametrize("wire", ["padded", "ragged"])
def test_halo_recv_through_the_walk_matches_jax(shards, wire, f, monkeypatch):
    """HaloRecvFn forward and backward on each of 4 shards, K9's walk in
    place of the kernel (pack, place, unplace) and each collective's rows
    handed over in-process: the ghosts equal JAX's bit for bit on the live
    slots and are zero on the rest; dh equals JAX's VJP within f32 1e-5
    (the cotangent is zero on the slots no edge reads)."""
    g, sg, cnt = shards
    tsg = tpart.partition_graph(g, N, method="hash")
    plans = [thalo.HaloPlan(s, N, wire, counts=(cnt[p], cnt[:, p]), device="cpu")
             for p, s in enumerate(tsg.shards)]
    rng = np.random.default_rng(5)
    h = rng.normal(size=(N, sg.vp, f)).astype(np.float32)
    live = np.zeros((N, N * sg.max_h), bool)
    for p in range(N):
        for q in range(N):
            live[p, q * sg.max_h: q * sg.max_h + int(cnt[q, p])] = True
    gout = rng.normal(size=(N, N * sg.max_h, f)).astype(np.float32) * live[..., None]
    want_out, want_dh = _jax_halo(sg, h, gout)

    def walk(x, idx):
        geo = thalo.row_gather_geometry(x.shape[1] * x.element_size(), idx.shape[0])
        got, writes = thalo.walk_row_gather(x, idx, geo)
        assert bool((writes == 1).all())
        return got

    def blocks(buf, splits):
        return list(torch.split(buf, splits))

    # what each rank puts on the wire, forward and backward
    sent = [blocks(walk(torch.tensor(h[p]), pl.pack), pl.in_splits)
            for p, pl in enumerate(plans)]
    back = [blocks(torch.tensor(gout[p]) if pl.unplace is None
                   else walk(torch.tensor(gout[p]), pl.unplace), pl.out_splits)
            for p, pl in enumerate(plans)]
    monkeypatch.setattr(thalo, "row_gather", walk)
    for p, pl in enumerate(plans):
        calls = []

        def a2a(inp, in_splits, out_splits, group=None, p=p, calls=calls):
            assert group is None  # the world: no mesh
            calls.append(in_splits)
            if len(calls) == 1:  # the forward: owner q's rows for p
                assert all(torch.equal(a, b) for a, b in zip(blocks(inp, in_splits), sent[p]))
                return torch.cat([sent[q][p] for q in range(N)])
            return torch.cat([back[q][p] for q in range(N)])  # what receiver q returns

        monkeypatch.setattr(multihost, "all_to_all_rows", a2a)
        hp = torch.tensor(h[p], requires_grad=True)
        ghosts = thalo.HaloRecvFn.apply(hp, pl)
        ghosts.backward(torch.tensor(gout[p]))
        np.testing.assert_array_equal(ghosts.detach().numpy()[live[p]], want_out[p][live[p]])
        assert not ghosts.detach().numpy()[~live[p]].any()
        np.testing.assert_allclose(hp.grad.numpy(), want_dh[p], rtol=1e-5, atol=1e-5)


def test_plan_indices_are_checked_where_the_plan_is_built(shards):
    """The kernels take the plan's arrays call after call; HaloPlan checks
    their values once: a send list that names a row past the shard's own
    is refused on either wire."""
    g, sg, cnt = shards
    shard = tpart.partition_graph(g, N, method="hash").shards[0]
    send = np.array(shard.send_idx)
    send[1, 0] = sg.vp  # one past the shard's rows
    bad = dataclasses.replace(shard, send_idx=send)
    for wire in ("padded", "ragged"):
        with pytest.raises(ValueError, match="pack indices"):
            thalo.HaloPlan(bad, N, wire, counts=(cnt[0], cnt[:, 0]), device="cpu")
        thalo.HaloPlan(shard, N, wire, counts=(cnt[0], cnt[:, 0]), device="cpu")


# ---- K5 ----


def _csr(mean, n_rows=400, hub=5000, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(mean, size=n_rows)
    deg[::7] = 0
    if hub:
        deg[11] = hub
    return torch.tensor(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)), deg


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("mean", [1, 3, 50, 120, 400])
def test_segment_sum_geometry(mean, itemsize):
    """A team of 4-32 lanes covers about half the mean row a step in
    16-byte loads (Reddit's 50 edges a row in f32: 8 lanes); the blocks
    hold every row."""
    team, blocks = tspmm.segment_sum_geometry(1000, 1000 * mean, itemsize)
    per_step = team * 16 // itemsize
    assert team in (4, 8, 16, 32)
    assert team == 4 or per_step // 2 < mean
    assert team == 32 or 2 * per_step >= mean
    assert blocks * 256 // team >= 1000
    if (mean, itemsize) == (50, 4):
        assert team == 8


@pytest.mark.parametrize("head", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mean", [3, 50, 400])
def test_segment_sum_walk_matches_plain(mean, dtype, head):
    """Walked team by team, K5's (E,) pass equals the plain segment-sum
    within f32 1e-5 of max|ref|: rows of 0 edges are zero, the row of 5,000
    edges is the warp's (and only it), every row is written once, and only
    the chunks that reach past g's ends are read element by element."""
    rp, deg = _csr(mean, n_rows=120 if mean == 400 else 400)
    e = int(deg.sum())
    rng = np.random.default_rng(mean + head)
    base = torch.tensor(rng.normal(size=e + 16).astype(np.float32)).to(dtype)
    g = base[head: head + e]  # head elements past a 16-byte boundary, as the kernel counts
    out, writes, scalar, hubs = tspmm.walk_segment_sum(g, rp, head=head)
    ref = tspmm.segment_sum_plain(g, rp)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert bool((writes == 1).all()) and not bool(out[torch.tensor(deg == 0)].any())
    team, _ = tspmm.segment_sum_geometry(len(deg), e, g.element_size())
    v = 16 // g.element_size()
    want_hubs = [] if team == 32 else [
        r for r in range(len(deg)) if deg[r] and
        (int(rp[r + 1]) - 1 + head) // v - (int(rp[r]) + head) // v >= tspmm.HUB_CHUNKS]
    assert hubs == want_hubs and (team == 32 or 11 in hubs)
    last = (e - 1 + head) // v
    assert scalar <= {0, last} and (head == 0 or 0 in scalar)
    assert (last in scalar) == ((last + 1) * v - head > e)


def test_segment_sum_walk_of_no_edges_and_of_one_row():
    """E = 0 gives zero rows; a single row of more than 4,096 edges."""
    out, writes, scalar, hubs = tspmm.walk_segment_sum(torch.zeros(0),
                                                       torch.zeros(6, dtype=torch.int32))
    assert out.shape == (5,) and not bool(out.any()) and bool((writes == 1).all())
    assert not scalar and not hubs
    g = torch.tensor(np.random.default_rng(1).normal(size=4100).astype(np.float32))
    rp = torch.tensor([0, 4100], dtype=torch.int32)
    out, writes, _, hubs = tspmm.walk_segment_sum(g, rp)
    np.testing.assert_allclose(out.numpy(), [float(g.double().sum())], rtol=1e-5)
    team, _ = tspmm.segment_sum_geometry(1, 4100, 4)
    assert team == 32 and hubs == []  # a team of a warp is the warp already


@pytest.mark.parametrize("shape", ["N", "NF"])
def test_take_sorted_backward_through_the_walk_matches_jax(shape, monkeypatch):
    """take_sorted's backward with K5's walk in place of the (E,) kernel
    (the (E, F) cotangent takes the plain version) against JAX's
    `take_sorted` VJP, f32 1e-5, on a graph with a row of 5,000 edges."""
    rp, deg = _csr(50, seed=3)
    v = len(deg)
    dst = np.repeat(np.arange(v, dtype=np.int32), deg)
    src = np.random.default_rng(4).integers(0, v, size=len(dst)).astype(np.int32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(v,) if shape == "N" else (v, 5)).astype(np.float32)
    gco = rng.normal(size=(len(dst),) + x.shape[1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jspmm.take_sorted(xx, jnp.asarray(dst), v), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(gco))
    op = tspmm.EdgeSpMM(src, dst, v, v, device="cpu")
    plain = tspmm.segment_sum
    walked = []

    def walk(g, row_ptr):
        if g.dim() == 2:
            return plain(g, row_ptr)
        out, writes, _, _ = tspmm.walk_segment_sum(g, row_ptr)
        assert bool((writes == 1).all())
        walked.append(True)
        return out

    monkeypatch.setattr(tspmm, "segment_sum", walk)
    xt = torch.tensor(x, requires_grad=True)
    tspmm.take_sorted(xt, torch.tensor(dst), v, op=op).backward(torch.tensor(gco))
    assert walked == ([True] if shape == "N" else [])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
