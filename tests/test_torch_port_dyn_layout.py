"""The host side of K7, the dynamic-value slot pass (ops/hyb_spmm.py
`_launch_dyn_pass`, csrc/gather_pass.cuh `dyn_team`), on the CPU.

K7 runs every part of a plan in one launch and writes the value gradient of
each live slot at its flat slot, slot0 + r*w + j, for the caller to gather
into edge order through e2s. Held here:
  * the weight source: val read through s2e where it runs in edge order,
    gathered into slot order first where it does not;
  * the flat slot order: for every live slot of the hyb plans (buckets, the
    hub top, the `inv` layout) and the degree plans, forward and transposed,
    e2s[s2e[r, j]] == slot0 + r*w + j, the descriptors carry slot0, and the
    plan's flat s2e is the parts' maps in that order;
  * the launch itself, walked block by block and team by team in plain torch
    (`gather_parts.walk_dyn_plain`: the same lane-to-slot mapping, column
    tiles inside the team, the reduce-scatter of the dots and the lane that
    writes each slot), against the plain passes `hyb_dynamic_pass_plain` and
    `degree_pass_plain` in forward, dh alone and dh with the value gradient,
    with the slot weights read through s2e and gathered into slot order
    first; f32 and bf16 (products rounded to bf16, the dot's too), F in {1,
    41, 128, 300} (300 walks column tiles with the dot), on a power-law graph
    with hub rows, an identity graph and a graph without edges. Each live slot
    is visited once, and no dead slot.

The plain passes are held against JAX in tests/test_torch_port_dynamic.py
and tests/test_torch_port_degree.py. Tolerances: f32 1e-5 of max|plain|
(only summation orders differ), bf16 2e-3 (the same bf16 products summed
in f32 in another order).
"""

import numpy as np
import pytest
import torch

from dorylus_tpu_torch.ops import gather_parts as gp
from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM, degree_pass_plain
from dorylus_tpu_torch.ops.hyb_spmm import (HybSpMM, edge_ordered, hyb_dynamic_pass_plain,
                                            slot_weights)

torch.set_num_threads(1)
V = 90


def _edges(graph: str, seed: int = 4):
    """dst-sorted edges: Zipf in-degrees (hubs past max_width=16, isolated
    rows, vertex ids not degree-sorted: the inv layout), each vertex's one
    self-edge, or none."""
    rng = np.random.default_rng(seed)
    if graph == "powerlaw":
        deg = np.minimum(rng.zipf(1.5, V), 200)
        deg[rng.random(V) < 0.1] = 0
        dst = np.sort(np.repeat(rng.permutation(V).astype(np.int32), deg))
    elif graph == "identity":
        dst = np.arange(V, dtype=np.int32)
    else:
        dst = np.zeros(0, np.int32)
    src = (dst if graph == "identity"
           else rng.integers(0, V, size=len(dst)).astype(np.int32))
    return src, dst, rng.normal(size=len(dst)).astype(np.float32)


def _op(kind: str, graph: str, gd=None):
    src, dst, _ = _edges(graph)
    if kind == "hyb":
        return HybSpMM(src, dst, V, V, max_width=16, gather_dtype=gd, lam_slots=0,
                       dynamic=True, device="cpu")
    return DegreeSpMM(src, dst, V, V, gather_dtype=gd, device="cpu")


@pytest.mark.parametrize("kind", ["hyb", "degree"])
@pytest.mark.parametrize("graph, bwd_in_order", [("powerlaw", False), ("identity", True),
                                                 ("empty", True)])
def test_k7_reads_val_through_s2e_only_where_it_runs_in_edge_order(kind, graph, bwd_in_order):
    """The weight source follows the data: the forward plan's s2e (over
    dst-sorted edges) runs in edge order, so K7 reads val through it; the
    transposed plan's is a permutation, whose values are gathered into slot
    order first, unless it too runs in order (one edge a vertex, or none)."""
    op = _op(kind, graph)
    assert op.fwd["s2e_in_order"]
    assert op.bwd["s2e_in_order"] is bwd_in_order


@pytest.mark.parametrize("s2e, in_order", [
    ([], True), ([7, 7], True), ([0, 1, 2, 7, 3, 7], True), ([2, 0, 3, 1], False),
    ([0, 1, 5, 2, 6, 3], False)])
def test_edge_ordered_counts_live_slots_that_follow_their_predecessor(s2e, in_order):
    assert edge_ordered(np.asarray(s2e, np.int32), 7) is in_order


def _e2s(plan: dict) -> torch.Tensor:
    return plan["e2s"] if "e2s" in plan else plan["edge_to_slot"]


def test_the_powerlaw_hyb_plans_have_hub_rows_and_the_inv_layout():
    op = _op("hyb", "powerlaw")
    for plan in (op.fwd, op.bwd):
        assert plan["top"] is not None and "inv" in plan
    # the forward plan: two buckets and a hub top of a warp a row
    assert len(op.fwd["buckets"]) == 2 and op.fwd["parts"].wide == [True, False, False]
    assert op.bwd["transposed"] and not op.fwd["transposed"]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("kind", ["hyb", "degree"])
def test_every_live_slot_sits_at_slot0_plus_its_place(kind, direction):
    """e2s[s2e[r, j]] == slot0 + r*w + j for every live slot of every part,
    the descriptors carry slot0, and the flat s2e is the parts' maps."""
    op = _op(kind, "powerlaw")
    plan = getattr(op, direction)
    pt, e2s, flat = plan["parts"], _e2s(plan), plan["s2e_flat"]
    assert pt.n_slots == flat.numel() and len(pt.parts) >= 1
    seen = 0
    for part, slot0 in zip(pt.parts, pt.slot0):
        rows, w = part["rows"].shape
        place = slot0 + torch.arange(rows)[:, None] * w + torch.arange(w)[None, :]
        live = torch.arange(w)[None, :] < part["cnt"][:, None]
        s2e = part["s2e"]
        assert torch.equal(flat[place], s2e)
        assert torch.equal(e2s[s2e[live].long()], place[live].int())
        seen += int(live.sum())
    assert seen == op.fwd["n_edges"]  # every edge has one live slot
    for g in (8, 16, 32):
        for desc, k0, _, _ in pt.layout(g):
            np.testing.assert_array_equal(desc["slot0"], pt.slot0[k0:k0 + len(desc)])


def test_slot0_counts_the_slots_of_dropped_parts():
    """A part without output rows takes no block but keeps its slots in the
    flat order: the parts after it start past them."""
    op = _op("hyb", "powerlaw")
    parts = list(op.fwd["buckets"])
    first = parts[0]
    hollow = dict(first, v=first["v"][:0], row_ptr=torch.zeros(1, dtype=torch.int32))
    pt = gp.PartTable([hollow] + parts[1:])
    full = gp.PartTable(parts)
    assert len(pt.parts) == len(parts) - 1 and pt.n_slots == full.n_slots
    want = {id(p): s for p, s in zip(full.parts, full.slot0) if p is not first}
    assert {id(p): s for p, s in zip(pt.parts, pt.slot0)} == want


def _walk(kind, graph, mode, f, dtype, weights):
    gd = torch.bfloat16 if dtype == "bf16" else None
    dt = gd or torch.float32
    op = _op(kind, graph, gd)
    gen = torch.Generator().manual_seed(f)
    val = torch.randn(op.fwd["n_edges"], generator=gen)
    h = torch.randn(V, f, generator=gen)
    gout = torch.randn(V, f, generator=gen)
    plan, table = (op.fwd, h) if mode == "fwd" else (op.bwd, gout)
    other = h if mode == "dh+dval" else None
    if kind == "hyb":
        ref = hyb_dynamic_pass_plain(table, plan, V, val, gd, other=other)
    else:
        ref = degree_pass_plain(table, plan, V, gd, "dynamic", val, other)
    wslot = slot_weights(plan, val, dt) if weights == "slot" else None
    own = gp.gather_table(other, dt) if other is not None else None
    got = gp.walk_dyn_plain(plan["parts"], gp.gather_table(table, dt), plan["s2e_flat"], val,
                            own, V, f, wslot)
    return plan, ref, got


def _close(got, ref, dtype):
    tol = 2e-3 if dtype == "bf16" else 1e-5
    assert got.shape == ref.shape
    if ref.numel():
        assert float((got - ref).abs().max()) <= tol * max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("weights", ["edge", "slot"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("mode", ["fwd", "dh", "dh+dval"])
@pytest.mark.parametrize("kind", ["hyb", "degree"])
def test_walking_k7_gives_the_plain_pass(kind, mode, f, dtype, weights):
    """The launch walked as the kernel runs it, on the power-law graph (hub
    rows; the degree plan's vertices of many block rows), against the plain
    pass: out, and with the dot dval = flat[e2s]; each live slot visited
    once, no dead slot."""
    plan, ref, (out, flat, visits) = _walk(kind, "powerlaw", mode, f, dtype, weights)
    e2s, n_edges = _e2s(plan), plan["n_edges"]
    if mode == "dh+dval":
        ref, ref_dval = ref
        _close(flat.index_select(0, e2s[:n_edges]), ref_dval, dtype)
    else:
        assert flat is None
    _close(out, ref, dtype)
    assert int(visits.sum()) == n_edges
    assert torch.equal(visits[e2s[:n_edges].long()], torch.ones(n_edges, dtype=torch.int64))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [1, 41, 128, 300])
@pytest.mark.parametrize("kind", ["hyb", "degree"])
@pytest.mark.parametrize("graph", ["identity", "empty"])
def test_walking_k7_on_identity_and_empty_graphs(graph, kind, f, dtype):
    """One edge a vertex (a slot row of one live slot each), and no edge at
    all (no block; a degree plan's sentinel row is a part without output
    rows): dh with the value gradient, the pass that writes the most."""
    plan, (ref, ref_dval), (out, flat, visits) = _walk(kind, graph, "dh+dval", f, dtype,
                                                      "edge")
    n_edges = plan["n_edges"]
    assert n_edges == (V if graph == "identity" else 0)
    _close(out, ref, dtype)
    _close(flat.index_select(0, _e2s(plan)[:n_edges]), ref_dval, dtype)
    assert int(visits.sum()) == n_edges
    if graph == "empty":
        assert plan["parts"].parts == [] and not out.any()


def test_dyn_geometry_keeps_four_loads_in_flight_with_the_dot():
    assert gp.dyn_geometry(128, 4, wide=False) == {"g": 32, "r": 1, "unroll": 8}
    assert gp.dyn_geometry(128, 4, wide=False, dot=True)["unroll"] == 4
    assert gp.dyn_geometry(128, 2, wide=True) == {"g": 16, "r": 2, "unroll": 4}
    assert gp.dyn_geometry(8, 2, wide=True, dot=True) == {"g": 8, "r": 4, "unroll": 4}
    assert gp.dyn_geometry(304, 4, wide=True)["r"] == 1  # 76 pieces: three tiles of 32 lanes
