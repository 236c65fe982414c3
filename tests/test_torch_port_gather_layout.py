"""The host side of the gather kernels K1/K2 and K8 on the CPU
(ops/gather_parts.py): the part-descriptor table one launch carries, the
block prefix a block finds its part by, and the padded gather table.

The kernels themselves run only on a card (tests/test_torch_port_gpu.py);
what surrounds them is Python, and is held here against the plain passes:
the blocks of a plan cover each part's output rows exactly once, each part
reads the table its split names, and the padded table holds the table's
values in its first F columns and zeros after them. Tolerances: f32 1e-5
of max|plain| (only summation orders differ), bf16 tables 1e-2 (the same
bf16 products, summed in f32 in another order).
"""

import numpy as np
import pytest
import torch

from dorylus_tpu_torch.graph.graph import Graph
from dorylus_tpu_torch.graph.partition import partition_graph
from dorylus_tpu_torch.ops import gather_parts as gp
from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM, degree_pass_plain
from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM, fused_pass_plain
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM, _hyb_pass_plain

torch.set_num_threads(1)
GROUPS = (8, 16, 32)


def _edges(v=300, seed=3, cap=120):
    """dst-sorted Zipf in-degrees (hubs past max_width=16, isolated rows),
    uniform sources, values in (0.05, 1)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, v), cap)
    dst = np.sort(np.repeat(rng.permutation(v).astype(np.int32), deg))
    src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    return src, dst, rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)


def _hyb(lam_slots=64):
    src, dst, val = _edges()
    return HybSpMM(src, dst, 300, 300, max_width=16, static_val=val, lam_slots=lam_slots,
                   device="cpu")


def _fused(static=True):
    src, dst, _ = _edges(v=403, seed=5)
    rng = np.random.default_rng(5)
    g = Graph(num_vertices=403, src=src, dst=dst,
              features=rng.normal(size=(403, 4)).astype(np.float32),
              labels=(np.arange(403) % 3).astype(np.int32), num_classes=3).finalize()
    sg = partition_graph(g, 4, method="hash")
    return ShardedHybSpMM(sg.shards[1], 4, edges="fused", static_vals=static, max_width=16,
                          lam_slots=8, device="cpu")


def _plans():
    src, dst, val = _edges()
    op = _hyb()
    return {"hyb fwd": op.fwd, "hyb bwd": op.bwd,
            "degree": DegreeSpMM(src, dst, 300, 300, static_val=val, device="cpu").fwd,
            "fused": _fused().fwd}


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("name", ["hyb fwd", "hyb bwd", "degree", "fused"])
def test_blocks_cover_every_output_row_once(name, g):
    pt = _plans()[name]["parts"]
    seen = [[] for _ in pt.parts]
    for k, rows in pt.block_rows(g):
        assert len(rows) > 0  # no block without rows
        seen[k].append(rows)
    for k, part in enumerate(pt.parts):
        got = np.sort(np.concatenate(seen[k]))
        np.testing.assert_array_equal(got, np.arange(pt.n_out[k]))
    launches = pt.layout(g)
    assert sum(n for _, _, n, _ in launches) == len(pt.block_rows(g))


@pytest.mark.parametrize("g", GROUPS)
def test_block_prefix_of_buckets_and_the_hub_top(g):
    """The hub top (longest rows) comes first; a part whose rows average
    WIDE_SLOTS live slots takes a warp an output row, any other a group;
    each part's first block is the blocks of the parts before it."""
    op = _hyb()
    pt = op.fwd["parts"]
    assert op.fwd["top"] is not None and pt.parts[0] is op.fwd["top"]
    mean = [live / n for live, n in zip(pt.live, pt.n_out)]
    assert mean == sorted(mean, reverse=True)
    assert pt.wide == [m >= gp.WIDE_SLOTS for m in mean]
    assert [pt.teams(g, k) for k in range(len(mean))] == [
        8 if wide or g == 32 else 256 // g for wide in pt.wide]
    (desc, k0, n_blocks, address), = pt.layout(g)
    assert address == desc.ctypes.data
    blocks = [-(-n // pt.teams(g, k)) for k, n in enumerate(pt.n_out)]
    np.testing.assert_array_equal(desc["block0"], np.cumsum([0] + blocks[:-1]))
    assert n_blocks == sum(blocks) and k0 == 0
    for row, part in zip(desc, pt.parts):
        assert row["rows"] == part["rows"].data_ptr() and row["w"] == part["rows"].shape[1]
        assert row["row_ptr"] == (part["row_ptr"].data_ptr() if "row_ptr" in part else 0)
        assert row["split"] == gp.LOCAL_ONLY


def test_an_empty_part_takes_no_block():
    op = _hyb()
    parts = list(op.fwd["buckets"])
    empty = {k: t[:0] for k, t in parts[0].items()}
    pt = gp.PartTable([empty] + parts)
    assert len(pt.parts) == len(parts) and all(p is not empty for p in pt.parts)
    assert [k for k, _ in pt.block_rows(16)] == [k for k, _ in gp.PartTable(parts).block_rows(16)]
    # a plan of empty parts only: no block, and its values' dtype is kept
    only = gp.PartTable([empty])
    assert only.parts == [] and only.layout(16) == [] and only.block_rows(16) == []
    assert only.vals_dtype == torch.float32


@pytest.mark.parametrize("static", [True, False], ids=["static", "mask"])
def test_fused_parts_split_at_vp(static):
    """Pure buckets never read the ghost rows; mixed buckets and the hub
    top split their slots at vp."""
    op = _fused(static)
    pt = op.fwd["parts"]
    pure = {id(b) for b in op.fwd["buckets"][: op.n_pure]}
    assert op.n_pure > 0 and len(pure) < len(pt.parts)
    for part, split in zip(pt.parts, pt.splits):
        assert split == (gp.LOCAL_ONLY if id(part) in pure else op.vp)
        if id(part) in pure:
            live = torch.arange(part["rows"].shape[1])[None, :] < part["cnt"][:, None]
            assert int(part["rows"][live].max()) < op.vp
    (desc, _, _, _), = pt.layout(16)
    np.testing.assert_array_equal(desc["split"], pt.splits)


def test_more_parts_than_one_launch_holds():
    """A plan of more than MAX_PARTS parts takes one launch per MAX_PARTS,
    each with its own block prefix, and still covers every row once."""
    rng = np.random.default_rng(11)
    deg = np.arange(1, 505)  # every width class of 8 up to 504: 63 buckets
    dst = np.repeat(np.arange(504, dtype=np.int32), deg)
    src = rng.integers(0, 504, size=len(dst)).astype(np.int32)
    val = rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    op = HybSpMM(src, dst, 504, 504, max_width=512, static_val=val, lam_slots=0, device="cpu")
    pt = op.fwd["parts"]
    assert len(pt.parts) > gp.MAX_PARTS
    launches = pt.layout(16)
    assert len(launches) == -(-len(pt.parts) // gp.MAX_PARTS)
    assert all(desc["block0"][0] == 0 for desc, _, _, _ in launches)
    rows = {}
    for k, r in pt.block_rows(16):
        rows.setdefault(k, []).append(r)
    assert sorted(rows) == list(range(len(pt.parts)))
    h = torch.randn(504, 8)
    ref = _hyb_pass_plain(h, op.fwd, 504, None, "static")
    got = gp.walk_plain(pt, 16, (h,), 504, None, "static")
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("f", [1, 41, 128, 300])
def test_padded_table_holds_the_table(f, dtype):
    x = torch.randn(37, f)
    tb = gp.gather_table(x, dtype)
    vec = 16 // tb.element_size()
    assert tb.dtype == dtype and tb.shape[0] == 37 and tb.shape[1] % vec == 0
    assert f <= tb.shape[1] < f + vec and tb.is_contiguous() and tb.data_ptr() % 16 == 0
    assert torch.equal(tb[:, :f], x.to(dtype))
    assert not bool(tb[:, f:].any())
    g, tiles = gp.group_lanes(tb.shape[1], tb.element_size())
    assert g * tiles * vec >= tb.shape[1] and (g == 32 or tiles == 1)
    if dtype == torch.float32 and f % 4 == 0:
        assert tb is x  # an aligned f32 table is read as it is


@pytest.mark.parametrize("gd", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["static", "mask"])
@pytest.mark.parametrize("name", ["hyb fwd", "hyb bwd", "degree"])
def test_walking_the_descriptors_gives_the_plain_pass(name, mode, gd):
    plan = _plans()[name]
    h = torch.randn(300, 24)
    if name == "degree":
        ref = degree_pass_plain(h, plan, 300, gd, mode)
    else:
        ref = _hyb_pass_plain(h, plan, 300, gd, mode)
    tol = (1e-2 if gd else 1e-5) * float(ref.abs().max())
    for g in GROUPS:
        got = gp.walk_plain(plan["parts"], g, (h,), 300, gd, mode)
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("gd", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "mask"])
def test_walking_the_fused_descriptors_gives_the_plain_fused_pass(static, gd):
    op = _fused(static)
    mode = "static" if static else "mask"
    h, ghosts = torch.randn(op.vp, 24), torch.randn(op.table - op.vp, 24)
    ref = fused_pass_plain(h, ghosts, op.fwd, op.n_pure, gd, mode)
    got = gp.walk_plain(op.fwd["parts"], 16, (h, ghosts), op.vp, gd, mode)
    assert float((got - ref).abs().max()) <= (1e-2 if gd else 1e-5) * float(ref.abs().max())
