"""Degree-padded slot-grid SpMM — the port of dorylus_tpu/ops/degree_spmm.py
(`kernel="degree"`).

Each vertex's in-edges fill a run of width-16 block rows (ops/degree_plan.py);
JAX gathers the (R, 16, F) slot grid, weights it, sums each block row in
f32 and segment-sums the block rows into their vertices (`_degree_pass`).
Its four custom-VJP entries are ported with their backward order:
  * `apply(h, val)`: per-edge values through slot_to_edge, differentiable in
    h and val; the backward over the transposed plan fuses the SDDMM
    dval[e] = <gout[dst e], h[src e]> (`degree_spmm_apply`);
  * `apply_static(h)`: construction-time values (GCN norms) baked into the
    plan, pre-cast to bf16 in narrow mode (`degree_spmm_static_apply`);
  * `apply_unit(h)`, `apply_dst(h, dst_val)`: unit weights on each block
    row's live prefix, the dst variant scaling rows outside the pass and
    taking d_dst from the saved unscaled output (`degree_spmm_unit_apply`,
    `degree_spmm_dst_apply`).
They are the autograd Functions of ops/hyb_spmm.py, which call this op's
`_pass`: the JAX package gives both ops the same backward order.

On the card a degree plan is one hub part of the hybrid-ELL kernels: rows =
slot_src, cnt = live_cnt, one output row per vertex with block rows, and
row_ptr the vertex's run of block rows (block_row is ascending). So static
and unit passes launch K1 / K2 (csrc/hyb_spmm.cu), and the dynamic pass K7
(csrc/dyn_spmm.cu, with s2e = slot_to_edge), once per plan: each warp
sums a vertex's block rows in registers, which is the final segment-sum,
and writes the vertex's row once. Isolated vertices have no block row and
keep the zero fill, as JAX's segment_sum leaves them.

The plain version (`degree_pass_plain`) is a line-for-line port of
`_degree_pass`: gather (R, 16, F), weight, f32 row sum, `index_add_` over
block_row, dval through edge_to_slot. CPU tensors take it; CUDA tensors
launch the kernel or raise.

Not ported (TPU memory guards, ROADMAP.md "Not to port"): the `row_chunk`
scan over a materialised (slots, F) message tensor and the out-block maps
of the blocked final reduce. The constructor takes both arguments and
ignores them with a log line.
"""

from __future__ import annotations

import numpy as np
import torch

from dorylus_tpu_torch.common.logging import log
from dorylus_tpu_torch.ops.degree_plan import build_degree_plan
from dorylus_tpu_torch.ops.hyb_spmm import (HybDstFn, HybDynFn, HybStaticFn,
                                            HybUnitFn, _is_narrow, kernel_pass,
                                            reduce_slots_plain, val_ext_of)

# Kernel launches on degree plans made by this process (K1, K2 or K7; each
# also counts in that kernel's own counter in ops/hyb_spmm.py).
# chip_smoke.py resets it before a main path and reads it after.
DEGREE_LAUNCHES = 0


def _upload(plan: dict, n_src: int, n_edges: int, vals: np.ndarray | None,
            vals_dtype: torch.dtype, device: torch.device) -> dict:
    """numpy degree plan -> the kernels' hub part plus what the plain
    version reads, as tensors on `device`."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    block_row = plan["block_row"]
    r = len(block_row) if n_edges else 0  # a zero-edge plan's row is a sentinel
    verts = np.unique(block_row[:r])  # vertices with block rows, ascending
    row_ptr = np.r_[np.searchsorted(block_row[:r], verts), r]
    part = {"rows": t(plan["slot_src"], torch.int32),
            "cnt": t(plan["live_cnt"], torch.int32),
            "v": t(verts, torch.int32), "row_ptr": t(row_ptr, torch.int32),
            "s2e": t(plan["slot_to_edge"], torch.int32)}
    if vals is not None:
        part["vals"] = t(vals, torch.float32).to(vals_dtype)
    return {"part": part, "block_row": t(block_row, torch.int64),
            "edge_to_slot": t(plan["edge_to_slot"], torch.int32),
            "n_src": n_src, "n_edges": n_edges}


def degree_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                      gather_dtype: torch.dtype | None = None, mode: str = "static",
                      val: torch.Tensor | None = None,
                      other: torch.Tensor | None = None):
    """out[v] = sum over v's slots of weight * table[slot_src] -> (num_out,
    F) f32; mode "static" (plan values), "mask" (unit weights on the live
    prefix) or "dynamic" (val[slot_to_edge]; with `other` also dval[e] =
    <table[slot of e], other[block_row of e]>, returned as (out, dval)).
    Works on tensors of any device; `degree_pass` routes only CPU tensors
    here."""
    narrow = _is_narrow(gather_dtype)
    tb = table if gather_dtype is None else table.to(gather_dtype)
    val_ext = val_ext_of(val) if mode == "dynamic" else None
    orows = None if other is None else other[plan["block_row"]]
    part, dv = reduce_slots_plain(tb, plan["part"], narrow, mode, val_ext, orows)
    out = torch.zeros((num_out, table.shape[1]), dtype=torch.float32,
                      device=table.device).index_add_(0, plan["block_row"], part)
    if other is None:
        return out
    return out, dv.reshape(-1)[plan["edge_to_slot"]][: val.shape[0]]


def degree_pass(table: torch.Tensor, plan: dict, num_out: int,
                gather_dtype: torch.dtype | None = None, mode: str = "static",
                val: torch.Tensor | None = None, other: torch.Tensor | None = None):
    """The degree pass: CPU tensors run the plain version; CUDA tensors run
    K1 (static), K2 (mask) or K7 (dynamic) once over the plan, or raise."""
    global DEGREE_LAUNCHES
    if table.device.type == "cpu":
        return degree_pass_plain(table, plan, num_out, gather_dtype, mode, val, other)
    result, launched = kernel_pass(f"degree_{mode}_pass", table, [plan["part"]],
                                   plan["n_src"], num_out, gather_dtype, mode, val,
                                   other, plan["n_edges"])
    DEGREE_LAUNCHES += launched
    return result


class DegreeSpMM:
    """out[v] = sum_{e: dst[e]=v} val[e] * h[src[e]] over a degree-padded
    plan (JAX: ops/degree_spmm.DegreeSpMM), sparsity bound at construction,
    both plans on `device` as tensors. Same protocol as HybSpMM: `apply`,
    `apply_static` (static_val given), `apply_unit`, `apply_dst`.

    num_in may exceed h's rows; dh is cut to h's rows. gather_dtype:
    None/float32 gathers f32 tables; bfloat16 gathers bf16 tables (static
    values pre-cast) and sums in f32. row_chunk and out_block_rows are
    accepted for the JAX signature and not used."""

    def __init__(self, src, dst, num_in: int, num_out: int, block: int = 16,
                 row_chunk: int = 0, gather_dtype: torch.dtype | None = None,
                 out_block_rows: int | None = None, static_val=None,
                 device: str | torch.device = "cpu"):
        src = np.asarray(src)
        dst = np.asarray(dst)
        e = len(src)
        if e and (np.diff(dst) < 0).any():
            raise ValueError("edges must be dst-sorted")
        if e and (src.min() < 0 or src.max() >= num_in
                  or dst.min() < 0 or dst.max() >= num_out):
            raise ValueError("edge endpoint out of range")
        if row_chunk or out_block_rows:
            log("degree op: row_chunk=%d, out_block_rows=%s ignored (TPU memory "
                "guards; the kernels build no (slots, F) tensor and write each "
                "row once)", row_chunk, out_block_rows)
        order = np.argsort(src, kind="stable")
        self.num_in, self.num_out = num_in, num_out
        self.block = block
        self.gather_dtype = gather_dtype
        self.has_static_vals = static_val is not None
        self.device = torch.device(device)
        fwd = build_degree_plan(src, dst, None, num_out, block)
        bwd = build_degree_plan(dst[order], src[order], order, num_in, block)
        fvals = bvals = None
        if self.has_static_vals:
            ve = np.r_[np.asarray(static_val, np.float32), np.float32(0)]
            fvals, bvals = ve[fwd["slot_to_edge"]], ve[bwd["slot_to_edge"]]
        # Narrow mode multiplies in the table dtype: ship the static values
        # pre-cast, as the JAX op does.
        vals_dtype = gather_dtype if _is_narrow(gather_dtype) else torch.float32
        self.fwd = _upload(fwd, int(src.max()) + 1 if e else 0, e, fvals,
                           vals_dtype, self.device)
        self.bwd = _upload(bwd, int(dst.max()) + 1 if e else 0, e, bvals,
                           vals_dtype, self.device)

    def _pass(self, table, plan, num_out, mode, val=None, other=None):
        return degree_pass(table, plan, num_out, self.gather_dtype, mode, val, other)

    def apply(self, h: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        """Per-edge values val (E,), differentiable in h and val."""
        return HybDynFn.apply(h, val, self)

    def apply_static(self, h: torch.Tensor) -> torch.Tensor:
        """Construction-time edge values (static_val); no value gather."""
        if not self.has_static_vals:
            raise RuntimeError("op built without static values: use "
                               "apply / apply_unit / apply_dst")
        return HybStaticFn.apply(h, self)

    def apply_unit(self, h: torch.Tensor) -> torch.Tensor:
        """Unit-weight aggregation over live edges."""
        return HybUnitFn.apply(h, self)

    def apply_dst(self, h: torch.Tensor, dst_val: torch.Tensor) -> torch.Tensor:
        """Edge weight = dst_val[dst[e]] (Dorylus GAT attention)."""
        return HybDstFn.apply(h, dst_val, self)
