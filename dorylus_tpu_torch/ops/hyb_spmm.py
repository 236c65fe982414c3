"""Hybrid-ELL SpMM, static and mask modes — the port of
dorylus_tpu/ops/hyb_spmm.py.

Static mode (GCN): construction-time edge values (the GCN norms) are baked
into the plan; forward is one pass over the forward plan, backward the
same pass over the transposed plan (JAX: `hyb_spmm_static_apply` and
`_static_bwd`).

Mask mode (GAT): unit weights on each slot row's live prefix `cnt` (JAX:
the `_weights` mask branch). `apply_unit` is the unit-weight pass;
`apply_dst` scales its output rows by a per-destination value
(`hyb_spmm_dst_apply`), the form Dorylus attention takes. Its backward
scales gout by dst_val in f32 first, then runs the unit pass over the
transposed plan (the pass rounds to the gather dtype), and forms
d_dst = rowsum(u * gout) in f32 from the unscaled forward output u. The
row scale and the row-dot are torch ops around the pass, as they are jnp
ops around `_hyb_pass` in JAX.

Dynamic mode (`apply`, JAX: `hyb_spmm_apply` and `_apply_bwd`): per-edge
values read through each slot's edge id (`s2e`), differentiable in h and
val. Its backward is one pass over the transposed plan with table = gout
that also forms dval[e] = <gout[dst e], h[src e]> from the rows it gathers
(the fused SDDMM). The engines never build it (the JAX engine builds
`dynamic=False`); GCN reaches it on an op without static values.

Two implementations of the pass, on the same plan layout:
  * `hyb_static_pass_plain` / `hyb_mask_pass_plain` /
    `hyb_dynamic_pass_plain` — plain torch, a line-for-line port of
    `_hyb_pass` / `_reduce_part` (gather -> weight multiply -> f32 row
    sum, hub chunks summed per hub, output placed through `_n_iso` or
    `inv`, dval pulled back through `e2s`). They are the CPU path and the
    reference for the kernels.
  * the CUDA kernels: csrc/hyb_spmm.cu (K1 static, K2 mask) and
    csrc/dyn_spmm.cu (K7 dynamic, with the fused SDDMM), built with nvcc
    at first use and bound with ctypes (ops/cuda_build.py).

`hyb_static_pass`, `hyb_mask_pass` and `hyb_dynamic_pass` dispatch on the
table's device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. There is no fallback from a kernel to its
plain version.

The autograd Functions call `op._pass(table, plan, num_out, mode, ...)`,
so any op with that method and `fwd`/`bwd` plans reuses them: the degree
op (ops/degree_spmm.py) runs the same four entries on its own plans.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan

# Kernel launches made by this process, one per plan part: K1 (static
# mode), K2 (mask mode) and K7 (dynamic mode). chip_smoke.py resets them
# before each main path and reads them after.
KERNEL_LAUNCHES = 0
MASK_LAUNCHES = 0
DYN_LAUNCHES = 0

_CSRC = cuda_build.CSRC / "hyb_spmm.cu"
_DYN_CSRC = cuda_build.CSRC / "dyn_spmm.cu"
_lib: ctypes.CDLL | None = None
_dyn_lib: ctypes.CDLL | None = None
# Filled by build_kernel() / build_dyn_kernel(): library path, build
# seconds (0 when the library for this source was already built), nvcc's
# -Xptxas -v output.
BUILD_INFO: dict = {}
DYN_BUILD_INFO: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _is_narrow(gather_dtype) -> bool:
    return gather_dtype is not None and gather_dtype.itemsize < 4


# ---- plain torch version (CPU path and kernel reference) ----


def slot_weights_plain(part: dict, mode: str, dtype: torch.dtype,
                       val_ext: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, w) slot weights of one part in `dtype` (JAX: `_weights`):
    the plan's values (static), 1 on the live prefix (mask), or the
    per-edge values through the slot->edge map (dynamic; val_ext is val
    in f32 with a zero sentinel appended for pad slots)."""
    if mode == "static":
        return part["vals"].to(dtype)
    if mode == "mask":
        w = part["rows"].shape[1]
        return (torch.arange(w, device=part["rows"].device)[None, :]
                < part["cnt"][:, None]).to(dtype)
    return val_ext[part["s2e"]].to(dtype)


def reduce_slots_plain(tb: torch.Tensor, part: dict, narrow: bool, mode: str,
                       val_ext: torch.Tensor | None = None,
                       other_rows: torch.Tensor | None = None):
    """gather -> weight multiply -> f32 sum over the slot axis for one
    slot grid: (rows, F) f32, and with other_rows (one row per slot row)
    the (rows, w) f32 dot of every gathered row with it (the fused SDDMM),
    else None. Narrow tables multiply in their own dtype (bf16 products)
    and sum in f32, as the JAX narrow mode does; other_rows are cast to
    the message dtype first, as JAX casts them."""
    msgs = tb[part["rows"]]
    if not narrow:
        msgs = msgs.float()
    wt = slot_weights_plain(part, mode, msgs.dtype, val_ext)
    out = (msgs * wt[..., None]).sum(dim=1, dtype=torch.float32)
    if other_rows is None:
        return out, None
    dv = (msgs * other_rows[:, None, :].to(msgs.dtype)).sum(-1, dtype=torch.float32)
    return out, dv


def val_ext_of(val: torch.Tensor) -> torch.Tensor:
    """val in f32 with the zero sentinel the pad slots' edge id E reads."""
    return torch.cat([val.float(), torch.zeros(1, device=val.device)])


def _hyb_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                    gather_dtype: torch.dtype | None, mode: str,
                    val: torch.Tensor | None = None,
                    other: torch.Tensor | None = None,
                    h_local: torch.Tensor | None = None, n_pure: int = 0):
    """h_local / n_pure (the fused-overlap plan, ops/hyb_sharded.py): the
    first n_pure buckets index local rows only and gather from h_local
    (cast once, as the table is), the rest from the table."""
    narrow = _is_narrow(gather_dtype)
    tb = table if gather_dtype is None else table.to(gather_dtype)
    tb_local = None
    if h_local is not None:
        tb_local = h_local if gather_dtype is None else h_local.to(gather_dtype)
    f = table.shape[1]
    dev = table.device
    val_ext = val_ext_of(val) if mode == "dynamic" else None
    outs, dvs = [], []
    for bi, b in enumerate(plan["buckets"]):
        orows = None if other is None else other[b["v"]]
        out, dv = reduce_slots_plain(tb_local if bi < n_pure else tb, b, narrow,
                                     mode, val_ext, orows)
        outs.append(out)
        dvs.append(dv)
    top = plan["top"]
    if top is not None:
        orows = None if other is None else other[top["v"][top["rowv"]]]
        part, dv = reduce_slots_plain(tb, top, narrow, mode, val_ext, orows)
        outs.append(torch.zeros((top["v"].shape[0], f), dtype=torch.float32,
                                device=dev).index_add_(0, top["rowv"], part))
        dvs.append(dv)
    if "n_iso" in plan:
        n_iso = plan["n_iso"]
        pieces = ([torch.zeros((n_iso, f), dtype=torch.float32, device=dev)]
                  if n_iso else []) + outs
        out = (torch.cat(pieces) if pieces
               else torch.zeros((num_out, f), dtype=torch.float32, device=dev))
    else:
        cat = torch.cat(outs + [torch.zeros((1, f), dtype=torch.float32, device=dev)])
        out = cat[plan["inv"]]
    if other is None:
        return out
    if not dvs:
        return out, torch.zeros(0, dtype=torch.float32, device=dev)
    # dv grids raveled in global slot order, pulled back to edge order
    flat = torch.cat([d.reshape(-1) for d in dvs])
    return out, flat[plan["e2s"]][: val.shape[0]]


def hyb_static_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                          gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[v] = sum over v's slots of vals * table[rows] -> (num_out, F) f32.

    Works on tensors of any device; `hyb_static_pass` routes only CPU
    tensors here."""
    return _hyb_pass_plain(table, plan, num_out, gather_dtype, "static")


def hyb_mask_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                        gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[v] = sum over v's live slots of table[rows] -> (num_out, F) f32
    (plans with or without values; the values are not read)."""
    return _hyb_pass_plain(table, plan, num_out, gather_dtype, "mask")


def hyb_dynamic_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                           val: torch.Tensor, gather_dtype: torch.dtype | None = None,
                           other: torch.Tensor | None = None):
    """out[v] = sum over v's slots of val[s2e] * table[rows] -> (num_out, F)
    f32; with `other`, also dval[e] = <table[slot row of e], other[v]>
    (E,) f32, returned as (out, dval). Needs a dynamic plan (s2e, e2s)."""
    return _hyb_pass_plain(table, plan, num_out, gather_dtype, "dynamic", val, other)


# ---- CUDA kernels: build, bind, launch ----


def build_kernel() -> ctypes.CDLL:
    """Build csrc/hyb_spmm.cu for sm_90a (once per source content) and
    load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hyb_part.argtypes = [ci, ci, vp, ci, vp, vp, vp, ci, vp, vp, ci, vp, vp]
    lib.hyb_part.restype = ci
    lib.hyb_error_string.argtypes = [ci]
    lib.hyb_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hybrid-ELL kernel: {msg}")


def build_dyn_kernel() -> ctypes.CDLL:
    """Build csrc/dyn_spmm.cu (K7) for sm_90a (once per source content)
    and load it. Raises when nvcc fails."""
    global _dyn_lib
    if _dyn_lib is not None:
        return _dyn_lib
    lib, info = cuda_build.load(_DYN_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dyn_part.argtypes = [ci, ci, vp, ci, vp, vp, vp, vp, ci, vp, vp, ci,
                             vp, vp, vp, vp]
    lib.dyn_part.restype = ci
    lib.dyn_error_string.argtypes = [ci]
    lib.dyn_error_string.restype = ctypes.c_char_p
    DYN_BUILD_INFO.update(info)
    _dyn_lib = lib
    return lib


def _check_part(tb: torch.Tensor, part: dict, out: torch.Tensor,
                extra_ints: list, extra: list) -> int:
    """What every slot-pass launch assumes of its table, output and part;
    returns the part's output row count."""
    rows, cnt, out_idx = part["rows"], part["cnt"], part["v"]
    row_ptr = part.get("row_ptr")
    _check(tb.is_cuda, f"table must be a CUDA tensor, got {tb.device}")
    _check(tb.dtype in _DTYPE_CODE,
           f"table dtype {tb.dtype} (kernel takes float32 or bfloat16)")
    _check(out.dtype == torch.float32, f"out dtype {out.dtype} (needs float32)")
    _check(tb.dim() == 2 and out.dim() == 2 and out.shape[1] == tb.shape[1],
           f"table {tuple(tb.shape)} / out {tuple(out.shape)} widths differ")
    ints = [rows, cnt, out_idx] + ([row_ptr] if row_ptr is not None else []) + extra_ints
    _check(all(t.dtype == torch.int32 for t in ints), "plan indices must be int32")
    for t in ints + [tb, out] + extra:
        _check(t.device == tb.device, f"tensor on {t.device}, table on {tb.device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")
    _check(rows.dim() == 2 and cnt.shape == (rows.shape[0],),
           f"rows {tuple(rows.shape)} / cnt {tuple(cnt.shape)} disagree")
    n_out = out_idx.shape[0]
    if row_ptr is None:
        _check(n_out == rows.shape[0], "bucket needs one slot row per output row")
    else:
        _check(row_ptr.shape == (n_out + 1,), "row_ptr must have n_out + 1 entries")
    return n_out


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _launch_part(tb: torch.Tensor, part: dict, out: torch.Tensor,
                 unit: bool = False) -> bool:
    """Launch the kernel for one plan part, accumulating its rows into
    `out` (which the caller zero-filled): K1 with the part's values, or K2
    (unit=True, mask mode; no values read). Validates everything the
    kernel assumes and raises on anything it does not take. Returns
    whether it launched (a part without output rows launches nothing)."""
    global KERNEL_LAUNCHES, MASK_LAUNCHES
    vals = None if unit else part.get("vals")
    _check(unit or vals is not None, "static mode needs a plan with values")
    n_out = _check_part(tb, part, out, [], [vals] if vals is not None else [])
    _check(vals is None or vals.dtype == tb.dtype,
           f"vals dtype {None if vals is None else vals.dtype} differs from "
           f"table dtype {tb.dtype}")
    _check(vals is None or vals.shape == part["rows"].shape,
           f"vals {None if vals is None else tuple(vals.shape)} / rows "
           f"{tuple(part['rows'].shape)} disagree")
    if n_out == 0:
        return False
    rows, row_ptr = part["rows"], part.get("row_ptr")
    lib = build_kernel()
    code = lib.hyb_part(
        _device_index(tb), _DTYPE_CODE[tb.dtype], tb.data_ptr(), tb.shape[1],
        rows.data_ptr(), vals.data_ptr() if vals is not None else None,
        part["cnt"].data_ptr(), rows.shape[1],
        row_ptr.data_ptr() if row_ptr is not None else None,
        part["v"].data_ptr(), n_out, out.data_ptr(),
        torch.cuda.current_stream(tb.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"hyb_part ({'mask' if unit else 'static'}) launch "
                           f"failed: {lib.hyb_error_string(code).decode()} ({code})")
    if unit:
        MASK_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1
    return True


def _launch_dyn_part(tb: torch.Tensor, part: dict, val: torch.Tensor,
                     out: torch.Tensor, other: torch.Tensor | None = None,
                     dval: torch.Tensor | None = None) -> bool:
    """Launch K7 for one plan part: the weight of slot (r, j) is
    val[s2e[r, j]]; with `other` (rows in the table's dtype, one per
    output row id) it also writes dval[s2e[r, j]] for every live slot.
    Validates everything the kernel assumes and raises on anything it
    does not take. Returns whether it launched."""
    global DYN_LAUNCHES
    s2e = part.get("s2e")
    _check(s2e is not None, "dynamic mode needs a plan with slot->edge maps")
    _check(s2e.shape == part["rows"].shape,
           f"s2e {tuple(s2e.shape)} / rows {tuple(part['rows'].shape)} disagree")
    _check(val.dtype == torch.float32 and val.dim() == 1,
           f"val dtype {val.dtype} / shape {tuple(val.shape)} (needs a float32 vector)")
    _check((other is None) == (dval is None), "other and dval go together")
    extra = [val]
    if other is not None:
        _check(other.dtype == tb.dtype,
               f"other dtype {other.dtype} differs from table dtype {tb.dtype}")
        _check(other.dim() == 2 and other.shape[1] == tb.shape[1],
               f"other {tuple(other.shape)} / table {tuple(tb.shape)} widths differ")
        _check(dval.dtype == torch.float32 and dval.shape == val.shape,
               f"dval {dval.dtype} {tuple(dval.shape)} must be float32 like val")
        extra += [other, dval]
    n_out = _check_part(tb, part, out, [s2e], extra)
    if n_out == 0:
        return False
    rows, row_ptr = part["rows"], part.get("row_ptr")
    lib = build_dyn_kernel()
    code = lib.dyn_part(
        _device_index(tb), _DTYPE_CODE[tb.dtype], tb.data_ptr(), tb.shape[1],
        rows.data_ptr(), s2e.data_ptr(), val.data_ptr(), part["cnt"].data_ptr(),
        rows.shape[1], row_ptr.data_ptr() if row_ptr is not None else None,
        part["v"].data_ptr(), n_out,
        other.data_ptr() if other is not None else None, out.data_ptr(),
        dval.data_ptr() if dval is not None else None,
        torch.cuda.current_stream(tb.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"dyn_part launch failed: "
                           f"{lib.dyn_error_string(code).decode()} ({code})")
    DYN_LAUNCHES += 1
    return True


def kernel_pass(name: str, table: torch.Tensor, parts: list, n_src: int,
                num_out: int, gather_dtype: torch.dtype | None, mode: str,
                val: torch.Tensor | None = None, other: torch.Tensor | None = None,
                n_edges: int | None = None):
    """A slot pass on the card, one launch per part: K1 (static), K2
    (mask) or K7 (dynamic; with `other` also the fused SDDMM, returned as
    (out, dval)). The table must be a CUDA tensor; anything else raises.
    Returns (result, launches)."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dim() != 2 or table.shape[0] < n_src:
        raise ValueError(f"{name}: table {tuple(table.shape)} has fewer "
                         f"than the plan's {n_src} source rows")
    tb = table.to(gather_dtype if _is_narrow(gather_dtype) else torch.float32)
    tb = tb.contiguous()
    out = torch.zeros((num_out, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if mode != "dynamic":
        launched = sum(_launch_part(tb, part, out, mode == "mask") for part in parts)
        return out, launched
    if val is None or val.shape != (n_edges,):
        raise ValueError(f"{name}: val {None if val is None else tuple(val.shape)} "
                         f"needs one value per edge ({n_edges})")
    val32 = val.float().contiguous()
    oth = dval = None
    if other is not None:
        if other.dim() != 2 or other.shape[0] < num_out:
            raise ValueError(f"{name}: other {tuple(other.shape)} has fewer "
                             f"than the pass's {num_out} output rows")
        oth = other.to(tb.dtype).contiguous()
        dval = torch.zeros(n_edges, dtype=torch.float32, device=table.device)
    launched = sum(_launch_dyn_part(tb, part, val32, out, oth, dval) for part in parts)
    return (out if other is None else (out, dval)), launched


_PASS_NAMES = {"static": "hyb_static_pass", "mask": "hyb_mask_pass",
               "dynamic": "hyb_dynamic_pass"}


def _hyb_pass(table: torch.Tensor, plan: dict, num_out: int,
              gather_dtype: torch.dtype | None, mode: str,
              val: torch.Tensor | None = None, other: torch.Tensor | None = None):
    if table.device.type == "cpu":
        return _hyb_pass_plain(table, plan, num_out, gather_dtype, mode, val, other)
    parts = list(plan["buckets"]) + ([plan["top"]] if plan["top"] is not None else [])
    result, _ = kernel_pass(_PASS_NAMES[mode], table, parts, plan["n_src"], num_out,
                            gather_dtype, mode, val, other, plan.get("n_edges"))
    return result


def hyb_static_pass(table: torch.Tensor, plan: dict, num_out: int,
                    gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The static-mode pass -> (num_out, F) f32. CPU tensors run the plain
    version; CUDA tensors run K1 (one launch per plan part) or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, "static")


def hyb_mask_pass(table: torch.Tensor, plan: dict, num_out: int,
                  gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The mask-mode (unit-weight) pass -> (num_out, F) f32. CPU tensors
    run the plain version; CUDA tensors run K2 (one launch per plan part)
    or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, "mask")


def hyb_dynamic_pass(table: torch.Tensor, plan: dict, num_out: int,
                     val: torch.Tensor, gather_dtype: torch.dtype | None = None,
                     other: torch.Tensor | None = None):
    """The dynamic-mode pass -> (num_out, F) f32, or (out, dval) with
    `other` (the fused SDDMM). CPU tensors run the plain version; CUDA
    tensors run K7 (one launch per plan part) or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, "dynamic", val, other)


# ---- op + autograd ----


def _upload(plan: dict, n_src: int, vals_dtype: torch.dtype,
            device: torch.device, n_edges: int | None = None) -> dict:
    """numpy plan -> torch tensors on `device`; `vals` only where the plan
    has them (mask plans have none). Adds `n_src` (rows the gather table
    must have) and, for the hub top, `row_ptr` (each hub's run of chunk
    rows; rowv is ascending).

    n_edges given (a dynamic op): the slot->edge maps ship too, `s2e` per
    part as int32 for the kernel and the plan's `e2s` (int32) for the
    plain version, which pulls dval back through it; the kernel writes
    dval through s2e and never reads e2s. Otherwise both maps are
    dropped."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    dynamic = n_edges is not None

    def part(p):
        out = {"rows": t(p["rows"], torch.int32), "cnt": t(p["cnt"], torch.int32),
               "v": t(p["v"], torch.int32)}
        if "vals" in p:
            out["vals"] = t(p["vals"], torch.float32).to(vals_dtype)
        if dynamic:
            out["s2e"] = t(p["s2e"], torch.int32)
        return out

    out = {"buckets": tuple(part(b) for b in plan["buckets"]), "top": None,
           "n_src": n_src}
    top = plan["top"]
    if top is not None:
        n_hubs = len(top["v"])
        row_ptr = np.searchsorted(top["rowv"], np.arange(n_hubs + 1))
        out["top"] = dict(part(top), rowv=t(top["rowv"], torch.int64),
                          row_ptr=t(row_ptr, torch.int32))
    if "_n_iso" in plan:
        out["n_iso"] = int(plan["_n_iso"])
    else:
        out["inv"] = t(plan["inv"], torch.int64)
    if dynamic:
        out["e2s"] = t(plan["e2s"], torch.int32)
        out["n_edges"] = n_edges
    return out


# The four entries below run on any op with `fwd`/`bwd` plans, `num_in`,
# `num_out` and `_pass(table, plan, num_out, mode, val=None, other=None)`:
# HybSpMM here and DegreeSpMM (ops/degree_spmm.py), which the JAX package
# gives the same backward order.


class HybStaticFn(torch.autograd.Function):
    """Differentiable static-mode aggregation (JAX: hyb_spmm_static_apply
    with its custom VJP). Backward is the pass over the transposed plan
    with gout, cut to h's rows and cast to h's dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, op) -> torch.Tensor:
        ctx.op = op
        ctx.h_rows, ctx.h_dtype = h.shape[0], h.dtype
        return op._pass(h, op.fwd, op.num_out, "static")

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        dh = op._pass(gout.contiguous(), op.bwd, op.num_in, "static")
        return dh[: ctx.h_rows].to(ctx.h_dtype), None


class HybUnitFn(torch.autograd.Function):
    """out[v] = sum_{u->v} h[u] (JAX: hyb_spmm_unit_apply). Backward is
    the unit pass over the transposed plan, cut to h's rows and cast to
    h's dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, op) -> torch.Tensor:
        ctx.op = op
        ctx.h_rows, ctx.h_dtype = h.shape[0], h.dtype
        return op._pass(h, op.fwd, op.num_out, "mask")

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        dh = op._pass(gout.contiguous(), op.bwd, op.num_in, "mask")
        return dh[: ctx.h_rows].to(ctx.h_dtype), None


class HybDstFn(torch.autograd.Function):
    """out[v] = dst_val[v] * sum_{u->v} h[u] (JAX: hyb_spmm_dst_apply),
    f32. Backward: dh = unit pass over the transposed plan of
    gout * dst_val (scaled in f32, then rounded by the pass), cut to h's
    rows and cast to h's dtype; d_dst = rowsum(u * gout) in f32, with u
    the unscaled forward output."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, dst_val: torch.Tensor, op) -> torch.Tensor:
        u = op._pass(h, op.fwd, op.num_out, "mask")
        ctx.op = op
        ctx.h_rows, ctx.h_dtype = h.shape[0], h.dtype
        ctx.save_for_backward(u, dst_val)
        return u * dst_val.float()[:, None]

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        u, dst_val = ctx.saved_tensors
        gout = gout.float()
        dh = d_dst = None
        if ctx.needs_input_grad[0]:
            gscaled = gout * dst_val.float()[:, None]
            dh = op._pass(gscaled, op.bwd, op.num_in, "mask")
            dh = dh[: ctx.h_rows].to(ctx.h_dtype)
        if ctx.needs_input_grad[1]:
            d_dst = (u * gout).sum(-1).to(dst_val.dtype)
        return dh, d_dst, None


class HybDynFn(torch.autograd.Function):
    """out[v] = sum_{e: dst e = v} val[e] * h[src e] (JAX: hyb_spmm_apply),
    f32, differentiable in h and val. Backward (`_apply_bwd`): one
    dynamic pass over the transposed plan with table = gout and
    other = h gives dh (cut to h's rows, in h's dtype) and, fused,
    dval[e] = <gout[dst e], h[src e]> (in val's dtype). When val needs no
    gradient the pass runs without the SDDMM, as XLA drops JAX's unused
    dval."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, val: torch.Tensor, op) -> torch.Tensor:
        ctx.op = op
        ctx.save_for_backward(h, val)
        return op._pass(h, op.fwd, op.num_out, "dynamic", val)

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        h, val = ctx.saved_tensors
        gout = gout.contiguous()
        if ctx.needs_input_grad[1]:
            dh, dval = op._pass(gout, op.bwd, op.num_in, "dynamic", val, other=h)
            dval = dval[: val.shape[0]].to(val.dtype)
        else:
            dh, dval = op._pass(gout, op.bwd, op.num_in, "dynamic", val), None
        dh = dh[: h.shape[0]].to(h.dtype) if ctx.needs_input_grad[0] else None
        return dh, dval, None


class HybSpMM:
    """Hybrid-ELL SpMM over one sparsity pattern (JAX: ops/hyb_spmm.HybSpMM).
    Both plans are built on the host once and live on `device` as tensors.

    static_val given: static mode (`apply_static`, GCN norms baked in);
    None: plans without values (`apply_unit`, `apply_dst`, GAT). The
    mask-mode entries also run on a plan with values (they read only cnt).
    dynamic=True also ships the slot->edge maps for `apply(h, val)`, the
    per-edge value mode; the engines build dynamic=False, as JAX's do.

    num_in may exceed h's rows (tables with extra rows); dh is cut to h's
    rows. gather_dtype: None/float32 gathers f32 tables;
    bfloat16 gathers bf16 tables (with bf16-precast static values) and
    sums in f32."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype: torch.dtype | None = None,
                 static_val=None, lam_slots: int = _LAMBDA_SLOTS,
                 dynamic: bool = False, device: str | torch.device = "cpu"):
        src = np.asarray(src)
        dst = np.asarray(dst)
        e = len(src)
        if e and (np.diff(dst) < 0).any():
            raise ValueError("edges must be dst-sorted")
        if e and (src.min() < 0 or src.max() >= num_in
                  or dst.min() < 0 or dst.max() >= num_out):
            raise ValueError("edge endpoint out of range")
        order = np.argsort(src, kind="stable")
        self.num_in, self.num_out = num_in, num_out
        self.gather_dtype = gather_dtype
        self.has_static_vals = static_val is not None
        self.dynamic = dynamic
        self.device = torch.device(device)
        fwd = build_hyb_plan(src, dst, None, num_out, max_width, lam_slots,
                             static_val)
        bwd = build_hyb_plan(dst[order], src[order], order, num_in,
                             max_width, lam_slots, static_val)
        # Narrow mode multiplies in the table dtype: ship the static values
        # pre-cast (one rounding, half the bytes), as the JAX op does.
        vals_dtype = gather_dtype if _is_narrow(gather_dtype) else torch.float32
        n_edges = e if dynamic else None
        # n_src: the rows each pass's gather table must have (max index + 1).
        self.fwd = _upload(fwd, int(src.max()) + 1 if e else 0, vals_dtype,
                           self.device, n_edges)
        self.bwd = _upload(bwd, int(dst.max()) + 1 if e else 0, vals_dtype,
                           self.device, n_edges)

    def _pass(self, table, plan, num_out, mode, val=None, other=None):
        return _hyb_pass(table, plan, num_out, self.gather_dtype, mode, val, other)

    def apply(self, h: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        """Per-edge values val (E,), differentiable in h and val."""
        if not self.dynamic:
            raise RuntimeError("op built with dynamic=False (slot->edge maps "
                               "not shipped); rebuild with dynamic=True for "
                               "per-edge values")
        return HybDynFn.apply(h, val, self)

    def apply_static(self, h: torch.Tensor) -> torch.Tensor:
        if not self.has_static_vals:
            raise RuntimeError("op built without static values: use "
                               "apply_unit / apply_dst")
        return HybStaticFn.apply(h, self)

    def apply_unit(self, h: torch.Tensor) -> torch.Tensor:
        return HybUnitFn.apply(h, self)

    def apply_dst(self, h: torch.Tensor, dst_val: torch.Tensor) -> torch.Tensor:
        return HybDstFn.apply(h, dst_val, self)
