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
(the fused SDDMM): each live slot's dot in flat slot order, pulled back to
edge order through `e2s`, as JAX does. The engines never build it (the JAX
engine builds `dynamic=False`); GCN reaches it on an op without static
values.

Two implementations of the pass, on the same plan layout:
  * `hyb_static_pass_plain` / `hyb_mask_pass_plain` /
    `hyb_dynamic_pass_plain` — plain torch, a line-for-line port of
    `_hyb_pass` / `_reduce_part` (gather -> weight multiply -> f32 row
    sum, hub chunks summed per hub, output placed through `_n_iso` or
    `inv`, dval pulled back through `e2s`). They are the CPU path and the
    reference for the kernels.
  * the CUDA kernels: csrc/hyb_spmm.cu (K1 static, K2 mask) and
    csrc/dyn_spmm.cu (K7 dynamic, alone or with the fused SDDMM), each one
    launch per pass over every part of the plan, through the gather core
    csrc/gather_pass.cuh and the plan's descriptor table
    (ops/gather_parts.py), built with nvcc at first use and bound with
    ctypes (ops/cuda_build.py).

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

from dorylus_tpu_torch.common.device import resolve_device, stream_handle
from dorylus_tpu_torch.common.metrics import gauge, span
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.gather_parts import PartTable, gather_table, group_lanes
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan

# Kernel launches made by this process, one per pass (a plan of more than
# gather_parts.MAX_PARTS parts takes one per MAX_PARTS), each counted once:
# K1 (static mode), K2 (mask mode) and K7 (dynamic mode): its forward
# (DYN_), its dh alone over a transposed plan (DYN_T_) and its dh with the
# fused value gradient (DYN_DVAL_). chip_smoke.py resets them before each
# main path and reads them after.
KERNEL_LAUNCHES = 0
MASK_LAUNCHES = 0
DYN_LAUNCHES = 0
DYN_T_LAUNCHES = 0
DYN_DVAL_LAUNCHES = 0

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
    lib.hyb_pass.argtypes = [ci, ci, ci, vp, ci, ci, ci, vp, ci, ci, ci, vp, vp]
    lib.hyb_pass.restype = ci
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
    lib.dyn_pass.argtypes = [ci, ci, ci, ci, vp, ci, ci, vp, vp, ci, ci, vp, vp, vp, ci,
                             vp, vp, vp]
    lib.dyn_pass.restype = ci
    lib.dyn_error_string.argtypes = [ci]
    lib.dyn_error_string.restype = ctypes.c_char_p
    DYN_BUILD_INFO.update(info)
    _dyn_lib = lib
    return lib


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def check_pass_tables(tables: list, plan: dict, out: torch.Tensor, unit: bool) -> tuple:
    """What a K1/K2/K8 launch assumes of its tables (laid out by
    `gather_table`), its output and its plan, checked once a pass (the
    plan's parts were checked at upload); returns (ld, g, column tiles)."""
    tb = tables[0]
    _check(tb.is_cuda, f"table must be a CUDA tensor, got {tb.device}")
    _check(tb.dtype in _DTYPE_CODE,
           f"table dtype {tb.dtype} (kernel takes float32 or bfloat16)")
    _check(out.dtype == torch.float32, f"out dtype {out.dtype} (needs float32)")
    vec = 16 // tb.element_size()
    _check(tb.dim() == 2 and out.dim() == 2 and tb.shape[1] >= out.shape[1]
           and tb.shape[1] % vec == 0,
           f"table {tuple(tb.shape)} / out {tuple(out.shape)} widths differ (the table's "
           f"rows hold out's columns, padded to a multiple of {vec})")
    for t in tables:
        _check(t.dtype == tb.dtype and t.dim() == 2 and t.shape[1] == tb.shape[1],
               f"ghosts {t.dtype} {tuple(t.shape)} / h {tb.dtype} {tuple(tb.shape)} disagree")
        _check(t.device == tb.device, f"tensor on {t.device}, table on {tb.device}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
               "all tensors must be contiguous (tables 16-byte aligned)")
    # a fused plan's mixed parts read the ghost rows from its vp local rows on
    _check(len(tables) == (2 if "vp" in plan else 1)
           and ("vp" not in plan or tb.shape[0] == plan["vp"]),
           f"tables of {[t.shape[0] for t in tables]} rows for a plan of "
           f"{plan.get('vp', 'no')} local rows")
    pt = plan["parts"]
    _check(out.device == tb.device and pt.device == tb.device,
           f"out on {out.device}, plan on {pt.device}, table on {tb.device}")
    _check(out.is_contiguous() and out.shape[0] >= pt.out_rows,
           f"out {tuple(out.shape)} must be contiguous with {pt.out_rows} rows")
    # (a plan without parts launches nothing: no values to check)
    _check(unit or not pt.parts or pt.vals_dtype is not None,
           "static mode needs a plan with values")
    _check(unit or not pt.parts or pt.vals_dtype == tb.dtype,
           f"vals dtype {pt.vals_dtype} differs from table dtype {tb.dtype}")
    return (tb.shape[1],) + group_lanes(tb.shape[1], tb.element_size())


def launch_parts(build, entry: str, tables: list, plan: dict, out: torch.Tensor,
                 unit: bool) -> int:
    """Run a static or mask pass over every part of `plan` through the
    gather core: one launch per gather_parts.MAX_PARTS parts, all on the
    current stream, of `entry` in the library `build()` loads (built after
    the checks pass). tables: [table] (K1/K2) or [h, ghosts] (K8), each laid
    out by `gather_table`. Returns the launches made."""
    ld, g, tiles = check_pass_tables(tables, plan, out, unit)
    _check(sum(t.shape[0] for t in tables) >= plan["n_src"],
           f"tables of {[t.shape[0] for t in tables]} rows, the plan reads "
           f"{plan['n_src']} source rows")
    lib = build()
    # each library names its entry `<name>_pass` and its error text `<name>_error_string`
    lib_fn, errors = getattr(lib, entry), getattr(lib, entry.replace("_pass", "_error_string"))
    stream = stream_handle(_device_index(out))
    launched = 0
    for desc, _, n_blocks, address in plan["parts"].layout(g):
        code = lib_fn(_device_index(out), _DTYPE_CODE[tables[0].dtype], int(unit),
                      *[t.data_ptr() for t in tables], ld, out.shape[1], g,
                      address, len(desc), n_blocks, tiles, out.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"{entry} ({'mask' if unit else 'static'}) launch failed: "
                               f"{errors(code).decode()} ({code})")
        launched += 1
    return launched


def _launch_pass(tb: torch.Tensor, plan: dict, out: torch.Tensor, unit: bool = False) -> int:
    """K1 (the plan's values) or K2 (unit=True, mask mode; no values read)
    over every part of `plan`, accumulating into `out` (which the caller
    zero-filled); tb is laid out by `gather_table` in the gather dtype.
    Raises on anything the kernel does not take. Returns the launches
    made (0 for a plan without output rows)."""
    global KERNEL_LAUNCHES, MASK_LAUNCHES
    launched = launch_parts(build_kernel, "hyb_pass", [tb], plan, out, unit)
    if unit:
        MASK_LAUNCHES += launched
    else:
        KERNEL_LAUNCHES += launched
    return launched


def _launch_dyn_pass(tb: torch.Tensor, plan: dict, val: torch.Tensor, out: torch.Tensor,
                     own: torch.Tensor | None = None, flat: torch.Tensor | None = None,
                     wslot: torch.Tensor | None = None) -> int:
    """K7 over every part of `plan`, accumulating into `out` (which the
    caller zero-filled): slot (r, j) weighs its row by val[s2e[r, j]], or by
    wslot (each slot's weight in tb's dtype, in flat slot order) where
    given. With `own` (a row per output row id, laid out as tb) it also
    writes each live slot's dot <tb[rows[r, j]], own[v]> into flat (f32, one
    entry per slot of the plan, in flat slot order). tb is laid out by
    `gather_table` in the gather dtype. Raises on anything the kernel does
    not take. Returns the launches made (0 for a plan without output
    rows)."""
    global DYN_LAUNCHES, DYN_T_LAUNCHES, DYN_DVAL_LAUNCHES
    ld, g, _ = check_pass_tables([tb], plan, out, unit=True)
    pt, s2e = plan["parts"], plan.get("s2e_flat")
    _check(s2e is not None, "dynamic mode needs a plan with slot->edge maps")
    _check(s2e.dtype == torch.int32 and s2e.shape == (pt.n_slots,),
           f"s2e {s2e.dtype} {tuple(s2e.shape)} for a plan of {pt.n_slots} slots")
    _check(val.dtype == torch.float32 and val.shape == (plan["n_edges"],),
           f"val dtype {val.dtype} / shape {tuple(val.shape)} (needs a float32 vector "
           f"of the plan's {plan['n_edges']} edges)")
    _check((own is None) == (flat is None), "own and flat go together")
    extra = [s2e, val]
    if own is not None:
        _check(own.dtype == tb.dtype and own.dim() == 2 and own.shape[1] == ld
               and own.shape[0] >= pt.out_rows,
               f"own dtype {own.dtype} / shape {tuple(own.shape)}: needs the table's dtype "
               f"{tb.dtype} and {ld} columns, a row per output row ({pt.out_rows})")
        _check(own.data_ptr() % 16 == 0, "own must be 16-byte aligned")
        _check(flat.dtype == torch.float32 and flat.shape == (pt.n_slots,),
               f"flat {flat.dtype} {tuple(flat.shape)} must be float32, one per slot "
               f"({pt.n_slots})")
        extra += [own, flat]
    if wslot is not None:
        _check(wslot.dtype == tb.dtype and wslot.shape == (pt.n_slots,),
               f"wslot {wslot.dtype} {tuple(wslot.shape)} must be {tb.dtype}, one per slot")
        extra.append(wslot)
    for t in extra:
        _check(t.device == tb.device, f"tensor on {t.device}, table on {tb.device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")
    _check(tb.shape[0] >= plan["n_src"],
           f"table of {tb.shape[0]} rows, the plan reads {plan['n_src']} source rows")
    lib = build_dyn_kernel()
    dot = own is not None
    stream = stream_handle(_device_index(out))
    launched = 0
    for desc, _, n_blocks, address in pt.layout(g):
        code = lib.dyn_pass(
            _device_index(out), _DTYPE_CODE[tb.dtype], int(dot), g, address, len(desc),
            n_blocks, tb.data_ptr(), own.data_ptr() if dot else None, ld, out.shape[1],
            s2e.data_ptr(), val.data_ptr(), wslot.data_ptr() if wslot is not None else None,
            own.shape[0] if dot else 0, out.data_ptr(), flat.data_ptr() if dot else None,
            stream)
        if code != 0:
            raise RuntimeError(f"dyn_pass launch failed: "
                               f"{lib.dyn_error_string(code).decode()} ({code})")
        launched += 1
    if dot:
        DYN_DVAL_LAUNCHES += launched
    elif plan.get("transposed"):
        DYN_T_LAUNCHES += launched
    else:
        DYN_LAUNCHES += launched
    return launched


def edge_ordered(s2e: np.ndarray, n_edges: int) -> bool:
    """Whether a slot->edge map (flat slot order, dead slots holding the
    sentinel n_edges) runs in the edges' order: at least half of its live
    slots read the edge after the previous live slot's. A plan over
    dst-sorted edges does (each slot row a run of one vertex's edges); its
    transposed plan, whose map is a permutation, does not."""
    live = s2e[s2e < n_edges]
    return 2 * int(np.count_nonzero(np.diff(live) == 1)) >= live.size - 1


def slot_weights(plan: dict, val: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each slot's weight in flat slot order, in `dtype`: val rounded to
    dtype through the plan's s2e, its pad slots reading a zero sentinel
    (val_ext_of's values, rounded before the gather, not after: the same
    values, half the bytes gathered in bf16)."""
    ext = torch.cat([val.to(dtype), torch.zeros(1, dtype=dtype, device=val.device)])
    return ext.index_select(0, plan["s2e_flat"])


def kernel_pass(name: str, table: torch.Tensor, plan: dict, num_out: int,
                gather_dtype: torch.dtype | None, mode: str,
                val: torch.Tensor | None = None, other: torch.Tensor | None = None):
    """A slot pass on the card, one launch over every part of the plan: K1
    (static), K2 (mask) or K7 (dynamic; with `other` also the fused SDDMM,
    returned as (out, dval)). The table must be a CUDA tensor; anything
    else raises. Returns (result, launches)."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dim() != 2 or table.shape[0] < plan["n_src"]:
        raise ValueError(f"{name}: table {tuple(table.shape)} has fewer "
                         f"than the plan's {plan['n_src']} source rows")
    dt = gather_dtype if _is_narrow(gather_dtype) else torch.float32
    out = torch.zeros((num_out, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    tb = gather_table(table, dt)
    if mode != "dynamic":
        return out, _launch_pass(tb, plan, out, mode == "mask")
    n_edges = plan.get("n_edges")
    if val is None or val.shape != (n_edges,):
        raise ValueError(f"{name}: val {None if val is None else tuple(val.shape)} "
                         f"needs one value per edge ({n_edges})")
    val32 = val.float().contiguous()
    own = flat = None
    if other is not None:
        if other.dim() != 2 or other.shape[0] < num_out:
            raise ValueError(f"{name}: other {tuple(other.shape)} has fewer "
                             f"than the pass's {num_out} output rows")
        own = gather_table(other, dt)
        flat = torch.empty(plan["parts"].n_slots, dtype=torch.float32, device=table.device)
    # A slot's weight. Where the plan's s2e runs in edge order, the kernel
    # reads val through it (0.04 ms over K1's loop); where it scatters (a
    # transposed plan's permutation), those reads cost 0.28-0.32 ms inside
    # the kernel, and gathering the values into slot order first costs 0.16
    # outside it (H100, Reddit graph, bf16 F=128; in f32 the gather wins too,
    # PERF.md §6)
    wslot = None if plan["s2e_in_order"] else slot_weights(plan, val32, dt)
    launched = _launch_dyn_pass(tb, plan, val32, out, own, flat, wslot)
    if other is None:
        return out, launched
    # dval in edge order (a degree plan names its e2s edge_to_slot)
    e2s = plan["e2s"] if "e2s" in plan else plan["edge_to_slot"]
    return (out, flat.index_select(0, e2s[:n_edges])), launched


_PASS_NAMES = {"static": "hyb_static_pass", "mask": "hyb_mask_pass",
               "dynamic": "hyb_dynamic_pass"}


def _hyb_pass(table: torch.Tensor, plan: dict, num_out: int,
              gather_dtype: torch.dtype | None, mode: str,
              val: torch.Tensor | None = None, other: torch.Tensor | None = None):
    if table.device.type == "cpu":
        return _hyb_pass_plain(table, plan, num_out, gather_dtype, mode, val, other)
    result, _ = kernel_pass(_PASS_NAMES[mode], table, plan, num_out, gather_dtype, mode, val,
                            other)
    return result


def hyb_static_pass(table: torch.Tensor, plan: dict, num_out: int,
                    gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The static-mode pass -> (num_out, F) f32. CPU tensors run the plain
    version; CUDA tensors run K1 (one launch over the plan's parts) or
    raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, "static")


def hyb_mask_pass(table: torch.Tensor, plan: dict, num_out: int,
                  gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The mask-mode (unit-weight) pass -> (num_out, F) f32. CPU tensors
    run the plain version; CUDA tensors run K2 (one launch over the plan's
    parts) or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, "mask")


def hyb_dynamic_pass(table: torch.Tensor, plan: dict, num_out: int,
                     val: torch.Tensor, gather_dtype: torch.dtype | None = None,
                     other: torch.Tensor | None = None):
    """The dynamic-mode pass -> (num_out, F) f32, or (out, dval) with
    `other` (the fused SDDMM). CPU tensors run the plain version; CUDA
    tensors run K7 (one launch over the plan's parts) or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, "dynamic", val, other)


# ---- op + autograd ----


def plan_bytes(plan: dict) -> int:
    """Device bytes of an uploaded plan's tensors (views of one storage
    counted once)."""
    seen, total = set(), 0
    stack = [plan]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def _plan_attrs(plan: dict) -> dict:
    """The hyb.plan span's attributes: the plan's buckets and hub rows."""
    top = plan["top"]
    return {"buckets": len(plan["buckets"]),
            "hub_rows": 0 if top is None else len(top["rowv"])}


def _upload(plan: dict, n_src: int, vals_dtype: torch.dtype,
            device: torch.device, n_edges: int | None = None,
            transposed: bool = False) -> dict:
    """numpy plan -> torch tensors on `device`; `vals` only where the plan
    has them (mask plans have none). Adds `n_src` (rows the gather table
    must have), for the hub top `row_ptr` (each hub's run of chunk rows;
    rowv is ascending), `parts`, the kernels' descriptor table of the
    buckets and the top (ops/gather_parts.py), which checks every part
    once, and `transposed` (the backward plan), which says only which
    counter K7's dh alone goes to (DYN_T_LAUNCHES, not DYN_LAUNCHES).

    n_edges given (a dynamic op): the slot->edge maps ship too: `s2e_flat`,
    every part's s2e in flat slot order (the parts in plan order, each
    row-major: the order of the plan's e2s and of the descriptors' slot0),
    int32, which K7 reads, with each part's `s2e` a view of it for the
    plain version, `s2e_in_order` (see edge_ordered), and the plan's `e2s`
    (int32), through which both pull dval back into edge order. Otherwise
    both maps are dropped."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    dynamic = n_edges is not None

    def part(p):
        out = {"rows": t(p["rows"], torch.int32), "cnt": t(p["cnt"], torch.int32),
               "v": t(p["v"], torch.int32)}
        if "vals" in p:
            out["vals"] = t(p["vals"], torch.float32).to(vals_dtype)
        return out

    out = {"buckets": tuple(part(b) for b in plan["buckets"]), "top": None,
           "n_src": n_src, "transposed": transposed}
    top = plan["top"]
    if top is not None:
        n_hubs = len(top["v"])
        row_ptr = np.searchsorted(top["rowv"], np.arange(n_hubs + 1))
        out["top"] = dict(part(top), rowv=t(top["rowv"], torch.int64),
                          row_ptr=t(row_ptr, torch.int32))
    parts = list(out["buckets"]) + ([out["top"]] if top is not None else [])
    out["parts"] = PartTable(parts)
    if "_n_iso" in plan:
        out["n_iso"] = int(plan["_n_iso"])
    else:
        out["inv"] = t(plan["inv"], torch.int64)
    if dynamic:
        np_parts = list(plan["buckets"]) + ([top] if top is not None else [])
        flat_np = np.concatenate([p["s2e"].ravel() for p in np_parts] + [np.zeros(0, np.int32)])
        flat = t(flat_np, torch.int32)
        off = 0
        for pd, p in zip(parts, np_parts):
            pd["s2e"] = flat[off:off + p["s2e"].size].view(p["s2e"].shape)
            off += p["s2e"].size
        out["s2e_flat"] = flat
        out["s2e_in_order"] = edge_ordered(flat_np, n_edges)
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
    sums in f32.

    The build records the spans hyb.check, hyb.transpose_order, hyb.plan
    for fwd then bwd (attributes: direction, buckets, hub_rows) and
    hyb.upload for fwd then bwd, and the gauges hyb.edges, hyb.slots.<direction> (the plan's
    slots, padding included) and hyb.plan_bytes.<direction> (its device
    bytes).

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu"."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype: torch.dtype | None = None,
                 static_val=None, lam_slots: int = _LAMBDA_SLOTS,
                 dynamic: bool = False, device: str | torch.device | None = None):
        device = resolve_device(device)
        src = np.asarray(src)
        dst = np.asarray(dst)
        e = len(src)
        with span("hyb.check", edges=e):
            if e and (np.diff(dst) < 0).any():
                raise ValueError("edges must be dst-sorted")
            if e and (src.min() < 0 or src.max() >= num_in
                      or dst.min() < 0 or dst.max() >= num_out):
                raise ValueError("edge endpoint out of range")
        with span("hyb.transpose_order", edges=e):
            order = np.argsort(src, kind="stable")
        self.num_in, self.num_out = num_in, num_out
        self.gather_dtype = gather_dtype
        self.has_static_vals = static_val is not None
        self.dynamic = dynamic
        self.device = torch.device(device)
        with span("hyb.plan", direction="fwd") as sp:
            fwd = build_hyb_plan(src, dst, None, num_out, max_width, lam_slots,
                                 static_val)
            sp.attrs.update(_plan_attrs(fwd))
        with span("hyb.plan", direction="bwd") as sp:
            bwd = build_hyb_plan(dst[order], src[order], order, num_in,
                                 max_width, lam_slots, static_val)
            sp.attrs.update(_plan_attrs(bwd))
        gauge("hyb.edges", e)
        gauge("hyb.slots.fwd", fwd["n_slots"])
        gauge("hyb.slots.bwd", bwd["n_slots"])
        # Narrow mode multiplies in the table dtype: ship the static values
        # pre-cast (one rounding, half the bytes), as the JAX op does.
        vals_dtype = gather_dtype if _is_narrow(gather_dtype) else torch.float32
        n_edges = e if dynamic else None
        # n_src: the rows each pass's gather table must have (max index + 1).
        with span("hyb.upload", direction="fwd"):
            self.fwd = _upload(fwd, int(src.max()) + 1 if e else 0, vals_dtype,
                               self.device, n_edges)
        with span("hyb.upload", direction="bwd"):
            self.bwd = _upload(bwd, int(dst.max()) + 1 if e else 0, vals_dtype,
                               self.device, n_edges, transposed=True)
        gauge("hyb.plan_bytes.fwd", plan_bytes(self.fwd))
        gauge("hyb.plan_bytes.bwd", plan_bytes(self.bwd))

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
