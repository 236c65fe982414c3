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

Two implementations of the pass, on the same plan layout:
  * `hyb_static_pass_plain` / `hyb_mask_pass_plain` — plain torch, a
    line-for-line port of `_hyb_pass` / `_reduce_part` (gather -> weight
    multiply -> f32 row sum, hub chunks summed per hub, output placed
    through `_n_iso` or `inv`). They are the CPU path and the reference
    for the kernels.
  * the CUDA kernels in csrc/hyb_spmm.cu (K1 static, K2 mask), built with
    nvcc at first use and bound with ctypes (ops/cuda_build.py).

`hyb_static_pass` and `hyb_mask_pass` dispatch on the table's device: a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises. There is no fallback from a kernel to its plain version.

The dynamic mode (per-edge values through the slot->edge maps) is not
ported; the engines never build it (ROADMAP.md queue 2 item 3).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan

# Kernel launches made by this process, one per plan part: K1 (static
# mode) and K2 (mask mode). chip_smoke.py resets them before the main
# path and reads them after.
KERNEL_LAUNCHES = 0
MASK_LAUNCHES = 0

_CSRC = cuda_build.CSRC / "hyb_spmm.cu"
_lib: ctypes.CDLL | None = None
# Filled by build_kernel(): library path, build seconds (0 when the
# library for this source was already built), nvcc's -Xptxas -v output.
BUILD_INFO: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _is_narrow(gather_dtype) -> bool:
    return gather_dtype is not None and gather_dtype.itemsize < 4


# ---- plain torch version (CPU path and kernel reference) ----


def _reduce_part_plain(tb: torch.Tensor, part: dict, narrow: bool,
                       unit: bool) -> torch.Tensor:
    """gather -> weight multiply -> f32 sum over the slot axis for one
    bucket or top part; (rows, F) f32. Narrow tables multiply in their own
    dtype (bf16 products) and sum in f32, as the JAX narrow mode does.
    unit: mask-mode weights (1 on the live prefix, 0 on pads)."""
    msgs = tb[part["rows"]]
    if not narrow:
        msgs = msgs.float()
    if unit:
        w = part["rows"].shape[1]
        wt = (torch.arange(w, device=tb.device)[None, :]
              < part["cnt"][:, None]).to(msgs.dtype)
    else:
        wt = part["vals"].to(msgs.dtype)
    return (msgs * wt[..., None]).sum(dim=1, dtype=torch.float32)


def _hyb_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                    gather_dtype: torch.dtype | None, unit: bool) -> torch.Tensor:
    narrow = _is_narrow(gather_dtype)
    tb = table if gather_dtype is None else table.to(gather_dtype)
    f = table.shape[1]
    dev = table.device
    outs = [_reduce_part_plain(tb, b, narrow, unit) for b in plan["buckets"]]
    top = plan["top"]
    if top is not None:
        part = _reduce_part_plain(tb, top, narrow, unit)
        outs.append(torch.zeros((top["v"].shape[0], f), dtype=torch.float32,
                                device=dev).index_add_(0, top["rowv"], part))
    if "n_iso" in plan:
        n_iso = plan["n_iso"]
        pieces = ([torch.zeros((n_iso, f), dtype=torch.float32, device=dev)]
                  if n_iso else []) + outs
        return (torch.cat(pieces) if pieces
                else torch.zeros((num_out, f), dtype=torch.float32, device=dev))
    cat = torch.cat(outs + [torch.zeros((1, f), dtype=torch.float32, device=dev)])
    return cat[plan["inv"]]


def hyb_static_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                          gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[v] = sum over v's slots of vals * table[rows] -> (num_out, F) f32.

    Works on tensors of any device; `hyb_static_pass` routes only CPU
    tensors here."""
    return _hyb_pass_plain(table, plan, num_out, gather_dtype, unit=False)


def hyb_mask_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                        gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[v] = sum over v's live slots of table[rows] -> (num_out, F) f32
    (plans with or without values; the values are not read)."""
    return _hyb_pass_plain(table, plan, num_out, gather_dtype, unit=True)


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


def _launch_part(tb: torch.Tensor, part: dict, out: torch.Tensor,
                 unit: bool = False) -> None:
    """Launch the kernel for one plan part, accumulating its rows into
    `out` (which the caller zero-filled): K1 with the part's values, or K2
    (unit=True, mask mode; no values read). Validates everything the
    kernel assumes and raises on anything it does not take."""
    global KERNEL_LAUNCHES, MASK_LAUNCHES
    rows, cnt, out_idx = part["rows"], part["cnt"], part["v"]
    vals = None if unit else part.get("vals")
    row_ptr = part.get("row_ptr")
    _check(tb.is_cuda, f"table must be a CUDA tensor, got {tb.device}")
    _check(tb.dtype in _DTYPE_CODE,
           f"table dtype {tb.dtype} (kernel takes float32 or bfloat16)")
    _check(unit or vals is not None, "static mode needs a plan with values")
    _check(vals is None or vals.dtype == tb.dtype,
           f"vals dtype {None if vals is None else vals.dtype} differs from "
           f"table dtype {tb.dtype}")
    _check(out.dtype == torch.float32, f"out dtype {out.dtype} (needs float32)")
    _check(tb.dim() == 2 and out.dim() == 2 and out.shape[1] == tb.shape[1],
           f"table {tuple(tb.shape)} / out {tuple(out.shape)} widths differ")
    ints = [rows, cnt, out_idx] + ([row_ptr] if row_ptr is not None else [])
    _check(all(t.dtype == torch.int32 for t in ints), "plan indices must be int32")
    for t in ints + [tb, out] + ([vals] if vals is not None else []):
        _check(t.device == tb.device, f"tensor on {t.device}, table on {tb.device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")
    _check(rows.dim() == 2 and cnt.shape == (rows.shape[0],)
           and (vals is None or vals.shape == rows.shape),
           f"rows {tuple(rows.shape)} / cnt {tuple(cnt.shape)} / vals "
           f"{None if vals is None else tuple(vals.shape)} disagree")
    n_out = out_idx.shape[0]
    if row_ptr is None:
        _check(n_out == rows.shape[0], "bucket needs one slot row per output row")
    else:
        _check(row_ptr.shape == (n_out + 1,), "row_ptr must have n_out + 1 entries")
    if n_out == 0:
        return
    lib = build_kernel()
    dev = tb.device.index if tb.device.index is not None else torch.cuda.current_device()
    code = lib.hyb_part(
        dev, _DTYPE_CODE[tb.dtype], tb.data_ptr(), tb.shape[1],
        rows.data_ptr(), vals.data_ptr() if vals is not None else None,
        cnt.data_ptr(), rows.shape[1],
        row_ptr.data_ptr() if row_ptr is not None else None,
        out_idx.data_ptr(), n_out, out.data_ptr(),
        torch.cuda.current_stream(tb.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"hyb_part ({'mask' if unit else 'static'}) launch "
                           f"failed: {lib.hyb_error_string(code).decode()} ({code})")
    if unit:
        MASK_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1


def _hyb_pass(table: torch.Tensor, plan: dict, num_out: int,
              gather_dtype: torch.dtype | None, unit: bool) -> torch.Tensor:
    if table.device.type == "cpu":
        return _hyb_pass_plain(table, plan, num_out, gather_dtype, unit)
    name = "hyb_mask_pass" if unit else "hyb_static_pass"
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dim() != 2 or table.shape[0] < plan["n_src"]:
        raise ValueError(f"{name}: table {tuple(table.shape)} has fewer "
                         f"than the plan's {plan['n_src']} source rows")
    tb = table.to(gather_dtype if _is_narrow(gather_dtype) else torch.float32)
    tb = tb.contiguous()
    out = torch.zeros((num_out, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    parts = list(plan["buckets"]) + ([plan["top"]] if plan["top"] is not None else [])
    for part in parts:
        _launch_part(tb, part, out, unit)
    return out


def hyb_static_pass(table: torch.Tensor, plan: dict, num_out: int,
                    gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The static-mode pass -> (num_out, F) f32. CPU tensors run the plain
    version; CUDA tensors run K1 (one launch per plan part) or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, unit=False)


def hyb_mask_pass(table: torch.Tensor, plan: dict, num_out: int,
                  gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The mask-mode (unit-weight) pass -> (num_out, F) f32. CPU tensors
    run the plain version; CUDA tensors run K2 (one launch per plan part)
    or raise."""
    return _hyb_pass(table, plan, num_out, gather_dtype, unit=True)


# ---- op + autograd ----


def _upload(plan: dict, n_src: int, vals_dtype: torch.dtype,
            device: torch.device) -> dict:
    """numpy plan -> torch tensors on `device` (the slot->edge maps are
    dropped; `vals` only where the plan has them: mask plans have none).
    Adds `n_src` (rows the gather table must have) and, for the hub top,
    `row_ptr` (each hub's run of chunk rows; rowv is ascending)."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def part(p):
        out = {"rows": t(p["rows"], torch.int32), "cnt": t(p["cnt"], torch.int32),
               "v": t(p["v"], torch.int32)}
        if "vals" in p:
            out["vals"] = t(p["vals"], torch.float32).to(vals_dtype)
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
    return out


class HybStaticFn(torch.autograd.Function):
    """Differentiable static-mode aggregation (JAX: hyb_spmm_static_apply
    with its custom VJP). Backward is the pass over the transposed plan
    with gout, cut to h's rows and cast to h's dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, op: "HybSpMM") -> torch.Tensor:
        ctx.op = op
        ctx.h_rows, ctx.h_dtype = h.shape[0], h.dtype
        return hyb_static_pass(h, op.fwd, op.num_out, op.gather_dtype)

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        dh = hyb_static_pass(gout.contiguous(), op.bwd, op.num_in, op.gather_dtype)
        return dh[: ctx.h_rows].to(ctx.h_dtype), None


class HybUnitFn(torch.autograd.Function):
    """out[v] = sum_{u->v} h[u] (JAX: hyb_spmm_unit_apply). Backward is
    the unit pass over the transposed plan, cut to h's rows and cast to
    h's dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, op: "HybSpMM") -> torch.Tensor:
        ctx.op = op
        ctx.h_rows, ctx.h_dtype = h.shape[0], h.dtype
        return hyb_mask_pass(h, op.fwd, op.num_out, op.gather_dtype)

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        dh = hyb_mask_pass(gout.contiguous(), op.bwd, op.num_in, op.gather_dtype)
        return dh[: ctx.h_rows].to(ctx.h_dtype), None


class HybDstFn(torch.autograd.Function):
    """out[v] = dst_val[v] * sum_{u->v} h[u] (JAX: hyb_spmm_dst_apply),
    f32. Backward: dh = unit pass over the transposed plan of
    gout * dst_val (scaled in f32, then rounded by the pass), cut to h's
    rows and cast to h's dtype; d_dst = rowsum(u * gout) in f32, with u
    the unscaled forward output."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, dst_val: torch.Tensor,
                op: "HybSpMM") -> torch.Tensor:
        u = hyb_mask_pass(h, op.fwd, op.num_out, op.gather_dtype)
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
            dh = hyb_mask_pass(gscaled, op.bwd, op.num_in, op.gather_dtype)
            dh = dh[: ctx.h_rows].to(ctx.h_dtype)
        if ctx.needs_input_grad[1]:
            d_dst = (u * gout).sum(-1).to(dst_val.dtype)
        return dh, d_dst, None


class HybSpMM:
    """Hybrid-ELL SpMM over one sparsity pattern (JAX: ops/hyb_spmm.HybSpMM
    built with dynamic=False). Both plans are built on the host once and
    live on `device` as tensors.

    static_val given: static mode (`apply_static`, GCN norms baked in);
    None: mask plans without values (`apply_unit`, `apply_dst`, GAT). The
    mask-mode entries also run on a plan with values (they read only cnt).

    num_in may exceed h's rows (tables with extra rows); dh is cut to h's
    rows. gather_dtype: None/float32 gathers f32 tables;
    bfloat16 gathers bf16 tables (with bf16-precast static values) and
    sums in f32."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype: torch.dtype | None = None,
                 static_val=None, lam_slots: int = _LAMBDA_SLOTS,
                 dynamic: bool = False, device: str | torch.device = "cpu"):
        if dynamic:
            raise NotImplementedError(
                "HybSpMM dynamic mode (per-edge values through the slot->"
                "edge maps): ROADMAP.md queue 2 item 3")
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
        self.device = torch.device(device)
        fwd = build_hyb_plan(src, dst, None, num_out, max_width, lam_slots,
                             static_val)
        bwd = build_hyb_plan(dst[order], src[order], order, num_in,
                             max_width, lam_slots, static_val)
        # Narrow mode multiplies in the table dtype: ship the static values
        # pre-cast (one rounding, half the bytes), as the JAX op does.
        vals_dtype = gather_dtype if _is_narrow(gather_dtype) else torch.float32
        # n_src: the rows each pass's gather table must have (max index + 1).
        self.fwd = _upload(fwd, int(src.max()) + 1 if e else 0, vals_dtype,
                           self.device)
        self.bwd = _upload(bwd, int(dst.max()) + 1 if e else 0, vals_dtype,
                           self.device)

    def apply_static(self, h: torch.Tensor) -> torch.Tensor:
        if not self.has_static_vals:
            raise RuntimeError("op built without static values: use "
                               "apply_unit / apply_dst")
        return HybStaticFn.apply(h, self)

    def apply_unit(self, h: torch.Tensor) -> torch.Tensor:
        return HybUnitFn.apply(h, self)

    def apply_dst(self, h: torch.Tensor, dst_val: torch.Tensor) -> torch.Tensor:
        return HybDstFn.apply(h, dst_val, self)
