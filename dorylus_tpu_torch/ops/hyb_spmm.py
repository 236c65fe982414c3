"""Hybrid-ELL SpMM, static mode — the port of dorylus_tpu/ops/hyb_spmm.py.

The GCN main path aggregates with construction-time edge values (the GCN
norms baked into the plan): forward is one pass over the forward plan,
backward is the same pass over the transposed plan (JAX:
`hyb_spmm_static_apply` and `_static_bwd`).

Two implementations of the pass, on the same plan layout:
  * `hyb_static_pass_plain` — plain torch, a line-for-line port of
    `_hyb_pass` / `_reduce_part` (gather -> weight multiply -> f32 row sum,
    hub chunks summed per hub, output placed through `_n_iso` or `inv`).
    It is the CPU path and the reference for the kernel.
  * the CUDA kernel in csrc/hyb_spmm.cu, built with nvcc at first use into
    dorylus_tpu_torch/_build/ and bound with ctypes.

`hyb_static_pass` dispatches on the table's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. There is no
fallback from the kernel to the plain version.

The mask and dynamic modes (GAT, per-edge values) are not ported yet; see
ROADMAP.md.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan

# Number of kernel launches made by this process (one per plan part).
# chip_smoke.py resets it before the main path and reads it after.
KERNEL_LAUNCHES = 0

_CSRC = Path(__file__).resolve().parent / "csrc" / "hyb_spmm.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lib: ctypes.CDLL | None = None
# Filled by build_kernel(): library path, build seconds (0 when the
# library for this source was already built), nvcc's -Xptxas -v output.
BUILD_INFO: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _is_narrow(gather_dtype) -> bool:
    return gather_dtype is not None and gather_dtype.itemsize < 4


# ---- plain torch version (CPU path and kernel reference) ----


def _reduce_part_plain(tb: torch.Tensor, part: dict, narrow: bool) -> torch.Tensor:
    """gather -> weight multiply -> f32 sum over the slot axis for one
    bucket or top part; (rows, F) f32. Narrow tables multiply in their own
    dtype (bf16 products) and sum in f32, as the JAX narrow mode does."""
    msgs = tb[part["rows"]]
    if not narrow:
        msgs = msgs.float()
    wt = part["vals"].to(msgs.dtype)
    return (msgs * wt[..., None]).sum(dim=1, dtype=torch.float32)


def hyb_static_pass_plain(table: torch.Tensor, plan: dict, num_out: int,
                          gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[v] = sum over v's slots of vals * table[rows] -> (num_out, F) f32.

    Works on tensors of any device; `hyb_static_pass` routes only CPU
    tensors here."""
    narrow = _is_narrow(gather_dtype)
    tb = table if gather_dtype is None else table.to(gather_dtype)
    f = table.shape[1]
    dev = table.device
    outs = [_reduce_part_plain(tb, b, narrow) for b in plan["buckets"]]
    top = plan["top"]
    if top is not None:
        part = _reduce_part_plain(tb, top, narrow)
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


# ---- CUDA kernel: build, bind, launch ----


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the hybrid-"
                       "ELL CUDA kernel cannot be built")


def build_kernel() -> ctypes.CDLL:
    """Build csrc/hyb_spmm.cu for sm_90a (once per source content) and
    load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    src = _CSRC.read_bytes()
    so = _BUILD_DIR / f"libhyb_spmm_{hashlib.sha256(src).hexdigest()[:16]}.so"
    seconds, log_text = 0.0, ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_CSRC)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        log_text = res.stdout + res.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hyb_static_part.argtypes = [ci, ci, vp, ci, vp, vp, vp, ci, vp, vp,
                                    ci, vp, vp]
    lib.hyb_static_part.restype = ci
    lib.hyb_error_string.argtypes = [ci]
    lib.hyb_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(path=str(so), seconds=seconds, log=log_text)
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hyb_static_pass kernel: {msg}")


def _launch_part(tb: torch.Tensor, part: dict, out: torch.Tensor) -> None:
    """Launch the kernel for one plan part, accumulating its rows into
    `out` (which the caller zero-filled). Validates everything the kernel
    assumes and raises on anything it does not take."""
    global KERNEL_LAUNCHES
    rows, vals, cnt, out_idx = part["rows"], part["vals"], part["cnt"], part["v"]
    row_ptr = part.get("row_ptr")
    _check(tb.is_cuda, f"table must be a CUDA tensor, got {tb.device}")
    _check(tb.dtype in _DTYPE_CODE,
           f"table dtype {tb.dtype} (kernel takes float32 or bfloat16)")
    _check(vals.dtype == tb.dtype,
           f"vals dtype {vals.dtype} differs from table dtype {tb.dtype}")
    _check(out.dtype == torch.float32, f"out dtype {out.dtype} (needs float32)")
    _check(tb.dim() == 2 and out.dim() == 2 and out.shape[1] == tb.shape[1],
           f"table {tuple(tb.shape)} / out {tuple(out.shape)} widths differ")
    ints = [rows, cnt, out_idx] + ([row_ptr] if row_ptr is not None else [])
    _check(all(t.dtype == torch.int32 for t in ints), "plan indices must be int32")
    for t in ints + [tb, vals, out]:
        _check(t.device == tb.device, f"tensor on {t.device}, table on {tb.device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")
    _check(rows.dim() == 2 and vals.shape == rows.shape
           and cnt.shape == (rows.shape[0],),
           f"rows {tuple(rows.shape)} / vals {tuple(vals.shape)} / cnt "
           f"{tuple(cnt.shape)} disagree")
    n_out = out_idx.shape[0]
    if row_ptr is None:
        _check(n_out == rows.shape[0], "bucket needs one slot row per output row")
    else:
        _check(row_ptr.shape == (n_out + 1,), "row_ptr must have n_out + 1 entries")
    if n_out == 0:
        return
    lib = build_kernel()
    dev = tb.device.index if tb.device.index is not None else torch.cuda.current_device()
    code = lib.hyb_static_part(
        dev, _DTYPE_CODE[tb.dtype], tb.data_ptr(), tb.shape[1],
        rows.data_ptr(), vals.data_ptr(), cnt.data_ptr(), rows.shape[1],
        row_ptr.data_ptr() if row_ptr is not None else None,
        out_idx.data_ptr(), n_out, out.data_ptr(),
        torch.cuda.current_stream(tb.device).cuda_stream)
    if code != 0:
        raise RuntimeError("hyb_static_part launch failed: "
                           f"{lib.hyb_error_string(code).decode()} ({code})")
    KERNEL_LAUNCHES += 1


def hyb_static_pass(table: torch.Tensor, plan: dict, num_out: int,
                    gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The static-mode pass -> (num_out, F) f32. CPU tensors run the plain
    version; CUDA tensors run the kernel (one launch per plan part) or
    raise."""
    if table.device.type == "cpu":
        return hyb_static_pass_plain(table, plan, num_out, gather_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"hyb_static_pass: unsupported device {table.device}")
    if table.dim() != 2 or table.shape[0] < plan["n_src"]:
        raise ValueError(f"hyb_static_pass: table {tuple(table.shape)} has fewer "
                         f"than the plan's {plan['n_src']} source rows")
    tb = table.to(gather_dtype if _is_narrow(gather_dtype) else torch.float32)
    tb = tb.contiguous()
    out = torch.zeros((num_out, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    parts = list(plan["buckets"]) + ([plan["top"]] if plan["top"] is not None else [])
    for part in parts:
        _launch_part(tb, part, out)
    return out


# ---- op + autograd ----


def _upload(plan: dict, n_src: int, vals_dtype: torch.dtype,
            device: torch.device) -> dict:
    """numpy plan -> torch tensors on `device` (static mode only: the
    slot->edge maps are dropped). Adds `n_src` (rows the gather table
    must have) and, for the hub top, `row_ptr` (each hub's run of chunk
    rows; rowv is ascending)."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def part(p):
        return {"rows": t(p["rows"], torch.int32), "cnt": t(p["cnt"], torch.int32),
                "vals": t(p["vals"], torch.float32).to(vals_dtype),
                "v": t(p["v"], torch.int32)}

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


class HybSpMM:
    """Static-mode hybrid-ELL SpMM over one sparsity pattern (JAX:
    ops/hyb_spmm.HybSpMM built with dynamic=False). Both plans are built
    on the host once and live on `device` as tensors.

    num_in may exceed h's rows (tables with extra rows); dh is cut to h's
    rows. gather_dtype: None/float32 gathers f32 tables;
    bfloat16 gathers bf16 tables with bf16-precast values and f32 sums."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype: torch.dtype | None = None,
                 static_val=None, lam_slots: int = _LAMBDA_SLOTS,
                 device: str | torch.device = "cpu"):
        if static_val is None:
            raise NotImplementedError(
                "HybSpMM without static values (mask/dynamic modes, GAT): "
                "ROADMAP.md queue 2 items 1 and 3")
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
        return HybStaticFn.apply(h, self)
