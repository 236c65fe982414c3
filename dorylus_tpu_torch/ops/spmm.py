"""Edgewise aggregation over CSR — the port of dorylus_tpu/ops/spmm.py, the
path kernel="xla" runs (and "auto" up to 8M edges).

JAX forms `h[src] * val` and segment-sums it over the dst-sorted edges;
its backward comes from autodiff: dh is the same gather-scale-sum over the
transposed edges, and dval[e] = <h[src e], gout[dst e]>. `take_sorted`
gathers x[idx] for an ascending idx and sums its cotangent by sorted
segments. The port keeps those semantics and runs them over CSR
structures that `EdgeSpMM` builds once per graph on the host:
  * the dst CSR `row_ptr` (edge e belongs to row dst[e]);
  * the src-sorted permutation `order = argsort(src, stable)`, with its
    own `t_row_ptr` and `t_col = dst[order]`, for the backward.

Kernels (csrc/edge_spmm.cu, built with nvcc at first use, ops/cuda_build):
  K3 `csr_spmm`     forward over the dst CSR; dh over the src CSR, reading
                    val through `order` inside the kernel (no per-call
                    permuted copy of val);
  K4 `sddmm`        dval over the dst CSR, only when val needs a gradient
                    (GAT attention; GCN norms do not);
  K5 `segment_sum`  take_sorted's backward, (E,) and (E, F) cotangents; its
                    forward x[idx] is a plain `index_select`.
Each has a plain torch version beside it (the CPU path and the kernel's
reference). The dispatchers take the plain version for CPU tensors only;
on a CUDA tensor they launch the kernel or raise.

Numerics: products are formed in h's dtype (`h[src] * val.astype(h.dtype)`
in JAX: val is rounded to it and bf16 products are rounded to bf16); sums
run in f32 and the result is cast back to h's dtype. JAX's bf16
segment-sum accumulates in bf16 on the CPU
(tests/test_torch_port_edgewise.py measures it), so the port is the more
exact of the two there.

What is not ported, because the CSR kernels do not need it: the edge
chunking of `spmm_edgewise` (`edge_chunk` bounds a materialised (E, F)
message tensor on the TPU; it is accepted and ignored) and the dst
blocking of `spmm_dst_blocked` (it keeps a TPU segment-sum's output in
VMEM; `block_rows` is accepted and ignored, and the function runs the same
op as `spmm_edgewise`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dorylus_tpu_torch.ops import cuda_build

# Kernel launches made by this process. chip_smoke.py resets them before
# a main path and reads them after.
SPMM_LAUNCHES = 0  # K3
SDDMM_LAUNCHES = 0  # K4
SEGSUM_LAUNCHES = 0  # K5

_CSRC = cuda_build.CSRC / "edge_spmm.cu"
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rows_of(row_ptr: torch.Tensor) -> torch.Tensor:
    """The row of each CSR entry, (E,) int64."""
    n = row_ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())


# ---- plain torch versions (CPU path and kernel references) ----


def csr_spmm_plain(table: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
                   val: torch.Tensor, perm: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """out[r] = sum_{e in row r} val[perm[e]] * table[col[e]] -> (rows, F)
    f32, products in table's dtype."""
    v = val if perm is None else val[perm.long()]
    msgs = table[col.long()] * v.to(table.dtype)[:, None]
    out = torch.zeros((row_ptr.shape[0] - 1, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    return out.index_add_(0, _rows_of(row_ptr), msgs.float())


def sddmm_plain(h: torch.Tensor, g: torch.Tensor, row_ptr: torch.Tensor,
                col: torch.Tensor) -> torch.Tensor:
    """dval[e] = <h[col[e]], g[row of e]> -> (E,) f32."""
    return (h[col.long()].float() * g[_rows_of(row_ptr)].float()).sum(-1)


def segment_sum_plain(g: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_{e in row r} g[e] -> (rows,) or (rows, F) f32."""
    out = torch.zeros((row_ptr.shape[0] - 1,) + tuple(g.shape[1:]),
                      dtype=torch.float32, device=g.device)
    return out.index_add_(0, _rows_of(row_ptr), g.float())


# ---- CUDA kernels: build, bind, launch ----


def build_kernel() -> ctypes.CDLL:
    """Build csrc/edge_spmm.cu for sm_90a (once per source content) and
    load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.edge_csr_spmm.argtypes = [ci, ci, vp, ci, vp, vp, vp, vp, ci, vp, vp]
    lib.edge_sddmm.argtypes = [ci, ci, vp, vp, ci, vp, vp, ci, vp, vp]
    lib.edge_segment_sum.argtypes = [ci, ci, vp, ci, vp, ci, vp, vp]
    for fn in (lib.edge_csr_spmm, lib.edge_sddmm, lib.edge_segment_sum):
        fn.restype = ci
    lib.edge_error_string.argtypes = [ci]
    lib.edge_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edgewise kernel: {msg}")


def _check_launch(name: str, floats: list, ints: list, row_ptr: torch.Tensor,
                  dev: torch.device) -> None:
    """What every kernel assumes: CUDA tensors on one device, contiguous,
    float32/bfloat16 data of one dtype, int32 indices."""
    _check(dev.type == "cuda", f"{name}: tensors must be CUDA tensors, got {dev}")
    dt = floats[0].dtype
    _check(dt in _DTYPE_CODE, f"{name}: dtype {dt} (kernel takes float32 or bfloat16)")
    _check(all(t.dtype == dt for t in floats),
           f"{name}: dtypes {[t.dtype for t in floats]} differ")
    _check(all(t.dtype == torch.int32 for t in ints + [row_ptr]),
           f"{name}: CSR indices must be int32")
    for t in floats + ints + [row_ptr]:
        _check(t.device == dev, f"{name}: tensor on {t.device}, expected {dev}")
        _check(t.is_contiguous(), f"{name}: all tensors must be contiguous")


def _raise_on(lib, name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.edge_error_string(code).decode()} ({code})")


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_csr_spmm(table, row_ptr, col, val, perm, out) -> None:
    global SPMM_LAUNCHES
    dev = table.device
    _check_launch("csr_spmm", [table], [col] + ([perm] if perm is not None else []),
                  row_ptr, dev)
    _check(val.dtype == torch.float32 and val.is_contiguous()
           and val.device == dev, "csr_spmm: val must be contiguous float32")
    _check(out.dtype == torch.float32 and out.shape == (row_ptr.shape[0] - 1,
                                                        table.shape[1]),
           f"csr_spmm: out {tuple(out.shape)} {out.dtype}")
    _check(col.shape == val.shape and (perm is None or perm.shape == col.shape),
           "csr_spmm: col / val / perm lengths differ")
    lib = build_kernel()
    code = lib.edge_csr_spmm(
        _dev_index(dev), _DTYPE_CODE[table.dtype], table.data_ptr(), table.shape[1],
        row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
        perm.data_ptr() if perm is not None else None, out.shape[0],
        out.data_ptr(), _stream(dev))
    _raise_on(lib, "edge_csr_spmm", code)
    SPMM_LAUNCHES += 1


def _launch_sddmm(h, g, row_ptr, col, dval) -> None:
    global SDDMM_LAUNCHES
    dev = h.device
    _check_launch("sddmm", [h, g], [col], row_ptr, dev)
    _check(h.dim() == 2 and g.shape == (row_ptr.shape[0] - 1, h.shape[1]),
           f"sddmm: h {tuple(h.shape)} / g {tuple(g.shape)} disagree")
    _check(dval.dtype == torch.float32 and dval.shape == col.shape,
           "sddmm: dval must be float32 of one entry per edge")
    lib = build_kernel()
    code = lib.edge_sddmm(_dev_index(dev), _DTYPE_CODE[h.dtype], h.data_ptr(),
                          g.data_ptr(), h.shape[1], row_ptr.data_ptr(),
                          col.data_ptr(), g.shape[0], dval.data_ptr(), _stream(dev))
    _raise_on(lib, "edge_sddmm", code)
    SDDMM_LAUNCHES += 1


def _launch_segment_sum(g, row_ptr, out) -> None:
    global SEGSUM_LAUNCHES
    dev = g.device
    _check_launch("segment_sum", [g], [], row_ptr, dev)
    _check(g.dim() in (1, 2), f"segment_sum: g has {g.dim()} dims")
    _check(out.dtype == torch.float32
           and out.shape == (row_ptr.shape[0] - 1,) + tuple(g.shape[1:]),
           f"segment_sum: out {tuple(out.shape)} {out.dtype}")
    lib = build_kernel()
    code = lib.edge_segment_sum(
        _dev_index(dev), _DTYPE_CODE[g.dtype], g.data_ptr(),
        g.shape[1] if g.dim() == 2 else 1, row_ptr.data_ptr(), out.shape[0],
        out.data_ptr(), _stream(dev))
    _raise_on(lib, "edge_segment_sum", code)
    SEGSUM_LAUNCHES += 1


def _device_of(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def csr_spmm(table: torch.Tensor, row_ptr: torch.Tensor, col: torch.Tensor,
             val: torch.Tensor, perm: torch.Tensor | None = None) -> torch.Tensor:
    """K3 -> (rows, F) f32. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if _device_of("csr_spmm", table) == "cpu":
        return csr_spmm_plain(table, row_ptr, col, val, perm)
    out = torch.empty((row_ptr.shape[0] - 1, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    _launch_csr_spmm(table, row_ptr, col, val.float(), perm, out)
    return out


def sddmm(h: torch.Tensor, g: torch.Tensor, row_ptr: torch.Tensor,
          col: torch.Tensor) -> torch.Tensor:
    """K4 -> (E,) f32."""
    if _device_of("sddmm", h) == "cpu":
        return sddmm_plain(h, g, row_ptr, col)
    dval = torch.empty(col.shape, dtype=torch.float32, device=h.device)
    _launch_sddmm(h, g, row_ptr, col, dval)
    return dval


def segment_sum(g: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """K5 -> (rows,) or (rows, F) f32."""
    if _device_of("segment_sum", g) == "cpu":
        return segment_sum_plain(g, row_ptr)
    out = torch.empty((row_ptr.shape[0] - 1,) + tuple(g.shape[1:]),
                      dtype=torch.float32, device=g.device)
    _launch_segment_sum(g, row_ptr, out)
    return out


# ---- op + autograd ----


class EdgeSpMM:
    """The CSR structures of one dst-sorted edge list, built on the host
    once and kept on `device`. The edge arrays themselves stay with the
    caller (the batch's src/dst): the op checks their lengths at each call.

    num_in: rows of the gather table (dh has as many before it is cut to
    h's rows); num_out: output rows."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 device: str | torch.device = "cpu"):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        e = len(src)
        if len(dst) != e:
            raise ValueError("src and dst lengths differ")
        if e and (np.diff(dst) < 0).any():
            raise ValueError("edges must be dst-sorted")
        if e and (src.min() < 0 or src.max() >= num_in
                  or dst.min() < 0 or dst.max() >= num_out):
            raise ValueError("edge endpoint out of range")
        if e >= 2**31:
            raise ValueError(f"{e} edges: int32 CSR offsets hold < 2^31")
        self.num_in, self.num_out, self.num_edges = num_in, num_out, e
        self.device = torch.device(device)
        order = np.argsort(src, kind="stable")

        def ptr(idx, n):
            p = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(idx, minlength=n), out=p[1:])
            return self._t(p)

        self.row_ptr = ptr(dst, num_out)
        self.order = self._t(order)
        self.t_row_ptr = ptr(src, num_in)
        self.t_col = self._t(dst[order])

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int32)).to(self.device)

    def check_edges(self, *edge_arrays: torch.Tensor) -> None:
        for t in edge_arrays:
            if t.shape != (self.num_edges,):
                raise ValueError(f"edge array {tuple(t.shape)} does not match "
                                 f"the op's {self.num_edges} edges")


class EdgeSpMMFn(torch.autograd.Function):
    """out = segment_sum_dst(h[src] * val) in h's dtype; dh over the src
    CSR (K3), dval by K4 when val needs a gradient."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, val: torch.Tensor, src: torch.Tensor,
                op: EdgeSpMM) -> torch.Tensor:
        ctx.op = op
        ctx.save_for_backward(h, val, src)
        return csr_spmm(h.contiguous(), op.row_ptr, src, val).to(h.dtype)

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        h, val, src = ctx.saved_tensors
        gout = gout.contiguous()
        dh = dval = None
        if ctx.needs_input_grad[0]:
            dh = csr_spmm(gout, op.t_row_ptr, op.t_col, val, op.order)
            dh = dh[: h.shape[0]].to(h.dtype)
        if ctx.needs_input_grad[1]:
            dval = sddmm(h.contiguous(), gout, op.row_ptr, src).to(val.dtype)
        return dh, dval, None, None


class TakeSortedFn(torch.autograd.Function):
    """x[idx] (idx = the op's dst array); backward a sorted segment-sum
    in f32 (K5), cast to x's dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor, op: EdgeSpMM) -> torch.Tensor:
        ctx.op, ctx.x_dtype = op, x.dtype
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dx = segment_sum(g.contiguous(), ctx.op.row_ptr)
        return dx.to(ctx.x_dtype), None, None


def spmm_edgewise(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  edge_val: torch.Tensor, num_out: int, sorted_dst: bool = True,
                  edge_chunk: int = 0, *, op: EdgeSpMM) -> torch.Tensor:
    """out[v] = sum_{e: dst[e]=v} edge_val[e] * h[src[e]], in h's dtype.

    The edges must be dst-sorted (EdgeSpMM checks that on the host);
    sorted_dst=False raises. edge_chunk is accepted and ignored: no
    (E, F) message tensor exists to bound."""
    del edge_chunk
    if not sorted_dst:
        raise ValueError("spmm_edgewise: the CSR kernels need dst-sorted edges")
    if num_out != op.num_out:
        raise ValueError(f"num_out {num_out} != the op's {op.num_out}")
    op.check_edges(src, dst, edge_val)
    return EdgeSpMMFn.apply(h, edge_val, src, op)


def spmm_dst_blocked(h_table: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     val: torch.Tensor, num_out: int, block_rows: int, *,
                     op: EdgeSpMM) -> torch.Tensor:
    """JAX's dst-blocked SpMM (used past 400k vertices): the same sum as
    `spmm_edgewise`. Its blocking keeps a TPU segment-sum's output in VMEM;
    the CSR kernel has one writer per row at any size, so block_rows is
    accepted and ignored. val: the per-edge values (JAX's baked blk["val"]
    or val_flat)."""
    del block_rows
    return spmm_edgewise(h_table, src, dst, val, num_out, op=op)


def aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              edge_val: torch.Tensor, self_val: torch.Tensor,
              h_table: torch.Tensor | None = None, sorted_dst: bool = True,
              edge_chunk: int = 0, *, op: EdgeSpMM) -> torch.Tensor:
    """GCN aggregation: self_val * h + SpMM(edge_val, h_table)."""
    table = h if h_table is None else h_table
    out = spmm_edgewise(table, src, dst, edge_val, h.shape[0],
                        sorted_dst=sorted_dst, edge_chunk=edge_chunk, op=op)
    return out + h * self_val[:, None].to(h.dtype)


def take_sorted(x: torch.Tensor, idx: torch.Tensor, num_segments: int, *,
                op: EdgeSpMM) -> torch.Tensor:
    """x[idx] for x (N,) or (N, F) and idx the op's ascending dst array;
    the backward sums the cotangent over idx's runs (op.row_ptr)."""
    if num_segments != x.shape[0] or num_segments != op.num_out:
        raise ValueError(f"num_segments {num_segments}: x has {x.shape[0]} "
                         f"rows, the op {op.num_out}")
    op.check_edges(idx)
    return TakeSortedFn.apply(x, idx, op)
