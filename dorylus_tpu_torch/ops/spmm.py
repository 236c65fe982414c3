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
    own `t_row_ptr` and `t_col = dst[order]`, for the backward, and its
    inverse `inv_order`.

Kernels (csrc/edge_spmm.cu, built with nvcc at first use, ops/cuda_build;
K3 and K4 are the CSR team of the gather core, csrc/gather_pass.cuh):
  K3 `csr_spmm`       forward over the dst CSR; dh over the src CSR,
                      reading val through `order` inside the kernel (no
                      per-call permuted copy of val);
  K3 + K4 `csr_spmm_dval`  dh and dval in one pass over the src CSR, when
                      both h and val need gradients (GAT attention): the
                      gout rows it gathers for dh also give each edge's dot
                      with the row's own h, kept in registers; the pass
                      writes dval in the src CSR's order, coalesced, and one
                      gather by `inv_order` puts it in the edges' order;
  K4 `sddmm`          dval alone over the dst CSR, when only val needs a
                      gradient (GCN norms need none);
  K5 `segment_sum`    take_sorted's backward, (E,) and (E, F) cotangents;
                      its forward x[idx] is a plain `index_select`.
K3 and K4 read their tables laid out by `gather_table` (rows padded to a
multiple of 16 bytes; an aligned f32 or bf16 table of aligned width is used
as it is). Each has a plain torch version beside it (the CPU path and the
kernel's reference; the fused one is the two composed). The dispatchers
take the plain version for CPU tensors only; on a CUDA tensor they launch
the kernel or raise.

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
import functools

import numpy as np
import torch

from dorylus_tpu_torch.common.device import resolve_device, stream_handle
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.gather_parts import csr_geometry, gather_table

# Kernel launches made by this process, each launch counted once.
# chip_smoke.py resets them before a main path and reads them after.
SPMM_LAUNCHES = 0  # K3 without a permutation: the forward
SPMM_T_LAUNCHES = 0  # K3 through a permutation: dh alone
SPMM_DVAL_LAUNCHES = 0  # K3's dh pass with K4's dval in the same launch
SDDMM_LAUNCHES = 0  # K4 alone
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


def csr_spmm_dval_plain(gout: torch.Tensor, h: torch.Tensor, t_row_ptr: torch.Tensor,
                        t_col: torch.Tensor, val: torch.Tensor, order: torch.Tensor,
                        inv_order: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's dh and K4's dval composed, over the src CSR: (dh, dval) with
    dh[s] = sum_{e' in row s} val[order[e']] * gout[t_col[e']] -> (rows, F)
    f32 and dval[order[e']] = <gout[t_col[e']], h[s]> -> (E,) f32 (inv_order:
    the inverse of order)."""
    dh = csr_spmm_plain(gout, t_row_ptr, t_col, val, order)
    return dh, sddmm_plain(gout, h, t_row_ptr, t_col)[inv_order.long()]


def segment_sum_plain(g: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_{e in row r} g[e] -> (rows,) or (rows, F) f32."""
    out = torch.zeros((row_ptr.shape[0] - 1,) + tuple(g.shape[1:]),
                      dtype=torch.float32, device=g.device)
    return out.index_add_(0, _rows_of(row_ptr), g.float())


# ---- K5's (E,) launch geometry, and the pass walked as the kernel runs it ----

SEGSUM_WARPS = 8  # warps of a K5 block (edge_spmm.cu kWarpsPerBlock)
HUB_CHUNKS = 128  # a row of more chunks is the warp's (edge_spmm.cu kHubChunks)


@functools.lru_cache(maxsize=256)
def segment_sum_geometry(n_rows: int, n_edges: int, itemsize: int) -> tuple[int, int]:
    """(team, blocks) of K5's (E,) pass (edge_spmm.cu
    `segment_sum_team_kernel`): lanes a row, so that the team's 16-byte
    loads (16 / itemsize elements a lane) cover about half the mean row a
    step, a power of two in 4..32 (Reddit, 50 edges a row in f32: 8); one
    team a row, 256 / team rows a block."""
    per_lane = 16 // itemsize
    want = -(-n_edges // max(n_rows, 1)) // (2 * per_lane)
    team = min(32, max(4, 1 << max(want - 1, 0).bit_length()))
    return team, -(-n_rows // (32 * SEGSUM_WARPS // team))


def walk_segment_sum(g: torch.Tensor, row_ptr: torch.Tensor, head: int = 0) -> tuple:
    """K5's (E,) pass computed team by team as `segment_sum_team_kernel`
    runs it, in plain torch: g's elements in 16-byte chunks counted from
    `head` elements before g (g's offset from a 16-byte boundary), lane j
    of a team on chunks j, j + team, ..., two a step, its elements of the
    row summed in order, the lanes added by the butterfly; a row of more
    than HUB_CHUNKS chunks by the warp's 32 lanes. Returns (out (rows,) f32,
    writes per row, chunks read element by element (reaching past g's
    ends), the hub rows)."""
    n_rows, n_el = row_ptr.shape[0] - 1, g.shape[0]
    v = 16 // g.element_size()
    team, blocks = segment_sum_geometry(n_rows, n_el, g.element_size())
    gf = g.float()
    out = torch.zeros(n_rows)
    writes = torch.zeros(n_rows, dtype=torch.int64)
    scalar, hubs = set(), []
    rp = row_ptr.long().tolist()

    def chunk_sum(c, b, e):
        lo = c * v - head
        if not (lo >= 0 and lo + v <= n_el):
            scalar.add(c)
        acc = torch.zeros((), dtype=torch.float32)
        for k in range(v):
            if b <= lo + k < e:
                acc = acc + gf[lo + k]
        return acc

    def lanes(b, e, n):
        acc = [torch.zeros((), dtype=torch.float32) for _ in range(n)]
        if b < e:
            c_lo, c_hi = (b + head) // v, (e - 1 + head) // v
            for tl in range(n):
                for c in range(c_lo + tl, c_hi + 1, 2 * n):
                    a0 = chunk_sum(c, b, e)
                    a1 = chunk_sum(c + n, b, e) if c + n <= c_hi else torch.zeros(())
                    acc[tl] = acc[tl] + a0
                    acc[tl] = acc[tl] + a1
        o = n // 2
        while o:  # the butterfly: lane tl adds lane tl ^ o
            acc = [acc[tl] + acc[tl ^ o] for tl in range(n)]
            o //= 2
        return acc[0]

    for r in range(min(n_rows, blocks * 32 * SEGSUM_WARPS // team)):
        b, e = rp[r], rp[r + 1]
        if team < 32 and e > b and (e - 1 + head) // v - (b + head) // v >= HUB_CHUNKS:
            hubs.append(r)
            out[r] = lanes(b, e, 32)
        else:
            out[r] = lanes(b, e, team)
        writes[r] += 1
    return out, writes, scalar, hubs


# ---- CUDA kernels: build, bind, launch ----


def build_kernel() -> ctypes.CDLL:
    """Build csrc/edge_spmm.cu for sm_90a (once per source content) and
    load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.edge_csr_pass.argtypes = [ci] * 6 + [vp, vp, ci, ci] + [vp] * 4 + [ci, ci] + [vp] * 3
    lib.edge_segment_sum.argtypes = [ci, ci, vp, ci, ctypes.c_longlong, vp, ci, ci, vp, vp]
    for fn in (lib.edge_csr_pass, lib.edge_segment_sum):
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
    return stream_handle(_dev_index(dev))


def _launch_csr(name: str, mode: int, tab, own, row_ptr, col, val, perm, out, dval) -> None:
    """One CSR pass of the gather core (mode 1: K3's sum into out, 2: K4's
    dot into dval, 3: both); tab and own laid out by `gather_table`."""
    dev = tab.device
    _check_launch(name, [tab] + ([own] if own is not None else []),
                  [col] + ([perm] if perm is not None else []), row_ptr, dev)
    vec = 16 // tab.element_size()
    ld, n_rows, e = tab.shape[1], row_ptr.shape[0] - 1, col.shape[0]
    for t in [tab] + ([own] if own is not None else []):
        _check(t.dim() == 2 and t.shape[1] == ld and ld % vec == 0 and t.data_ptr() % 16 == 0,
               f"{name}: tables {tuple(t.shape)} / {tuple(tab.shape)} must share rows of a "
               f"multiple of 16 bytes, 16-byte aligned (gather_table)")
    _check(own is None or (own.shape[0] == n_rows if mode == 2 else own.shape[0] <= n_rows),
           f"{name}: {tuple(own.shape) if own is not None else ()} own rows for {n_rows} "
           f"CSR rows (K4 alone: one a row; fused: the rows past them have no edges)")
    _check(perm is None or perm.shape == col.shape, f"{name}: col / perm lengths differ")
    for t, what in ((val, "val"), (dval, "dval")):
        if t is not None:
            _check(t.dtype == torch.float32 and t.is_contiguous() and t.device == dev
                   and t.shape == col.shape,
                   f"{name}: {what} must be contiguous float32 of one entry per edge")
    f = ld
    if out is not None:
        f = out.shape[1] if out.dim() == 2 else -1
        _check(out.dtype == torch.float32 and out.is_contiguous() and out.device == dev
               and out.shape[0] == n_rows and ld - vec < f <= ld,
               f"{name}: out {tuple(out.shape)} {out.dtype} for {n_rows} rows of a "
               f"table of width {ld}")
    geo = csr_geometry(ld, tab.element_size(), n_rows, e, dot=mode != 1)
    lib = build_kernel()

    def ptr(t):
        return t.data_ptr() if t is not None else None

    code = lib.edge_csr_pass(
        _dev_index(dev), _DTYPE_CODE[tab.dtype], mode, geo["g"], int(geo["r"] > 1),
        geo["blocks"], tab.data_ptr(), ptr(own), ld, f, row_ptr.data_ptr(),
        col.data_ptr(), ptr(val), ptr(perm), n_rows, own.shape[0] if own is not None else 0,
        ptr(out), ptr(dval), _stream(dev))
    _raise_on(lib, f"edge_csr_pass ({name})", code)


def _launch_csr_spmm(table, row_ptr, col, val, perm, out) -> None:
    """K3: out (rows, F) f32 from a `gather_table` layout of the table."""
    global SPMM_LAUNCHES, SPMM_T_LAUNCHES
    _launch_csr("csr_spmm", 1, table, None, row_ptr, col, val, perm, out, None)
    if perm is None:
        SPMM_LAUNCHES += 1
    else:
        SPMM_T_LAUNCHES += 1


def _launch_sddmm(h, g, row_ptr, col, dval) -> None:
    """K4 alone: dval (E,) f32; h gathered, g the rows' own (registers)."""
    global SDDMM_LAUNCHES
    _launch_csr("sddmm", 2, h, g, row_ptr, col, None, None, None, dval)
    SDDMM_LAUNCHES += 1


def _launch_csr_spmm_dval(gout, h, t_row_ptr, t_col, val, order, out, dval) -> None:
    """K3's dh pass over the src CSR with K4's dval in the same launch:
    gout gathered, h the rows' own (its rows past h's have no edges); dval
    in the src CSR's edge order."""
    global SPMM_DVAL_LAUNCHES
    _launch_csr("csr_spmm_dval", 3, gout, h, t_row_ptr, t_col, val, order, out, dval)
    SPMM_DVAL_LAUNCHES += 1


def _launch_segment_sum(g, row_ptr, out) -> None:
    """Launch K5 on g (E,) or (E, F) over a CSR's row_ptr. Checks per call
    what a call can change (devices, dtypes, shapes, contiguity) in one
    expression, and explains a failure only then; row_ptr's values are
    checked where the CSR is built (`EdgeSpMM`)."""
    global SEGSUM_LAUNCHES
    di = g.get_device()
    n_rows = row_ptr.shape[0] - 1
    if not (di >= 0 and g.dtype in _DTYPE_CODE and row_ptr.dtype == torch.int32
            and out.dtype == torch.float32 and g.dim() in (1, 2) and row_ptr.dim() == 1
            and row_ptr.get_device() == di and out.get_device() == di
            and g.is_contiguous() and row_ptr.is_contiguous() and out.is_contiguous()
            and out.shape == (n_rows,) + tuple(g.shape[1:])):
        _check_launch("segment_sum", [g], [], row_ptr, g.device)
        _check(g.dim() in (1, 2), f"segment_sum: g has {g.dim()} dims")
        _check(False, f"segment_sum: out {tuple(out.shape)} {out.dtype} on {out.device}")
    f = g.shape[1] if g.dim() == 2 else 1
    team, _ = segment_sum_geometry(n_rows, g.shape[0], g.element_size())
    lib = _lib or build_kernel()
    code = lib.edge_segment_sum(di, _DTYPE_CODE[g.dtype], g.data_ptr(), f, g.shape[0],
                                row_ptr.data_ptr(), n_rows, team, out.data_ptr(),
                                stream_handle(di))
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
    _launch_csr_spmm(gather_table(table, table.dtype), row_ptr, col, val.float(), perm, out)
    return out


def sddmm(h: torch.Tensor, g: torch.Tensor, row_ptr: torch.Tensor,
          col: torch.Tensor) -> torch.Tensor:
    """K4 -> (E,) f32."""
    if _device_of("sddmm", h) == "cpu":
        return sddmm_plain(h, g, row_ptr, col)
    dval = torch.empty(col.shape, dtype=torch.float32, device=h.device)
    _launch_sddmm(gather_table(h, h.dtype), gather_table(g, g.dtype), row_ptr, col, dval)
    return dval


def csr_spmm_dval(gout: torch.Tensor, h: torch.Tensor, t_row_ptr: torch.Tensor,
                  t_col: torch.Tensor, val: torch.Tensor, order: torch.Tensor,
                  inv_order: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's dh with K4's dval in one pass over the src CSR -> (dh (rows, F)
    f32, dval (E,) f32 in the edges' order)."""
    if _device_of("csr_spmm_dval", gout) == "cpu":
        return csr_spmm_dval_plain(gout, h, t_row_ptr, t_col, val, order, inv_order)
    out = torch.empty((t_row_ptr.shape[0] - 1, gout.shape[1]), dtype=torch.float32,
                      device=gout.device)
    dval = torch.empty(t_col.shape, dtype=torch.float32, device=gout.device)
    _launch_csr_spmm_dval(gather_table(gout, gout.dtype), gather_table(h, h.dtype), t_row_ptr,
                          t_col, val.float(), order, out, dval)
    return out, dval.index_select(0, inv_order)


def segment_sum(g: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """K5 -> (rows,) or (rows, F) f32. CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    if g.is_cuda:
        out = g.new_empty((row_ptr.shape[0] - 1,) + tuple(g.shape[1:]), dtype=torch.float32)
        _launch_segment_sum(g, row_ptr, out)
        return out
    _device_of("segment_sum", g)
    return segment_sum_plain(g, row_ptr)


# ---- op + autograd ----


class EdgeSpMM:
    """The CSR structures of one dst-sorted edge list, built on the host
    once and kept on `device`. The edge arrays themselves stay with the
    caller (the batch's src/dst): the op checks their lengths at each call.

    num_in: rows of the gather table (dh has as many before it is cut to
    h's rows); num_out: output rows.

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu"."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 device: str | torch.device | None = None):
        device = resolve_device(device)
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

        # built from the checked edges, so each rises from 0 to e: the
        # launchers take them as they are, call after call
        self.row_ptr = ptr(dst, num_out)
        self.order = self._t(order)
        inv = np.empty_like(order)
        inv[order] = np.arange(e)
        self.inv_order = self._t(inv)
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
    CSR (K3); dval in the same pass when h needs a gradient too, else by K4
    alone."""

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
        need_h, need_val = ctx.needs_input_grad[:2]
        if need_h and need_val:
            dh, dval = csr_spmm_dval(gout, h.contiguous(), op.t_row_ptr, op.t_col, val,
                                     op.order, op.inv_order)
        elif need_h:
            dh = csr_spmm(gout, op.t_row_ptr, op.t_col, val, op.order)
        elif need_val:
            dval = sddmm(h.contiguous(), gout, op.row_ptr, src)
        if dh is not None:
            dh = dh[: h.shape[0]].to(h.dtype)
        if dval is not None:
            dval = dval.to(val.dtype)
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
