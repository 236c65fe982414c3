"""Pair-reuse aggregation — the port of dorylus_tpu/ops/reuse_spmm.py
(`kernel="hyb", reuse="pairs"`).

The miner (graph/reuse.py, the port's copy of the JAX package's) rewrites each
direction's edge list: a source pair (a, b) that many destinations share
becomes one appended table row h[a] + h[b], gathered once per destination
instead of twice. The aggregation is then the mask-mode hybrid-ELL pass over
the rewritten plan, whose gather table is h with the pair rows appended
level by level (`_build_table` + `reuse_unit_pass`). The rewrite is exact
for unit-weight inner sums, which both models have: GCN through its rank-1
norm factorization (edge value = f(src) f(dst), f = sqrt(self_norm)), GAT
through its destination-only attention.

Backward: the rewrite computes exactly the original operator A, so the VJP
is A^T, served by the transposed graph's own, independently mined rewrite
(its levels and plan are not the transposes of the forward ones). The pair
rows are built from gout in f32, and dh returns in h's dtype.

Two implementations of the table build, as for every kernel of the port:
  * `build_pair_table_plain` — plain torch, a port of `_build_table`
    (concatenate tbl[p0] + tbl[p1] per level); the CPU path and the
    reference for the kernel;
  * `build_pair_table` on a CUDA tensor — K6 (csrc/pair_build.cu): one
    (table_size, F) buffer allocated once, h copied into its first rows,
    one launch per level in stream order.
The table is built in h's own dtype (f32, or bf16 under compute_dtype
bf16) and cast to the gather dtype by the pass afterwards, as JAX does: a
pair row of an f32 table is bf16(a + b), not bf16(a) + bf16(b). The pass
itself is K2 (ops/hyb_spmm.py `hyb_mask_pass`).

The op need not be square: the forward is mined over (src -> dst) with the
pair ids starting at num_in (the table's rows) and planned over num_out
output rows, the backward over the transpose with base num_out and num_in
output rows. The sharded op (ops/reuse_sharded.py) is this op over a
shard's edges, with num_in = vp + n * max_h table rows and num_out = vp.

Not ported: `set_msgs_budget` (a TPU scan-chunk guard; ROADMAP.md "Not to
port").
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dorylus_tpu_torch import native
from dorylus_tpu_torch.common.device import resolve_device, stream_handle
from dorylus_tpu_torch.common.metrics import span
from dorylus_tpu_torch.graph.reuse import mine_reuse
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.hyb_plan import build_hyb_plan
from dorylus_tpu_torch.ops.hyb_spmm import _DTYPE_CODE, _upload, hyb_mask_pass

# K6 launches made by this process, one per mining level. chip_smoke.py
# resets it before a main path and reads it after.
PAIR_LAUNCHES = 0

_CSRC = cuda_build.CSRC / "pair_build.cu"
_lib: ctypes.CDLL | None = None
# Filled by build_kernel(): library path, build seconds, nvcc's output.
BUILD_INFO: dict = {}


def build_pair_table_plain(h: torch.Tensor, levels) -> torch.Tensor:
    """h with the pair rows of every level appended: (table_size, F) in
    h's dtype. Works on tensors of any device; `build_pair_table` routes
    only CPU tensors here."""
    tbl = h
    for p in levels:
        tbl = torch.cat([tbl, tbl[p[:, 0]] + tbl[p[:, 1]]])
    return tbl


def build_kernel() -> ctypes.CDLL:
    """Build csrc/pair_build.cu for sm_90a (once per source content) and
    load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pair_level.argtypes = [ci, ci, vp, ci, vp, ci, ctypes.c_longlong, vp]
    lib.pair_level.restype = ci
    lib.pair_error_string.argtypes = [ci]
    lib.pair_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pair-table kernel: {msg}")


def _launch_level(tbl: torch.Tensor, pairs: torch.Tensor, base: int) -> bool:
    """K6 for one level: tbl[base + i] = tbl[pairs[i, 0]] + tbl[pairs[i, 1]].
    Validates what the kernel assumes and raises on anything it does not
    take. Returns whether it launched."""
    global PAIR_LAUNCHES
    _check(tbl.is_cuda, f"table must be a CUDA tensor, got {tbl.device}")
    _check(tbl.dtype in _DTYPE_CODE,
           f"table dtype {tbl.dtype} (kernel takes float32 or bfloat16)")
    _check(tbl.dim() == 2 and tbl.is_contiguous(), "table must be a contiguous matrix")
    _check(pairs.dtype == torch.int32 and pairs.dim() == 2 and pairs.shape[1] == 2
           and pairs.is_contiguous(), "pairs must be a contiguous (P, 2) int32 tensor")
    _check(pairs.device == tbl.device, f"pairs on {pairs.device}, table on {tbl.device}")
    _check(base + pairs.shape[0] <= tbl.shape[0],
           f"level rows {base}..{base + pairs.shape[0]} exceed the table's "
           f"{tbl.shape[0]}")
    if pairs.shape[0] == 0:
        return False
    lib = build_kernel()
    dev = tbl.device.index if tbl.device.index is not None else torch.cuda.current_device()
    code = lib.pair_level(dev, _DTYPE_CODE[tbl.dtype], tbl.data_ptr(), tbl.shape[1],
                          pairs.data_ptr(), pairs.shape[0], base,
                          stream_handle(dev))
    if code != 0:
        raise RuntimeError(f"pair_level launch failed: "
                           f"{lib.pair_error_string(code).decode()} ({code})")
    PAIR_LAUNCHES += 1
    return True


def build_pair_table(h: torch.Tensor, levels, table_size: int) -> torch.Tensor:
    """h with the pair rows of every level appended, (table_size, F) in h's
    dtype. CPU tensors run the plain version; CUDA tensors run K6 (one
    launch per level into one preallocated buffer) or raise."""
    if h.device.type == "cpu":
        return build_pair_table_plain(h, levels)
    if h.device.type != "cuda":
        raise ValueError(f"build_pair_table: unsupported device {h.device}")
    _check(h.dtype in _DTYPE_CODE,
           f"table dtype {h.dtype} (kernel takes float32 or bfloat16)")
    tbl = torch.empty((table_size, h.shape[1]), dtype=h.dtype, device=h.device)
    tbl[: h.shape[0]].copy_(h)
    base = h.shape[0]
    for p in levels:
        _launch_level(tbl, p, base)
        base += p.shape[0]
    _check(base == table_size, f"levels fill {base} rows of a {table_size}-row table")
    return tbl


class ReuseUnitFn(torch.autograd.Function):
    """out[v] = sum_{u->v} h[u] over the rewritten forward plan (JAX:
    reuse_unit_pass). Backward: the pair table of gout in f32 over the
    backward levels, the unit pass over the backward plan, dh in h's
    dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, op: "ReuseSpMM") -> torch.Tensor:
        if h.shape[0] != op.num_in:
            # the pair ids start at num_in: a shorter table would shift them
            raise ValueError(f"reuse pass: table of {h.shape[0]} rows, the rewrite "
                             f"was mined over {op.num_in}")
        ctx.op = op
        ctx.h_dtype = h.dtype
        tbl = build_pair_table(h.contiguous(), op.lvl_fwd, op.fwd_table_size)
        return hyb_mask_pass(tbl, op.fwd, op.num_out, op.gather_dtype)

    @staticmethod
    def backward(ctx, gout: torch.Tensor):
        op = ctx.op
        tbl = build_pair_table(gout.float().contiguous(), op.lvl_bwd,
                               op.bwd_table_size)
        dh = hyb_mask_pass(tbl, op.bwd, op.num_in, op.gather_dtype)
        return dh.to(ctx.h_dtype), None


class ReuseSpMM:
    """Drop-in aggregation op (HybSpMM protocol) with pair reuse (JAX:
    ops/reuse_spmm.ReuseSpMM), over a (num_out, num_in) operator: the
    table has exactly num_in rows.

    rank1_factor: per-vertex f with edge value = f(src) f(dst) (GCN:
    sqrt(self_norm)); enables apply_static. One (V,) array for a square
    op, or the pair (f_in (num_in,), f_out (num_out,)) of the table rows'
    and the output rows' factors. None for unit / dst-weighted
    aggregation (GAT apply_dst). min_uses, passes, max_pairs go to the
    miner (max_pairs per pass, 0 = unlimited). After construction,
    `miner` names the miner that ran ("native" or "numpy"),
    `mine_seconds` holds the (forward, backward) mining times and
    `build_seconds` the whole build (both directions mined, both plans
    built and uploaded), read from the spans reuse.mine and reuse.build
    (common/metrics.py).

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu"."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype: torch.dtype | None = None,
                 rank1_factor=None, min_uses: int = 3,
                 passes: int = 1, max_pairs: int = 0,
                 device: str | torch.device | None = None):
        device = resolve_device(device)
        src = np.asarray(src)
        dst = np.asarray(dst)
        self.num_in, self.num_out = num_in, num_out
        self.gather_dtype = gather_dtype
        self.has_static_vals = rank1_factor is not None
        self.device = torch.device(device)
        self.miner = "native" if native.has_mine_pairs() else "numpy"
        with span("reuse.build", miner=self.miner) as build:
            # each direction's pair ids start past its own table's rows
            with span("reuse.mine", direction="fwd") as mine_fwd:
                fwd = mine_reuse(src, dst, num_in, min_uses=min_uses, passes=passes,
                                 max_pairs=max_pairs)
            with span("reuse.mine", direction="bwd") as mine_bwd:
                bwd = mine_reuse(dst, src, num_out, min_uses=min_uses, passes=passes,
                                 max_pairs=max_pairs)
            self.plan_fwd, self.plan_bwd = fwd, bwd
            self.rows_fwd = fwd.stats["rows_after"]
            # Mask plans over the rewritten lists: their sources index the
            # pair-augmented table, so each pass's gather table has
            # table_size rows, not V.
            pf = build_hyb_plan(fwd.src, fwd.dst, None, num_out, max_width)
            pb = build_hyb_plan(bwd.src, bwd.dst, None, num_in, max_width)
            self.fwd = _upload(pf, fwd.table_size, torch.float32, self.device)
            self.bwd = _upload(pb, bwd.table_size, torch.float32, self.device)
            self.fwd_table_size, self.bwd_table_size = fwd.table_size, bwd.table_size

            def levels(plan):
                return tuple(torch.from_numpy(np.ascontiguousarray(p, np.int32))
                             .to(self.device) for p in plan.levels)

            self.lvl_fwd, self.lvl_bwd = levels(fwd), levels(bwd)
        self.mine_seconds = (mine_fwd.seconds, mine_bwd.seconds)
        self.build_seconds = build.seconds
        self.f_in = self.f_out = None
        if rank1_factor is not None:
            f_in, f_out = (rank1_factor if isinstance(rank1_factor, (tuple, list))
                           else (rank1_factor, rank1_factor))
            self.f_in, self.f_out = (
                torch.tensor(np.asarray(f, np.float32), device=self.device)
                for f in (f_in, f_out))
            if self.f_in.shape != (num_in,) or self.f_out.shape != (num_out,):
                raise ValueError(f"rank1_factor {tuple(self.f_in.shape)} / "
                                 f"{tuple(self.f_out.shape)}: want ({num_in},) table "
                                 f"and ({num_out},) output factors")

    @property
    def num_pairs(self) -> int:
        """Pair rows the forward rewrite appends."""
        return self.plan_fwd.num_pairs

    def apply_static(self, h: torch.Tensor) -> torch.Tensor:
        """GCN factorized norms: diag(f_out) A_unit diag(f_in) h."""
        if self.f_in is None:
            raise RuntimeError("op built without rank1_factor: use apply_unit / apply_dst")
        u = ReuseUnitFn.apply(h * self.f_in.to(h.dtype)[:, None], self)
        return u * self.f_out.to(u.dtype)[:, None]

    def apply_dst(self, h: torch.Tensor, dst_val: torch.Tensor) -> torch.Tensor:
        """GAT dst-only attention: diag(dst_val) A_unit h."""
        u = ReuseUnitFn.apply(h, self)
        return u * dst_val.to(u.dtype)[:, None]

    def apply_unit(self, h: torch.Tensor) -> torch.Tensor:
        """Unit-weight aggregation."""
        return ReuseUnitFn.apply(h, self)

    def apply(self, h: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "pair reuse requires factorizable edge weights; dynamic per-edge "
            "values cannot ride a rewrite — use kernel='hyb'")
