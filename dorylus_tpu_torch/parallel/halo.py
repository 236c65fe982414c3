"""Halo (ghost vertex) exchange as one all-to-all per layer (port of
dorylus_tpu/parallel/halo.py).

Each rank owns one vertex shard. Per layer it

  1. packs the rows each peer needs from it:  buf = h[send rows]     (K9)
  2. exchanges them: `all_to_all_single` over the process group
  3. holds the received rows in the padded ghost layout (n * max_h, F),
     owner q's block at offset q * max_h, which is what the edge source
     indices of graph/partition.py address (vp + q * max_h + rank).

The backward sends the ghost gradients back the way they came and reduces
them per local row with a sorted segment-sum over the host-built
(order, rows) plan, in f32, cast to h's dtype (K10): a local row repeats
when several peers needed it.

Two wire formats (TrainConfig.halo), into the same ghost layout:

  * "padded": every (rank, peer) pair ships max_h rows (equal splits); the
    received buffer is the ghost table as it lands. The send slots past a
    pair's exact count ship zero rows and take no part in the backward (no
    edge reads them, so what JAX adds into row 0 for them is zero).
  * "ragged" (and "auto"): each pair ships its EXACT row count through
    `input_split_sizes` / `output_split_sizes`, the reference's exact
    per-destination scatter (gcn_ops.cpp:204-260); K9 then places the
    received rows through a host-built slot map, and the slots past a
    pair's exact count stay zero. JAX's counterpart is `ragged_halo_recv`.

One `torch.autograd.Function` (`HaloRecvFn`) is the counterpart of both
`_halo_recv_planned` and `ragged_halo_recv`. Collectives are entered by
every rank in the same order, a rank with nothing to send included (size
0), in the backward as in the forward.

K9 (row gather) and K10 (gathered sorted segment-sum) are CUDA kernels
(ops/csrc/halo.cu), each with a plain torch version beside it that the CPU
path and the tests use. `row_gather` and `segsum_gather` dispatch on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from dorylus_tpu_torch.graph.partition import Shard, build_recv_plan
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.parallel import multihost

# Kernel launches made by this process: K9 and K10.
PACK_LAUNCHES = 0
HALO_BWD_LAUNCHES = 0

_CSRC = cuda_build.CSRC / "halo.cu"
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---- plain torch versions (CPU path and kernel reference) ----


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = x[idx[i]] where idx[i] >= 0, else a zero row."""
    rows = x.index_select(0, idx.clamp(min=0).long())
    return torch.where((idx >= 0)[:, None], rows, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


def segsum_gather_plain(g: torch.Tensor, order: torch.Tensor, rows: torch.Tensor,
                        num_rows: int) -> torch.Tensor:
    """out[r] = sum of float(g[order[j]]) over the j with rows[j] == r
    (rows ascending) -> (num_rows, F) f32."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, rows.long(), g.index_select(0, order.long()).float())


# ---- CUDA kernels: build, bind, launch ----


def build_kernel() -> ctypes.CDLL:
    """Build csrc/halo.cu for sm_90a (once per source content) and load
    it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.halo_row_gather.argtypes = [ci, vp, ci, vp, ci, vp, vp]
    lib.halo_row_gather.restype = ci
    lib.halo_segsum.argtypes = [ci, ci, vp, ci, vp, vp, ci, vp, vp]
    lib.halo_segsum.restype = ci
    lib.halo_error_string.argtypes = [ci]
    lib.halo_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"halo kernel: {msg}")


def _check_common(x: torch.Tensor, ints: list, out: torch.Tensor) -> None:
    _check(x.is_cuda, f"input must be a CUDA tensor, got {x.device}")
    _check(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (kernel takes float32 or bfloat16)")
    _check(x.dim() == 2 and out.dim() == 2 and out.shape[1] == x.shape[1],
           f"input {tuple(x.shape)} / out {tuple(out.shape)} widths differ")
    _check(all(t.dtype == torch.int32 and t.dim() == 1 for t in ints),
           "indices must be int32 vectors")
    for t in ints + [x, out]:
        _check(t.device == x.device, f"tensor on {t.device}, input on {x.device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")


def _dev_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _launch_row_gather(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> bool:
    """Launch K9: out[i] = idx[i] >= 0 ? x[idx[i]] : 0. Validates what the
    kernel assumes and raises on anything it does not take. Returns
    whether it launched (no output rows: nothing to launch)."""
    global PACK_LAUNCHES
    _check_common(x, [idx], out)
    _check(out.dtype == x.dtype, f"out dtype {out.dtype} differs from {x.dtype}")
    _check(out.shape[0] == idx.shape[0], "one index per output row")
    _check(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
           "buffers must be 16-byte aligned")
    if out.shape[0] == 0:
        return False
    _check(x.shape[0] > 0, "gather from an empty table")
    lib = build_kernel()
    code = lib.halo_row_gather(
        _dev_index(x), x.data_ptr(), x.shape[1] * x.element_size(), idx.data_ptr(),
        out.shape[0], out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"halo_row_gather launch failed: "
                           f"{lib.halo_error_string(code).decode()} ({code})")
    PACK_LAUNCHES += 1
    return True


def _launch_segsum(g: torch.Tensor, order: torch.Tensor, row_ptr: torch.Tensor,
                   out: torch.Tensor) -> bool:
    """Launch K10: out[r] = sum_{j in [row_ptr[r], row_ptr[r+1])}
    float(g[order[j]]); every row of out is written."""
    global HALO_BWD_LAUNCHES
    _check_common(g, [order, row_ptr], out)
    _check(out.dtype == torch.float32, f"out dtype {out.dtype} (needs float32)")
    _check(row_ptr.shape[0] == out.shape[0] + 1, "row_ptr must have rows + 1 entries")
    if out.shape[0] == 0:
        return False
    lib = build_kernel()
    code = lib.halo_segsum(
        _dev_index(g), _DTYPE_CODE[g.dtype], g.data_ptr(), g.shape[1], order.data_ptr(),
        row_ptr.data_ptr(), out.shape[0], out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"halo_segsum launch failed: "
                           f"{lib.halo_error_string(code).decode()} ({code})")
    HALO_BWD_LAUNCHES += 1
    return True


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9 -> (len(idx), F) in x's dtype. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty((idx.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    _launch_row_gather(x, idx, out)
    return out


def segsum_gather(g: torch.Tensor, order: torch.Tensor, rows: torch.Tensor,
                  row_ptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K10 -> (num_rows, F) f32. `rows` (the sorted local row of each
    order entry) serves the plain version, `row_ptr` (its run offsets) the
    kernel. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if g.device.type == "cpu":
        return segsum_gather_plain(g, order, rows, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"segsum_gather: unsupported device {g.device}")
    g = g.contiguous()
    out = torch.empty((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    _launch_segsum(g, order, row_ptr, out)
    return out


# ---- host-side plans ----


def ghost_counts(shard: Shard, n: int, vp: int, max_h: int) -> np.ndarray:
    """(n,) exact ghost rows this shard receives from each owner. Ghost
    ranks are dense [0, cnt) per owner block by construction
    (graph/partition.py), so cnt = max rank + 1."""
    src = np.asarray(shard.src[: shard.num_edges])
    gsrc = src[src >= vp].astype(np.int64) - vp
    mx = np.full(n, -1, np.int64)
    np.maximum.at(mx, gsrc // max_h, gsrc % max_h)
    return mx + 1


class HaloPlan:
    """One rank's exchange plan, built on the host once and kept on
    `device`: the pack indices, the split sizes (host int lists, as the
    collective wants them), the exact wire's slot maps, and the backward's
    (order, rows, row_ptr) over the live send slots: a local row's run
    holds one entry per peer that needs it.

    wire: "padded" or "ragged". counts: (send_cnt, recv_cnt), each (n,)
    exact rows per peer; None derives recv_cnt from the shard's ghost
    ranks and learns send_cnt from the peers through one all-to-all of the
    counts (every rank must then build its plan at the same point)."""

    def __init__(self, shard: Shard, n: int, wire: str = "ragged",
                 device: str | torch.device = "cpu",
                 counts: Optional[tuple[np.ndarray, np.ndarray]] = None):
        if wire not in ("padded", "ragged"):
            raise ValueError(f"halo wire {wire!r}: \"padded\" or \"ragged\"")
        send_idx = np.asarray(shard.send_idx)
        if send_idx.shape[0] != n:
            raise ValueError(f"send lists for {send_idx.shape[0]} peers, group of {n}")
        self.n, self.max_h = n, int(send_idx.shape[1])
        self.vp = int(shard.x.shape[0])
        self.wire = wire
        self.device = torch.device(device)
        mh, vp = self.max_h, self.vp
        if counts is None:
            recv_cnt = ghost_counts(shard, n, vp, mh)
            sent = multihost.all_to_all_rows(
                torch.tensor(recv_cnt, device=self.device)[:, None], [1] * n, [1] * n)
            send_cnt = sent[:, 0].cpu().numpy()
        else:
            send_cnt, recv_cnt = (np.asarray(c, np.int64) for c in counts)
        self.send_cnt, self.recv_cnt = send_cnt, recv_cnt
        if wire == "padded":
            # pad slots: -1, a zero row on the wire and no entry in the backward
            pack = np.where(np.arange(mh)[None, :] < send_cnt[:, None], send_idx, -1).ravel()
            self.in_splits = self.out_splits = [mh] * n
            place = unplace = None
        else:
            pack = (np.concatenate([send_idx[p][: send_cnt[p]] for p in range(n)])
                    if n else np.zeros(0, np.int32))
            self.in_splits = [int(c) for c in send_cnt]
            self.out_splits = [int(c) for c in recv_cnt]
            recv_off = np.zeros(n, np.int64)
            np.cumsum(recv_cnt[:-1], out=recv_off[1:])
            slot = np.arange(mh)[None, :]
            place = np.where(slot < recv_cnt[:, None], recv_off[:, None] + slot, -1).ravel()
            unplace = np.concatenate(
                [q * mh + np.arange(recv_cnt[q]) for q in range(n)]) if n else place
        order, rows = build_recv_plan(pack)
        live = rows >= 0  # the pad slots sort first
        order, rows = order[live], rows[live]
        row_ptr = np.searchsorted(rows, np.arange(vp + 1))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

        self.pack, self.order, self.rows, self.row_ptr = t(pack), t(order), t(rows), t(row_ptr)
        self.place = None if place is None else t(place)
        self.unplace = None if unplace is None else t(unplace)

    def wire_rows(self, me: int) -> int:
        """Rows this rank puts on the wire per exchange (its own block
        never leaves the rank)."""
        return sum(c for p, c in enumerate(self.in_splits) if p != me)


class HaloRecvFn(torch.autograd.Function):
    """Ghost rows (n * max_h, F) of h over the process group, on either
    wire (JAX: `_halo_recv_planned` and `ragged_halo_recv` with their
    custom VJPs)."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
        ctx.plan, ctx.h_dtype = plan, h.dtype
        buf = row_gather(h, plan.pack)
        recv = multihost.all_to_all_rows(buf, plan.in_splits, plan.out_splits)
        return recv if plan.place is None else row_gather(recv, plan.place)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        plan = ctx.plan
        g = g.contiguous()
        # The return trip: each received block goes back to its owner
        # (the split lists swap roles), then the sorted segment-sum adds
        # up, per local row, what its receivers returned.
        gsend = g if plan.unplace is None else row_gather(g, plan.unplace)
        back = multihost.all_to_all_rows(gsend, plan.out_splits, plan.in_splits)
        dh = segsum_gather(back, plan.order, plan.rows, plan.row_ptr, plan.vp)
        return dh.to(ctx.h_dtype), None


def halo_recv(h: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """Ghost rows only: (n * max_h, F) in h's dtype. Used by the overlap
    path, whose pure buckets need no ghost row."""
    return HaloRecvFn.apply(h, plan)


def halo_exchange(h: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """The feature table (vp + n * max_h, F): local rows, then the ghosts
    grouped by owner. Every rank of the group must call it."""
    return torch.cat([h, halo_recv(h, plan)], dim=0)


def make_halo_fn(plan: Optional[HaloPlan], overlap: bool,
                 multi: bool) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The halo callable the models take (JAX: `make_halo_fn`):
    overlap=True returns ghost rows only (`halo_recv`), else the full
    feature table. None when single-shard."""
    if not multi:
        return None
    if overlap:
        return lambda h: halo_recv(h, plan)
    return lambda h: halo_exchange(h, plan)
