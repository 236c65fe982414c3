"""Halo (ghost vertex) exchange as one all-to-all per layer (port of
dorylus_tpu/parallel/halo.py).

Each rank owns one vertex shard. Per layer it

  1. packs the rows each peer needs from it:  buf = h[send rows]     (K9)
  2. exchanges them: `all_to_all_single` over the graph shards' group (the
     world, or under tensor parallelism its graph group, parallel/mesh.py)
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

On the overlap plans both exchanges run in two steps, so that the rank's
work that does not read the rows runs while they are in flight (JAX leaves
that to XLA's scheduler, dorylus_tpu/parallel/train_step.py:14-15, across
the one jitted step; the reference's pipeline runs scatter beside compute):

  forward   `halo_start` packs (K9) and starts the all-to-all (parallel/
            multihost.py `all_to_all_rows_start`); `HaloRecvFn.apply(h, plan,
            pending, reverse)` finishes it and places the rows (K9);
  backward  HaloRecvFn's backward unplaces the ghost rows' cotangent (K9)
            and starts the reverse all-to-all (`ReverseExchange.start`);
            `HaloJoinFn`, applied to h where the forward started, finishes
            it in its own backward: the wait, K10, and the add into the
            gradient h's other consumers delivered (JAX: `_planned_bwd`,
            `_ragged_bwd`, whose only input is that cotangent).

Autograd runs the join's backward only once every consumer of its output
has delivered, HaloRecvFn's included, so the start precedes the finish on
every path; what autograd runs in between (the layer's interior backward,
the self term, GAT's attention gradient: models/gcn.py, models/gat.py)
runs beside the transfer. `make_halo_fn` returns a `Halo`: called, it does
the whole exchange both ways (the combined plan, tensor parallelism, the
profile's halo line, `predict`); its `start(h)` / `finish(pending)` serve
the overlap plans (`_aggregate_split`).

K9 (row gather) and K10 (gathered sorted segment-sum) are CUDA kernels
(ops/csrc/halo.cu), each with a plain torch version beside it that the CPU
path and the tests use. `row_gather` and `segsum_gather` dispatch on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dorylus_tpu_torch.common.device import resolve_device, stream_handle
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


# ---- K9's launch geometry, and the copy walked as the kernel runs it ----

THREADS = 256  # threads of a K9 block (halo.cu kThreads)
TEAM_ROWS = 4  # rows a team has in flight (halo.cu kRows)


class RowGatherGeometry(NamedTuple):
    unit: int  # bytes a lane moves at once: 16, 8, 4 or 2
    g: int  # lanes a team, one team an output row
    steps: int  # units a lane a row per column chunk
    blocks: int


@functools.lru_cache(maxsize=256)
def row_gather_geometry(row_bytes: int, n_out: int) -> RowGatherGeometry:
    """K9's launch for rows of row_bytes bytes: the widest unit of 16, 8, 4
    or 2 bytes that divides the row; lanes a team, the row's units rounded
    up to a power of two in 4..32; 2 units a lane a chunk for rows of more
    than 32 units; blocks enough for every team to hold TEAM_ROWS rows."""
    if row_bytes <= 0 or row_bytes % 2:
        raise ValueError(f"halo kernel: rows of {row_bytes} bytes (the kernel takes an even "
                         f"positive width)")
    unit = next(u for u in (16, 8, 4, 2) if row_bytes % u == 0)
    units = row_bytes // unit
    g = min(32, max(4, 1 << (units - 1).bit_length()))
    steps = 2 if units > 32 else 1
    rows_a_block = THREADS // g * TEAM_ROWS
    return RowGatherGeometry(unit, g, steps, max(1, -(-n_out // rows_a_block)))


def walk_row_gather(x: torch.Tensor, idx: torch.Tensor, geo: RowGatherGeometry) -> tuple:
    """K9 computed team by team as `row_gather_units` runs it, in numpy on
    the rows' bytes: each block's teams, each team's TEAM_ROWS rows a step,
    grid-stride, its lanes' units column chunk by column chunk. Returns
    (out, writes per output byte)."""
    n_out, f = idx.shape[0], x.shape[1]
    src_b = x.contiguous().view(torch.uint8).numpy().reshape(-1)
    rb, u = f * x.element_size(), geo.unit
    units = rb // u
    ids = idx.numpy()
    out = np.zeros(n_out * rb, np.uint8)
    writes = np.zeros(n_out * rb, np.int64)
    g, teams = geo.g, geo.blocks * (THREADS // geo.g)
    for team in range(teams):
        for r0 in range(team * TEAM_ROWS, n_out, teams * TEAM_ROWS):
            for r in range(r0, min(r0 + TEAM_ROWS, n_out)):
                s = int(ids[r])
                for c0 in range(0, units, g * geo.steps):
                    for lane in range(g):
                        for st in range(geo.steps):
                            c = c0 + st * g + lane
                            if c < units:
                                o = r * rb + c * u
                                out[o: o + u] = (src_b[s * rb + c * u: s * rb + (c + 1) * u]
                                                 if s >= 0 else 0)
                                writes[o: o + u] += 1
    dt = {torch.float32: np.float32, torch.bfloat16: np.uint16}[x.dtype]
    got = torch.from_numpy(out.view(dt).reshape(n_out, f).copy())
    if x.dtype == torch.bfloat16:
        got = got.view(torch.bfloat16)
    return got, writes.reshape(n_out, rb)


# ---- CUDA kernels: build, bind, launch ----


def build_kernel() -> ctypes.CDLL:
    """Build csrc/halo.cu for sm_90a (once per source content) and load
    it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.halo_row_gather.argtypes = [ci, vp, ci, vp, ci, vp, ci, ci, ci, ci, vp]
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


def _refuse(x: torch.Tensor, ints: list, out: torch.Tensor) -> None:
    """Raise with the reason a launcher's fast check failed (the common
    part: device, dtype, widths, int32 indices, one device, contiguity)."""
    _check(x.is_cuda, f"input must be a CUDA tensor, got {x.device}")
    _check(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (kernel takes float32 or bfloat16)")
    _check(x.dim() == 2 and out.dim() == 2 and out.shape[1] == x.shape[1],
           f"input {tuple(x.shape)} / out {tuple(out.shape)} widths differ")
    _check(all(t.dtype == torch.int32 and t.dim() == 1 for t in ints),
           "indices must be int32 vectors")
    for t in ints + [x, out]:
        _check(t.device == x.device, f"tensor on {t.device}, input on {x.device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")


def _launch_row_gather(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> bool:
    """Launch K9: out[i] = idx[i] >= 0 ? x[idx[i]] : 0. Checks per call
    what a call can change (devices, dtypes, shapes, contiguity,
    alignment) in one expression, and explains a failure only then; the
    index values are checked where the plan is built (`HaloPlan`).
    Returns whether it launched (no output rows: nothing to launch)."""
    global PACK_LAUNCHES
    di = x.get_device()
    n = out.shape[0]
    if not (di >= 0 and x.dtype in _DTYPE_CODE and out.dtype == x.dtype
            and idx.dtype == torch.int32 and x.dim() == 2 and out.dim() == 2
            and idx.dim() == 1 and out.shape[1] == x.shape[1] and idx.shape[0] == n
            and idx.get_device() == di and out.get_device() == di and x.is_contiguous()
            and out.is_contiguous() and idx.is_contiguous() and x.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0):
        _refuse(x, [idx], out)
        _check(out.dtype == x.dtype, f"out dtype {out.dtype} differs from {x.dtype}")
        _check(idx.shape[0] == n, "one index per output row")
        _check(False, "buffers must be 16-byte aligned")
    if n == 0:
        return False
    _check(x.shape[0] > 0, "gather from an empty table")
    lib = _lib or build_kernel()
    rb = x.shape[1] * x.element_size()
    geo = row_gather_geometry(rb, n)
    code = lib.halo_row_gather(di, x.data_ptr(), rb, idx.data_ptr(), n, out.data_ptr(),
                               geo.unit, geo.g, geo.steps, geo.blocks, stream_handle(di))
    if code != 0:
        raise RuntimeError(f"halo_row_gather launch failed: "
                           f"{lib.halo_error_string(code).decode()} ({code})")
    PACK_LAUNCHES += 1
    return True


def _launch_segsum(g: torch.Tensor, order: torch.Tensor, row_ptr: torch.Tensor,
                   out: torch.Tensor) -> bool:
    """Launch K10: out[r] = sum_{j in [row_ptr[r], row_ptr[r+1])}
    float(g[order[j]]); every row of out is written. Checks as K9's
    launcher does."""
    global HALO_BWD_LAUNCHES
    di = g.get_device()
    n = out.shape[0]
    if not (di >= 0 and g.dtype in _DTYPE_CODE and out.dtype == torch.float32
            and order.dtype == torch.int32 and row_ptr.dtype == torch.int32
            and g.dim() == 2 and out.dim() == 2 and order.dim() == 1 and row_ptr.dim() == 1
            and out.shape[1] == g.shape[1] and row_ptr.shape[0] == n + 1
            and order.get_device() == di and row_ptr.get_device() == di
            and out.get_device() == di and g.is_contiguous() and out.is_contiguous()
            and order.is_contiguous() and row_ptr.is_contiguous()):
        _refuse(g, [order, row_ptr], out)
        _check(out.dtype == torch.float32, f"out dtype {out.dtype} (needs float32)")
        _check(False, "row_ptr must have rows + 1 entries")
    if n == 0:
        return False
    lib = _lib or build_kernel()
    code = lib.halo_segsum(di, _DTYPE_CODE[g.dtype], g.data_ptr(), g.shape[1],
                           order.data_ptr(), row_ptr.data_ptr(), n, out.data_ptr(),
                           stream_handle(di))
    if code != 0:
        raise RuntimeError(f"halo_segsum launch failed: "
                           f"{lib.halo_error_string(code).decode()} ({code})")
    HALO_BWD_LAUNCHES += 1
    return True


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9 -> (len(idx), F) in x's dtype. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise. A table without rows
    (a rank that received no ghost row) gives zero rows on either device:
    every slot of its placement map is a dead one."""
    if x.is_cuda:
        if x.shape[0] == 0:
            return x.new_zeros((idx.shape[0], x.shape[1]))
        if not x.is_contiguous():
            x = x.contiguous()
        out = x.new_empty((idx.shape[0], x.shape[1]))
        _launch_row_gather(x, idx, out)
        return out
    if x.device.type != "cpu":
        raise ValueError(f"row_gather: unsupported device {x.device}")
    if x.shape[0] == 0:
        return torch.zeros((idx.shape[0], x.shape[1]), dtype=x.dtype)
    return row_gather_plain(x, idx)


def segsum_gather(g: torch.Tensor, order: torch.Tensor, rows: torch.Tensor,
                  row_ptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K10 -> (num_rows, F) f32. `rows` (the sorted local row of each
    order entry) serves the plain version, `row_ptr` (its run offsets) the
    kernel. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if g.is_cuda:
        if not g.is_contiguous():
            g = g.contiguous()
        out = g.new_empty((num_rows, g.shape[1]), dtype=torch.float32)
        _launch_segsum(g, order, row_ptr, out)
        return out
    if g.device.type != "cpu":
        raise ValueError(f"segsum_gather: unsupported device {g.device}")
    return segsum_gather_plain(g, order, rows, num_rows)


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
    counts (every rank must then build its plan at the same point).

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu". group: the process group of the n graph
    shards (parallel/mesh.py; None: the world), over which every exchange
    of this plan runs; under tensor parallelism each feat index exchanges
    its F/m columns within its own graph group."""

    def __init__(self, shard: Shard, n: int, wire: str = "ragged",
                 device: str | torch.device | None = None,
                 counts: Optional[tuple[np.ndarray, np.ndarray]] = None, group=None):
        device = resolve_device(device)
        self.group = group
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
                torch.tensor(recv_cnt, device=self.device)[:, None], [1] * n, [1] * n,
                group=group)
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

        # The kernels take these arrays as they are, call after call: check
        # their values once, here.
        total = int(np.asarray(recv_cnt).sum())
        for a, lo, hi, what in ((pack, -1, vp, "pack"), (place, -1, total, "place"),
                                (unplace, 0, n * mh, "unplace"), (order, 0, len(pack), "order")):
            if a is not None and len(a) and (int(a.min()) < lo or int(a.max()) >= hi):
                raise ValueError(f"halo plan: {what} indices outside [{lo}, {hi})")
        if row_ptr[0] != 0 or row_ptr[-1] != len(order) or (np.diff(row_ptr) < 0).any():
            raise ValueError("halo plan: row_ptr must rise from 0 to the plan's entries")

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

        self.pack, self.order, self.rows, self.row_ptr = t(pack), t(order), t(rows), t(row_ptr)
        self.place = None if place is None else t(place)
        self.unplace = None if unplace is None else t(unplace)

    def wire_rows(self, me: int) -> int:
        """Rows this rank puts on the wire per exchange (its own block
        never leaves the rank)."""
        return sum(c for p, c in enumerate(self.in_splits) if p != me)


# The return trip of the ghost rows' cotangent g: each received block goes
# back to its owner (the split lists swap roles), then the sorted
# segment-sum adds up, per local row, what its receivers returned.


def _unplaced(g: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """g's received blocks in wire order (K9 on the exact wire)."""
    g = g.contiguous()
    return g if plan.unplace is None else row_gather(g, plan.unplace)


def _summed(back: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """What came back, summed per local row (K10) -> (vp, F) f32."""
    return segsum_gather(back, plan.order, plan.rows, plan.row_ptr, plan.vp)


def reverse_whole(g: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """The whole return trip of g -> h's share (vp, F) f32."""
    back = multihost.all_to_all_rows(_unplaced(g, plan), plan.out_splits, plan.in_splits,
                                     group=plan.group)
    return _summed(back, plan)


# Reverse exchanges of this process started and not finished (at most one:
# layer l-1's starts after layer l's finish).
_REVERSE_OPEN = 0


class ReverseExchange:
    """One overlap layer's reverse exchange in two steps: `start(g)` from
    the ghost rows' cotangent (HaloRecvFn's backward: K9's unplace, the
    all-to-all started), `finish()` in the join's backward (the wait, K10)
    -> h's share (vp, F) f32. Each start is finished exactly once: a start
    while another is open, a forward exchange started while one is open,
    and a finish with nothing started raise (a backward that pruned one of
    the two nodes)."""

    def __init__(self, plan: HaloPlan):
        self.plan = plan
        self.exchange: Optional[multihost.Exchange] = None

    def start(self, g: torch.Tensor) -> None:
        global _REVERSE_OPEN
        _refuse_open("a reverse exchange")
        plan = self.plan
        self.exchange = multihost.all_to_all_rows_start(_unplaced(g, plan), plan.out_splits,
                                                        plan.in_splits, group=plan.group,
                                                        direction="bwd")
        _REVERSE_OPEN += 1

    def finish(self) -> torch.Tensor:
        global _REVERSE_OPEN
        ex, self.exchange = self.exchange, None
        if ex is None:
            raise RuntimeError("halo: the reverse exchange was never started (the backward "
                               "pruned HaloRecvFn's node but ran the join's)")
        _REVERSE_OPEN -= 1
        return _summed(multihost.all_to_all_rows_finish(ex), self.plan)


def _refuse_open(what: str) -> None:
    """Raise where a reverse exchange of this process is still open."""
    if _REVERSE_OPEN:
        raise RuntimeError(f"halo: {what} started while a reverse exchange is open (a "
                           "backward ran HaloRecvFn's node and pruned the join's, or "
                           "stopped between them)")


class HaloRecvFn(torch.autograd.Function):
    """Ghost rows (n * max_h, F) of h over the process group, on either
    wire (JAX: `_halo_recv_planned` and `ragged_halo_recv` with their
    custom VJPs). pending: the exchange `halo_start` started from h, which
    the forward finishes; None: the forward packs, exchanges and places in
    one go. reverse: the `ReverseExchange` the backward starts, which the
    `HaloJoinFn` on h finishes; None: the backward runs the reverse
    exchange whole and returns h's gradient."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, plan: HaloPlan, pending=None,
                reverse: Optional[ReverseExchange] = None) -> torch.Tensor:
        ctx.plan, ctx.h_dtype, ctx.reverse = plan, h.dtype, reverse
        if pending is None:
            recv = multihost.all_to_all_rows(row_gather(h, plan.pack), plan.in_splits,
                                             plan.out_splits, group=plan.group)
        else:
            recv = multihost.all_to_all_rows_finish(pending)
        return recv if plan.place is None else row_gather(recv, plan.place)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.reverse is not None:
            ctx.reverse.start(g)
            return None, None, None, None
        return reverse_whole(g, ctx.plan).to(ctx.h_dtype), None, None, None


class HaloJoinFn(torch.autograd.Function):
    """h itself; the backward finishes the reverse exchange HaloRecvFn's
    backward started and adds h's share of it (in h's dtype) to the
    gradient h's other consumers delivered."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, reverse: ReverseExchange) -> torch.Tensor:
        ctx.reverse = reverse
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g + ctx.reverse.finish().to(g.dtype), None


def halo_start(h: torch.Tensor, plan: HaloPlan) -> multihost.Exchange:
    """Pack the rows each peer needs (K9) and start the all-to-all; the
    exchange in flight, for `HaloRecvFn.apply(h, plan, pending)`. Nothing
    of it is recorded for autograd: HaloRecvFn's backward returns the
    exchange's gradient."""
    _refuse_open("a halo exchange")
    with torch.no_grad():
        buf = row_gather(h, plan.pack)
    return multihost.all_to_all_rows_start(buf, plan.in_splits, plan.out_splits,
                                           group=plan.group)


def halo_recv(h: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """Ghost rows only: (n * max_h, F) in h's dtype, the whole exchange in
    one call. h may be a column slice (tensor parallelism): K9 packs from a
    contiguous copy of it."""
    return HaloRecvFn.apply(h, plan, None)


def halo_exchange(h: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """The feature table (vp + n * max_h, F): local rows, then the ghosts
    grouped by owner. Every rank of the group must call it."""
    return torch.cat([h, halo_recv(h, plan)], dim=0)


class HaloPending(NamedTuple):
    """An exchange `Halo.start` started: h joined to its reverse exchange
    (what the layer reads from there on), the all-to-all in flight (None:
    the forward exchanges whole at the finish) and the reverse exchange the
    backward runs in two steps."""

    h: torch.Tensor
    exchange: Optional[multihost.Exchange]
    reverse: ReverseExchange


class Halo:
    """The halo the models take (JAX: `make_halo_fn`'s callable). Called
    with h, the whole exchange both ways: the ghost rows alone (ghosts_only,
    the overlap plans) or the full feature table. `start(h)` / `finish
    (pending)` split both exchanges around the work that does not read the
    rows (the overlap plans): start joins h to the reverse exchange and
    starts the forward one; finish returns the ghost rows."""

    def __init__(self, plan: HaloPlan, ghosts_only: bool):
        self.plan, self.ghosts_only = plan, ghosts_only

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return halo_recv(h, self.plan) if self.ghosts_only else halo_exchange(h, self.plan)

    def start(self, h: torch.Tensor) -> HaloPending:
        reverse = ReverseExchange(self.plan)
        exchange = halo_start(h, self.plan)
        return HaloPending(HaloJoinFn.apply(h, reverse), exchange, reverse)

    def finish(self, pending: HaloPending) -> torch.Tensor:
        return HaloRecvFn.apply(pending.h, self.plan, pending.exchange, pending.reverse)


def make_halo_fn(plan: Optional[HaloPlan], overlap: bool, multi: bool) -> Optional[Halo]:
    """The halo the models take (JAX: `make_halo_fn`): overlap=True, the
    ghost rows only, else the full feature table. None when single-shard."""
    if not multi:
        return None
    return Halo(plan, ghosts_only=overlap)
