"""One process per shard over torch.distributed: bring-up, local launch and
the collectives the sharded engine uses (port of dorylus_tpu/parallel/
mesh.py and multihost.py).

JAX runs one controller over a device mesh; the port runs one process per
vertex shard (rank = shard id) in one process group. The same code serves
three settings, and the caller names the backend (it is never switched
behind the caller's back):

    four cards   4 ranks, each on its own card        backend "nccl"
    one card     4 ranks, all on cuda:0               backend "gloo"
    CPU          2-4 ranks on the CPU                 backend "gloo"

`init_from_env` joins the group a launcher such as torchrun describes
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). `spawn_local`
starts n ranks on this host with a file:// rendezvous in a temp directory
(no port to collide on), returns their results, and raises if any rank
fails: a failing rank fails the run, and the others are stopped rather
than left waiting in a collective.

The collectives (`all_to_all_rows`, `all_reduce_sum`, `all_gather_rows`,
`barrier`) are thin wrappers with one transport rule, chosen by backend
name: NCCL takes device buffers as they are; gloo takes CPU buffers, so
under gloo a CUDA tensor is staged through a pinned host buffer,
explicitly, here. Each takes an optional process `group` (the graph or the
feat group of parallel/mesh.py; None is the world). With no process group
(one shard), or over a group of one rank, they are the identity. A gloo
collective returns only when it is done and every staged result is copied
out of its host buffer before the call returns, so one buffer per tag
serves every group: no result aliases a buffer another call reuses.

The all-to-all also runs in two steps, so that the caller's work runs
beside it (the halo exchange's overlap, parallel/halo.py):
`all_to_all_rows_start` starts it and returns an `Exchange` that holds
every buffer the transfer touches; `all_to_all_rows_finish` returns the
received rows, ordered before whatever the caller issues next.
`all_to_all_rows` is the two back to back. Per transport:

    gloo, CPU tensors   async_op=True; gloo's thread moves the bytes, and
                        finish waits for it
    gloo, CUDA tensors  start copies the rows into the pinned buffer (it
                        waits for the stream) and starts gloo on the host
                        buffers; finish waits, then copies them back. One
                        exchange at a time may hold the pinned buffers: a
                        second start before the finish raises
    NCCL                the collective on a side stream, forked from the
                        current stream by an event at start and joined back
                        by an event at finish (what a CUDA graph capture
                        takes, so the eager and the captured epoch share the
                        code); the handle keeps the send and receive buffers
                        alive until the join

The halo runs both directions this way (parallel/halo.py): the forward
exchange beside the rank's interior work, the reverse one, from the ghost
rows' cotangent, beside the layer's gradient work that does not read it.
Layer l-1's reverse exchange starts after layer l's has finished, and the
forward ones have finished before the loss exists, so at most one exchange
of a process is in flight; on the staged path the refusal of a second
start holds that.

`EXCHANGES` counts, on the staged path, what ran beside each exchange, per
direction.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from dorylus_tpu_torch.common.logging import log

_PINNED: dict = {}
_A2A_BUSY = False  # an exchange in flight holds the "a2a" pinned buffers
_SIDE: dict = {}  # card index -> the side stream NCCL's exchanges run on
_LOGGED_TRANSPORT = False

# The staged exchanges (gloo, CUDA tensors) of this process that a caller
# finishes apart (the halo's two steps; `all_to_all_rows` is not counted),
# the forward ones under these keys and the reverse ones under the same
# keys prefixed "bwd_": `started`;
# `held`, those whose work issued between start and finish had completed on
# the card when gloo's wait returned (an event recorded at the finish's
# entry, queried after the wait: no host wait of its own); `host_ms`, the
# host's time from the start's entry (the staging copy included) to the
# wait's return; `beside_ms`, the card's
# time between the start's return and the finish's entry, summed over the
# held exchanges (the work issued beside the exchange, its enqueue gaps
# included).
_COUNTS = {"started": 0, "held": 0, "host_ms": 0.0, "beside_ms": 0.0}
EXCHANGES = {f"{d}{k}": v for d in ("", "bwd_") for k, v in _COUNTS.items()}
_PREFIX = {"fwd": "", "bwd": "bwd_"}


def reset_exchanges() -> None:
    """Every EXCHANGES count back to 0."""
    EXCHANGES.update({k: type(v)() for k, v in EXCHANGES.items()})


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size(group=None) -> int:
    """The ranks of `group` (None: the world); 1 without a process group."""
    return dist.get_world_size(group) if initialized() else 1


def backend_name() -> str:
    return dist.get_backend() if initialized() else "none"


def collectives_capturable(backend: str | None = None) -> bool:
    """Whether this process's collectives can be captured in a CUDA graph,
    by the backend's name (None: this process's): without a process group
    (they are the identity) and under NCCL, which enqueues on the device;
    not under gloo, whose CUDA tensors are staged through a pinned host
    buffer (`_staged`): the copy out waits for the stream and the copy back
    runs after the host's collective, which a capture refuses."""
    return (backend or backend_name()) in ("none", "nccl")


def init_group(backend: str, init_method: str, world: int, rank_: int,
               device: str | torch.device,
               timeout_s: float = 600.0) -> torch.device:
    """Join the process group as rank `rank_` of `world`, on `device`
    (made the current CUDA device before anything is allocated). The
    timeout bounds every collective, so a rank whose peer died raises
    instead of waiting forever."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend nccl needs a CUDA device per rank")
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log("rank %d/%d joined (%s, device %s)", rank_, world, backend, device)
    return device


def init_from_env(backend: str, device: str | None = None,
                  timeout_s: float = 600.0) -> tuple[int, int, torch.device]:
    """Join the group a launcher described in the environment (torchrun's
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). device None:
    cuda:LOCAL_RANK under nccl, else the caller must say. Returns
    (rank, world, device)."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {missing} not set (start the "
                           "ranks with torchrun, or use spawn_local)")
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        if backend != "nccl":
            raise ValueError("init_from_env: name the device for backend "
                             f"{backend!r} (\"cpu\" or \"cuda:0\")")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank_))}"
    dev = init_group(backend, "env://", world, rank_, device, timeout_s)
    return rank_, world, dev


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()


# ---- collectives ----


def _staged(t: torch.Tensor) -> bool:
    """Whether this tensor travels through a host buffer: gloo moves CPU
    memory, so a CUDA tensor under gloo is staged (by backend name, not by
    trial)."""
    global _LOGGED_TRANSPORT
    staged = backend_name() == "gloo" and t.is_cuda
    if not _LOGGED_TRANSPORT:
        _LOGGED_TRANSPORT = True
        log("collective transport: %s, %s", backend_name(),
            "CUDA tensors staged through pinned host buffers" if staged
            else "buffers used where they lie")
    return staged


def _host(tag: str, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A pinned host buffer of at least this size, kept per tag."""
    need = 1
    for s in shape:
        need *= int(s)
    buf = _PINNED.get((tag, dtype))
    if buf is None or buf.numel() < need:
        buf = torch.empty(max(need, 1), dtype=dtype, pin_memory=True)
        _PINNED[(tag, dtype)] = buf
    return buf[:need].view(*shape)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(rows, F) of any dtype as (rows, F * itemsize) uint8: gloo then
    moves bytes whatever the element type. `t` is contiguous; it is
    flattened first, because a one-column table may carry any stride on its
    last axis, which a dtype view refuses."""
    if t.dtype == torch.uint8:
        return t
    row_bytes = t[0].numel() * t.element_size() if t.shape[0] else 0
    if not t.numel():
        return t.new_empty((t.shape[0], row_bytes), dtype=torch.uint8)
    return t.reshape(-1).view(torch.uint8).view(t.shape[0], row_bytes)


class Exchange:
    """An all-to-all in flight (`all_to_all_rows_start`): the received
    rows' buffer and every other buffer the transfer touches, held until
    `all_to_all_rows_finish`."""

    __slots__ = ("out", "inp", "work", "host_out", "side", "t0", "mark", "prefix")

    def __init__(self, out, inp, work=None, host_out=None, side=None):
        self.out, self.inp, self.work, self.host_out = out, inp, work, host_out
        self.side = side
        self.t0 = self.mark = self.prefix = None


def _side_stream(device: torch.device):
    """The stream NCCL's exchanges run on, one per card (made at the first
    exchange, which the engines run eagerly before any capture)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SIDE:
        _SIDE[idx] = torch.cuda.Stream(idx)
    return _SIDE[idx]


def all_to_all_rows_start(inp: torch.Tensor, in_splits: list[int],
                          out_splits: list[int], group=None, *,
                          direction: str | None = "fwd") -> Exchange:
    """Start sending rows [sum(in_splits[:p]), ...) of `inp` to rank p of
    `group`; `all_to_all_rows_finish` returns what arrives. Every rank of
    the group must start and finish it, a rank with nothing to send
    included, in the same order as every other collective. direction:
    "fwd" or "bwd", the EXCHANGES counts the exchange goes into (None:
    `all_to_all_rows`, which issues nothing beside it)."""
    global _A2A_BUSY
    if not initialized():
        raise RuntimeError("all_to_all_rows needs a process group")
    n_out = sum(out_splits)
    inp = inp.contiguous()
    out = torch.empty((n_out,) + tuple(inp.shape[1:]), dtype=inp.dtype,
                      device=inp.device)
    if _staged(inp):
        if inp.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("all_to_all_rows_start inside a CUDA graph capture under "
                               "gloo: the capture rule (collectives_capturable) refuses a "
                               "transport staged through host buffers")
        if _A2A_BUSY:
            raise RuntimeError("all_to_all_rows_start: an exchange already holds the "
                               "pinned buffers; finish it before starting another")
        t0 = time.perf_counter()
        h_in = _host("a2a_in", inp.shape, inp.dtype)
        h_out = _host("a2a_out", out.shape, out.dtype)
        h_in.copy_(inp)  # device -> pinned host, waits for the stream
        work = dist.all_to_all_single(_as_bytes(h_out), _as_bytes(h_in), out_splits,
                                      in_splits, group=group, async_op=True)
        _A2A_BUSY = True
        ex = Exchange(out, h_in, work, h_out)
        if inp.is_cuda and direction is not None:
            ex.prefix = _PREFIX[direction]
            ex.mark = torch.cuda.Event(enable_timing=True)
            ex.mark.record()
            EXCHANGES[ex.prefix + "started"] += 1
        ex.t0 = t0
        return ex
    if backend_name() == "gloo":
        work = dist.all_to_all_single(_as_bytes(out), _as_bytes(inp), out_splits,
                                      in_splits, group=group, async_op=True)
        return Exchange(out, inp, work)
    cur = torch.cuda.current_stream(inp.device)
    side = _side_stream(inp.device)
    side.wait_stream(cur)  # the fork: the rows are packed on the current stream
    with torch.cuda.stream(side):
        dist.all_to_all_single(out, inp, out_splits, in_splits, group=group)
    return Exchange(out, inp, side=side)


def all_to_all_rows_finish(ex: Exchange) -> torch.Tensor:
    """The (sum(out_splits), F) rows an `all_to_all_rows_start` received,
    grouped by sender, ordered before the caller's next work on its
    current stream. Raises where the transfer failed."""
    global _A2A_BUSY
    if ex.side is not None:
        # the join: the current stream waits for the side stream's collective
        torch.cuda.current_stream(ex.out.device).wait_stream(ex.side)
        return ex.out
    if ex.host_out is None:
        ex.work.wait()
        return ex.out
    try:
        if ex.mark is None:  # not counted, or CPU tensors staged (the tests' stand-in)
            ex.work.wait()
        else:
            done = torch.cuda.Event(enable_timing=True)
            done.record()  # after the work issued beside the exchange
            ex.work.wait()
            EXCHANGES[ex.prefix + "host_ms"] += 1e3 * (time.perf_counter() - ex.t0)
            if done.query():
                EXCHANGES[ex.prefix + "held"] += 1
                EXCHANGES[ex.prefix + "beside_ms"] += ex.mark.elapsed_time(done)
    finally:
        _A2A_BUSY = False
    ex.out.copy_(ex.host_out)
    return ex.out


def all_to_all_rows(inp: torch.Tensor, in_splits: list[int],
                    out_splits: list[int], group=None) -> torch.Tensor:
    """Rows [sum(in_splits[:p]), ...) of `inp` go to rank p of `group`;
    returns the (sum(out_splits), F) rows received, grouped by sender. Every
    rank of the group must call it, a rank with nothing to send included."""
    return all_to_all_rows_finish(all_to_all_rows_start(inp, in_splits, out_splits, group,
                                                        direction=None))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` (None: the world), in place; the
    identity without a process group or over a group of one rank."""
    if world_size(group) == 1:
        return t
    if _staged(t):
        h = _host("reduce", t.shape, t.dtype)
        h.copy_(t)
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (equal shapes) stacked on a new leading axis in the
    order of the ranks of `group` (None: the world), on every rank."""
    n = world_size(group)
    if n == 1:
        return t[None]
    t = t.contiguous()
    staged = _staged(t)
    src = t
    if staged:
        src = _host("gather_in", t.shape, t.dtype)
        src.copy_(t)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def barrier(device: str | torch.device, group=None) -> None:
    """Every rank of `group` (None: the world) waits here until all have
    arrived (a one-element all-reduce, read back on the host); nothing
    without a process group."""
    if world_size(group) > 1:
        float(all_reduce_sum(torch.zeros(1, device=device), group))


# ---- local launch ----


def _rank_main(rank_: int, world: int, backend: str, device: str, rdzv: str,
               timeout_s: float, target: Callable, args: tuple,
               out_dir: str) -> None:
    try:
        dev = init_group(backend, rdzv, world, rank_,
                         device.format(rank=rank_), timeout_s)
        result = target(rank_, world, dev, *args)
        with open(os.path.join(out_dir, f"result_{rank_}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
        shutdown()
    except BaseException:  # noqa: BLE001 — report, then fail the rank
        with open(os.path.join(out_dir, f"error_{rank_}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def spawn_local(n: int, target: Callable, args: tuple = (), *,
                backend: str, device: str | None = None,
                timeout_s: float = 600.0) -> list:
    """Start n ranks on this host, each running
    `target(rank, world, device, *args)` inside one process group, and
    return their results in rank order.

    target must be a module-level function (the ranks are fresh
    interpreters). backend: "nccl" or "gloo", the caller's choice. device:
    one device string for every rank ("cuda:0": n ranks on one card) or a
    template ("cuda:{rank}": one card each). None means the card: a card
    each under nccl, cuda:0 under gloo, and a RuntimeError when no card is
    visible; the ranks run on the CPU only when the caller passes "cpu".
    Raises RuntimeError if any rank raises, exits non-zero or the run
    outlasts timeout_s; the remaining ranks are then killed, so none is
    left blocked in a collective."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("spawn_local: no CUDA device is visible; pass "
                               "device=\"cpu\" to run the ranks on the CPU")
        device = "cuda:{rank}" if backend == "nccl" else "cuda:0"
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="dorylus_ranks_")
    rdzv = f"file://{out_dir}/rendezvous"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, device, rdzv, timeout_s, target,
                               args, out_dir), daemon=True)
             for r in range(n)]
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while failure is None and any(p.is_alive() for p in procs):
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    failure = f"rank {r} exited with code {p.exitcode}"
                    break
            if failure is None and time.monotonic() > deadline:
                failure = f"ranks still running after {timeout_s:.0f} s"
            time.sleep(0.05)
        if failure is None:
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failure = f"rank {bad[0][0]} exited with code {bad[0][1]}"
        if failure is not None:
            errors = []
            for r in range(n):
                path = os.path.join(out_dir, f"error_{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"--- rank {r} ---\n{f.read()}")
            raise RuntimeError(f"spawn_local: {failure}\n" + "\n".join(errors))
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(out_dir, ignore_errors=True)
