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

The collectives (`all_to_all_rows`, `all_reduce_sum`, `all_gather_rows`)
are thin wrappers with one transport rule, chosen by backend name: NCCL
takes device buffers as they are; gloo takes CPU buffers, so under gloo a
CUDA tensor is staged through a pinned host buffer, explicitly, here. With
no process group (one shard) they are the identity.
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
_LOGGED_TRANSPORT = False


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def backend_name() -> str:
    return dist.get_backend() if initialized() else "none"


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
    moves bytes whatever the element type."""
    return t.view(torch.uint8) if t.dtype != torch.uint8 else t


def all_to_all_rows(inp: torch.Tensor, in_splits: list[int],
                    out_splits: list[int]) -> torch.Tensor:
    """Rows [sum(in_splits[:p]), ...) of `inp` go to rank p; returns the
    (sum(out_splits), F) rows received, grouped by sender. Every rank of
    the group must call it, a rank with nothing to send included."""
    n_out = sum(out_splits)
    out = torch.empty((n_out,) + tuple(inp.shape[1:]), dtype=inp.dtype,
                      device=inp.device)
    if not initialized():
        raise RuntimeError("all_to_all_rows needs a process group")
    inp = inp.contiguous()
    if _staged(inp):
        h_in = _host("a2a_in", inp.shape, inp.dtype)
        h_out = _host("a2a_out", out.shape, out.dtype)
        h_in.copy_(inp)  # device -> pinned host, waits for the stream
        dist.all_to_all_single(_as_bytes(h_out), _as_bytes(h_in),
                               out_splits, in_splits)
        out.copy_(h_out)
    elif backend_name() == "gloo":
        dist.all_to_all_single(_as_bytes(out), _as_bytes(inp), out_splits,
                               in_splits)
    else:
        dist.all_to_all_single(out, inp, out_splits, in_splits)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; the identity without a group."""
    if not initialized():
        return t
    if _staged(t):
        h = _host("reduce", t.shape, t.dtype)
        h.copy_(t)
        dist.all_reduce(h, op=dist.ReduceOp.SUM)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (equal shapes) stacked on a new leading axis, on
    every rank."""
    if not initialized():
        return t[None]
    n = world_size()
    t = t.contiguous()
    staged = _staged(t)
    src = t
    if staged:
        src = _host("gather_in", t.shape, t.dtype)
        src.copy_(t)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src)
    return torch.stack(parts).to(t.device)


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
