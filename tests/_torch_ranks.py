"""Rank bodies for the port's multi-process tests (started by
dorylus_tpu_torch.parallel.multihost.spawn_local, which needs module-level
functions it can name in a fresh interpreter). Imports torch and the port
only, so a rank starts without loading jax."""

from __future__ import annotations

import sys

import numpy as np
import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.graph.partition import partition_graph
from dorylus_tpu_torch.parallel import halo
from dorylus_tpu_torch.parallel.train_step import ShardedEngine


def engine_rank(rank, world, device, graph, dims, cfg_kw, epochs, opts):
    """Train `epochs` on this rank's shard; returns what the tests compare."""
    torch.set_num_threads(1)
    cfg = TrainConfig(epochs=epochs, **cfg_kw)
    eng = ShardedEngine(graph, LayerConfig(list(dims)), cfg, device=device,
                        partition_method=opts.get("partition", "range"))
    rep = eng.run()
    out = {"losses": [e.loss for e in rep.epochs],
           "val_acc": rep.final_accuracy, "test_acc": rep.test_accuracy,
           "kernel": eng.kernel_selected, "overlap": bool(eng.cfg.overlap),
           "wire": None if eng.halo_plan is None else eng.halo_plan.wire,
           "params": {k: p.detach().cpu().numpy() for k, p in eng.params.items()},
           "foreign_modules": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("dorylus_tpu", "bench"))}
    if opts.get("predict"):
        out["predict"] = eng.predict()
    return out


def engines_rank(rank, world, device, graph, dims, runs):
    """Several engine runs in one launch (a launch costs seconds): `runs`
    is a list of (cfg_kw, epochs, opts); returns engine_rank's result for
    each."""
    return [engine_rank(rank, world, device, graph, dims, cfg_kw, epochs, opts)
            for cfg_kw, epochs, opts in runs]


def halo_rank(rank, world, device, graph, method, wire, h_all, g_all, dtype):
    """One exchange forward and backward on this rank: (ghosts, dh, table
    of halo_exchange) for the shard's rows of h_all and the cotangent
    g_all[rank]."""
    torch.set_num_threads(1)
    sharded = partition_graph(graph, world, method=method)
    shard = sharded.shards[rank]
    plan = halo.HaloPlan(shard, world, wire, device)
    tdt = getattr(torch, dtype)
    h = torch.tensor(h_all[rank], device=device).to(tdt).requires_grad_(True)
    ghosts = halo.halo_recv(h, plan)
    ghosts.backward(torch.tensor(g_all[rank], device=device).to(tdt))
    table = halo.halo_exchange(h.detach(), plan)
    return {"ghosts": ghosts.detach().float().cpu().numpy(),
            "dh": h.grad.float().cpu().numpy(),
            "table": table.float().cpu().numpy(),
            "send_cnt": np.asarray(plan.send_cnt), "recv_cnt": np.asarray(plan.recv_cnt),
            "wire_rows": plan.wire_rows(rank)}


def failing_rank(rank, world, device, bad):
    """Rank `bad` raises before the others' first collective returns."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t)


def sleeping_rank(rank, world, device, seconds):
    """Outlasts the launcher's timeout."""
    import time

    time.sleep(seconds)
    return rank
