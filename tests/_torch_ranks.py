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
from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM
from dorylus_tpu_torch.parallel import halo, multihost
from dorylus_tpu_torch.parallel.train_step import ShardedEngine


def engine_rank(rank, world, device, graph, dims, cfg_kw, epochs, opts):
    """Train `epochs` on this rank's shard; returns what the tests compare.
    opts: "grads" (the loss's gradients at the initial params, summed over
    the world as the train step sums them, taken before training),
    "profile" (ShardedEngine.profile after training), "predict",
    "constants" (engine/engine.py module constants set before the engine
    is built, e.g. reuse="auto"'s gate), "run" (epochs to run when they
    differ from cfg.epochs, the horizon the gate reads), "threshold"
    (kernel="auto"'s edge threshold the sharded engine resolves with)."""
    import functools

    from dorylus_tpu_torch.common import config
    from dorylus_tpu_torch.engine import engine as engine_module
    from dorylus_tpu_torch.parallel import train_step

    torch.set_num_threads(1)
    for name, value in opts.get("constants", {}).items():
        setattr(engine_module, name, value)
    if "threshold" in opts:
        train_step.resolve_kernel = functools.partial(config.resolve_kernel,
                                                      threshold=opts["threshold"])
    cfg = TrainConfig(epochs=epochs, **cfg_kw)
    eng = ShardedEngine(graph, LayerConfig(list(dims)), cfg, device=device,
                        partition_method=opts.get("partition", "range"))
    grads = None
    if opts.get("grads"):
        names = list(eng.params)
        loss = eng.model.loss(eng.batch, eng.compute_dtype, eng.halo)
        gs = torch.autograd.grad(loss, [eng.params[k] for k in names])
        grads = {k: multihost.all_reduce_sum(g.detach().clone()).cpu().numpy()
                 for k, g in zip(names, gs)}
    rep = eng.run(opts.get("run"))
    out = {"losses": [e.loss for e in rep.epochs],
           "accuracies": [e.accuracy for e in rep.epochs],
           "times": [e.time_ms for e in rep.epochs],
           "val_acc": rep.final_accuracy, "test_acc": rep.test_accuracy,
           "kernel": eng.kernel_selected, "overlap": bool(eng.cfg.overlap),
           "edges_per_shard": eng.meta.ep,
           "wire": None if eng.halo_plan is None else eng.halo_plan.wire,
           "params": {k: p.detach().cpu().numpy() for k, p in eng.params.items()},
           "foreign_modules": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("dorylus_tpu", "bench")),
           "mesh": (eng.mesh.n_shards, eng.mesh.feat_shards, eng.mesh.graph_index,
                    eng.mesh.feat_index),
           "notes": dict(rep.notes), "grads": grads}
    split = eng.model.spmm_split
    op = eng.model.spmm_op
    out["plan"] = ("edge_split" if eng.model.edge_split is not None
                   else "pair" if isinstance(split, tuple)
                   else "fused" if split is not None
                   else "edge_op" if op is None else type(op).__name__)
    out["boundary_edges"] = eng.shard.num_edges - eng.shard.num_int
    if isinstance(op, ShardedReuseSpMM):
        out["pairs"] = (op.plan_fwd.num_pairs, op.plan_bwd.num_pairs)
        if op.f_in is not None:
            out["f_in"], out["f_out"] = op.f_in.cpu().numpy(), op.f_out.cpu().numpy()
            out["recv_cnt"] = (None if eng.halo_plan is None
                               else np.asarray(eng.halo_plan.recv_cnt))
    if opts.get("predict"):
        out["predict"] = eng.predict()
    if opts.get("profile"):
        out["profile"] = eng.profile(iters=2)
    return out


def engines_rank(rank, world, device, graph, dims, runs):
    """Several engine runs in one launch (a launch costs seconds): `runs`
    is a list of (cfg_kw, epochs, opts); returns engine_rank's result for
    each."""
    return [engine_rank(rank, world, device, graph, dims, cfg_kw, epochs, opts)
            for cfg_kw, epochs, opts in runs]


def cases_rank(rank, world, device, cases):
    """engine_rank for each (graph, dims, cfg_kw, epochs, opts) of `cases`,
    in one launch."""
    return [engine_rank(rank, world, device, *case) for case in cases]


def staging_rank(rank, world, device):
    """The collectives' host staging over two groups: the (2, 2) mesh's feat
    and graph reductions, gathers and all-to-alls of one shape and dtype,
    interleaved, with every tensor staged through the shared per-tag host
    buffers (on the CPU the buffers are plain, unpinned tensors). Returns
    each result as it stood when the call returned and as it stands at the
    end, and the expected values."""
    from dorylus_tpu_torch.parallel.mesh import make_mesh

    multihost._staged = lambda t: True
    multihost._host = _shared_host
    mesh = make_mesh(2, 2)
    fg, gg = mesh.feat_group, mesh.graph_group
    x = torch.full((3, 4), float(rank + 1))
    calls = [("feat", lambda: multihost.all_reduce_sum(x.clone(), fg)),
             ("graph", lambda: multihost.all_reduce_sum(10 * x, gg)),
             ("feat", lambda: multihost.all_reduce_sum(100 * x, fg)),
             ("gather_graph", lambda: multihost.all_gather_rows(x, gg)),
             ("gather_feat", lambda: multihost.all_gather_rows(2 * x, fg)),
             ("a2a_graph", lambda: multihost.all_to_all_rows(
                 torch.arange(4.0)[:, None].repeat(1, 3) + 10 * rank, [2, 2], [2, 2], gg)),
             ("a2a_feat", lambda: multihost.all_to_all_rows(
                 torch.arange(4.0)[:, None].repeat(1, 3) + 100 * rank, [2, 2], [2, 2], fg)),
             ("world", lambda: multihost.all_reduce_sum(x.clone()))]
    kept, at_return = [], []
    for _, call in calls:
        t = call()
        kept.append(t)
        at_return.append(t.clone().numpy())
    return {"names": [c[0] for c in calls], "at_return": at_return,
            "at_end": [t.numpy() for t in kept], "mesh": tuple(mesh[:4])}


_SHARED: dict = {}


def _shared_host(tag, shape, dtype):
    """multihost._host without pinning: one buffer per (tag, dtype), grown
    as needed, views of it handed out."""
    need = int(np.prod(shape)) if len(shape) else 1
    buf = _SHARED.get((tag, dtype))
    if buf is None or buf.numel() < need:
        buf = torch.empty(max(need, 1), dtype=dtype)
        _SHARED[(tag, dtype)] = buf
    return buf[:need].view(*shape)


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
