"""Entry points of the port (the counterpart of the repo root's
`__graft_entry__.py`, which drives the JAX package).

entry(device=None)              -> (fn, args): the forward of the flagship
                                   model (Reddit-config GCN on the hybrid-ELL
                                   op with static norms), one device.
dryrun_multichip(n, device=None) -> the sharded training step on n ranks
                                   (parallel/multihost.py `spawn_local`),
                                   tiny shapes: GCN and GAT on the xla,
                                   degree and hyb kernels, pair reuse, and
                                   with n >= 4 tensor parallelism; one
                                   `dryrun ok: ...` line each, as the JAX
                                   package prints them.

device None means the card (a RuntimeError without one); "cpu" runs on the
CPU. Where the JAX dry run calls its compiled multi-epoch groups (a
`lax.scan` with and without the staleness stash), the port runs `run_loop`
for 2 epochs with eval at staleness 1 and at 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.common.device import resolve_device


def _flagship(num_vertices: int, avg_degree: int):
    """Reddit's layer config (602 -> 128 -> 41) on a small synthetic graph."""
    from dorylus_tpu_torch.graph.graph import synthetic_graph

    g = synthetic_graph(num_vertices, avg_degree, 602, 41, seed=8888)
    return g, LayerConfig([602, 128, 41])


def entry(device: str | torch.device | None = None):
    """(fn, (params, batch)): fn(params, batch) is the flagship GCN's
    forward (logits (V, 41)) on params by name, as the JAX entry's
    `fwd(params, batch)`."""
    from dorylus_tpu_torch.engine.batch import build_batch
    from dorylus_tpu_torch.models.gcn import GCN
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM

    device = resolve_device(device)
    g, layers = _flagship(4096, 16)
    # what kernel="auto" resolves to at scale: hybrid ELL, static GCN norms
    op = HybSpMM(g.src, g.dst, g.num_vertices, g.num_vertices, static_val=g.edge_norm,
                 device=device)
    model = GCN(layers, spmm_op=op)
    params = {k: p.detach().clone() for k, p in
              model.init_params(exact_reference=False).items()}
    batch = build_batch(g, device, edge_arrays=False)

    def fwd(params, batch):
        return torch.func.functional_call(model, params, (batch,))

    return fwd, (params, batch)


def _community_graph(v: int, n: int):
    """The dry run's pair-reuse graph (community cores, so pairs are mined)."""
    from dorylus_tpu_torch.graph.graph import Graph, community_core_edges

    src, dst = community_core_edges(v, 8, comm=max(2, n), core=12, seed=5)
    labels = ((np.arange(v) * 5) // v).astype(np.int32)
    feats = np.random.default_rng(6).normal(0, 1, size=(v, 32)).astype(np.float32)
    return Graph(num_vertices=v, src=src, dst=dst, features=feats, labels=labels,
                 num_classes=5).finalize()


def _step_and_runs(eng, runs: bool = True) -> None:
    """One train step; then 2 epochs with eval at staleness 1 and at 0, the
    evaluation and predict (runs=False: the step and 2 epochs at 0)."""
    loss = eng._train_epoch(eng.cfg.learning_rate)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"dry run: non-finite loss {float(loss)}")
    for staleness in ((1, 0) if runs else (0,)):
        eng.cfg = dataclasses.replace(eng.cfg, staleness=staleness,
                                      eval_every=1 if runs else 0)
        rep = eng.run(2)
        if not all(np.isfinite([e.loss for e in rep.epochs])):
            raise RuntimeError(f"dry run: losses {[e.loss for e in rep.epochs]}")
    if runs:
        eng._stats(eng.batch.val_mask)
        if not np.isfinite(eng.predict()).all():
            raise RuntimeError("dry run: predict() is not finite")


def _dryrun_rank(rank: int, world: int, device) -> list:
    """One rank of the dry run; the lines rank 0 would print."""
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    g, layers = _flagship(64 * world, 8)
    lines = []
    # both models on the three aggregation kernels: xla (edgewise, the
    # halo overlap split), degree (the per-shard degree plans), hyb (what
    # auto resolves to at scale)
    for model in ("gcn", "gat"):
        for kernel in ("xla", "degree", "hyb"):
            cfg = TrainConfig(epochs=1, eval_every=0, kernel=kernel, model=model)
            _step_and_runs(ShardedEngine(g, layers, cfg, device=device))
            lines.append(f"dryrun ok: model={model} kernel={kernel} n={world}")
    # sharded pair reuse on a graph where the rewrite fires
    gr = _community_graph(64 * world, world)
    eng = ShardedEngine(gr, LayerConfig([32, 16, 5]),
                        TrainConfig(epochs=1, eval_every=0, kernel="hyb", reuse="pairs"),
                        device=device)
    if eng.model.spmm_op is None or not hasattr(eng.model.spmm_op, "plan_fwd"):
        raise RuntimeError("dry run: reuse=\"pairs\" built no pair rewrite")
    _step_and_runs(eng, runs=False)
    # tensor parallelism: world // 2 graph shards x 2 feat shards
    if world >= 4:
        for model in ("gcn", "gat"):
            cfg = TrainConfig(epochs=1, eval_every=0, kernel="hyb", feat_shards=2,
                              num_shards=world // 2, reuse="off", model=model)
            _step_and_runs(ShardedEngine(g, layers, cfg, device=device), runs=False)
            lines.append(f"dryrun ok: model={model} kernel=hyb tp=2x{world // 2}")
    return lines


def dryrun_multichip(n_devices: int, device: str | None = None) -> list:
    """The sharded training step on n ranks of this host: NCCL with a card a
    rank where there are n cards, else gloo on cuda:0; gloo on the CPU with
    device="cpu". Prints (and returns) the `dryrun ok` lines."""
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    if device == "cpu":
        backend, rank_device = "gloo", "cpu"
    else:
        resolve_device(device)  # the card, or a RuntimeError
        from dorylus_tpu_torch import cli
        from dorylus_tpu_torch.ops import cuda_build

        # every rank would build the same libraries: build them once here
        cuda_build.compile_sources(cli._engine_sources())
        if torch.cuda.device_count() >= n_devices:
            backend, rank_device = "nccl", "cuda:{rank}"
        else:
            backend, rank_device = "gloo", "cuda:0"
    res = spawn_local(n_devices, _dryrun_rank, (), backend=backend, device=rank_device,
                      timeout_s=1800)
    if any(r != res[0] for r in res):
        raise RuntimeError(f"dry run: the ranks report other runs: {res}")
    for line in res[0]:
        print(line, flush=True)
    return res[0]
