"""Sharded training: one process per vertex shard over torch.distributed
(port of dorylus_tpu/parallel/train_step.py `ShardedEngine`).

The multi-node architecture of the reference — graph servers exchanging
ghost activations, weight servers all-reducing gradients — maps to:

  - vertex shards, one per rank (rank = shard id; parallel/multihost.py),
  - per-layer halo exchange = one all-to-all (parallel/halo.py),
  - replicated params; weight gradients summed with `all_reduce` (JAX's
    `psum`), then the same reference Adam step on every rank,
  - barrier = the collectives themselves.

Per epoch each rank computes its local loss and gradients by autograd
(the halo exchange's backward is a collective too, entered by every rank
in the same order), all-reduces the gradients and the loss in one buffer,
and updates its replica. Evaluation sums (correct, loss, count) over the
ranks. The loss denominator is |V_global| * 0.66 on every rank.

Scope: kernel="hyb" for GCN and GAT, with the fused-overlap plan
(overlap on: the JAX default for hyb) or the combined plan; where
kernel="auto" resolves to "xla" on the per-shard edge count, the combined
edgewise path (EdgeSpMM over the shard's real edges, gathering from
`halo_exchange`'s table). Both halo wire formats. Everything else raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig, resolve_kernel
from dorylus_tpu_torch.common.logging import log
from dorylus_tpu_torch.common.metrics import EpochRecord, RunReport
from dorylus_tpu_torch.engine.convergence import ConvergeMonitor
from dorylus_tpu_torch.engine.engine import _DTYPES, eval_flags, resolve_device
from dorylus_tpu_torch.graph.graph import Graph
from dorylus_tpu_torch.graph.partition import Shard, ShardMeta, partition_graph
from dorylus_tpu_torch.models.base import GraphBatch
from dorylus_tpu_torch.models.gat import GAT
from dorylus_tpu_torch.models.gcn import GCN
from dorylus_tpu_torch.ops.activations import accuracy_and_loss, row_softmax
from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
from dorylus_tpu_torch.ops.spmm import EdgeSpMM
from dorylus_tpu_torch.optim.adam import adam_init, adam_update, decay_lr, sgd_update
from dorylus_tpu_torch.parallel import multihost
from dorylus_tpu_torch.parallel.halo import HaloPlan, make_halo_fn


def _unsupported(cfg: TrainConfig, n: int) -> Optional[str]:
    """The first configuration outside the ported slice, with its ROADMAP
    item, or None."""
    checks = [
        (cfg.model not in ("gcn", "gat"), f"model={cfg.model!r}"),
        (cfg.kernel == "degree",
         "kernel=\"degree\": ShardedDegreeSpMM is still to port (queue 2 item 8)"),
        (cfg.kernel not in ("hyb", "xla", "degree"), f"kernel={cfg.kernel!r}"),
        (cfg.reuse == "pairs",
         "reuse=\"pairs\": ShardedReuseSpMM is still to port (queue 2 item 8)"),
        (cfg.feat_shards > 1,
         "feat_shards > 1: tensor parallelism is queue 1 item 13"),
        (bool(cfg.staleness), f"staleness={cfg.staleness}: bounded staleness "
                              "is still to port (queue 1 item 3)"),
        (bool(cfg.checkpoint_dir) or cfg.resume,
         "checkpoint_dir/resume: checkpoint interop is queue 1 item 7"),
        (cfg.kernel == "xla" and bool(cfg.overlap) and n > 1,
         "overlap on kernel=\"xla\": the edgewise interior/boundary split is "
         "still to port (queue 2 item 8)"),
        (cfg.param_dtype != "float32", f"param_dtype={cfg.param_dtype!r}"),
        (cfg.compute_dtype not in _DTYPES or cfg.agg_dtype not in _DTYPES,
         f"compute_dtype={cfg.compute_dtype!r} / agg_dtype={cfg.agg_dtype!r}"),
        (cfg.halo not in ("auto", "padded", "ragged"), f"halo={cfg.halo!r}"),
    ]
    return next((msg for bad, msg in checks if bad), None)


def shard_batch(shard: Shard, denom: float, device: torch.device,
                edge_arrays: bool) -> GraphBatch:
    """One shard's GraphBatch on `device` (JAX `_local_batch`): vp rows,
    the shard's real edges (or zero-length stubs when the plans carry what
    aggregation reads), the global loss denominator."""
    e = shard.num_edges if edge_arrays else 0

    def t(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return GraphBatch(
        x=t(shard.x, torch.float32), onehot=t(shard.onehot),
        src=t(shard.src[:e], torch.int32), dst=t(shard.dst[:e], torch.int32),
        edge_val=t(shard.edge_val[:e], torch.float32),
        self_val=t(shard.self_val, torch.float32),
        train_mask=t(shard.train_mask, torch.float32),
        val_mask=t(shard.val_mask, torch.float32),
        test_mask=t(shard.test_mask, torch.float32),
        denom=torch.tensor(np.float32(denom), device=device))


class ShardedEngine:
    """One rank of the sharded engine: the same surface as `Engine`, SPMD
    over the process group this process has joined (parallel/multihost.py
    `spawn_local` or `init_from_env`); without a group it is one shard.

    graph: the whole `Graph` (every rank partitions it the same way and
    keeps its own shard), or this rank's `(Shard, ShardMeta)` as
    `load_shard` returns it (the parent of a local launch partitions once).
    device: None means the card, and raises when there is none; the CPU
    only when the caller passes "cpu"."""

    def __init__(self, graph: Graph | tuple[Shard, ShardMeta], layers: LayerConfig,
                 cfg: TrainConfig, device: str | torch.device | None = None,
                 partition_method: str = "range",
                 parts: Optional[np.ndarray] = None):
        n, me = multihost.world_size(), multihost.rank()
        self.n, self.rank = n, me
        gat = cfg.model == "gat"
        if isinstance(graph, tuple):
            shard, meta = graph
            if meta.n_shards != n or shard.shard_id != me:
                raise ValueError(f"shard {shard.shard_id} of {meta.n_shards} handed "
                                 f"to rank {me} of {n}")
        else:
            sharded = partition_graph(graph, n, method=partition_method,
                                      parts=parts, for_gat=gat)
            shard, meta = sharded.shards[me], ShardMeta.of(sharded)
        if layers.feature_dim != shard.x.shape[1]:
            raise ValueError("feature dim mismatch vs layer config "
                             f"({shard.x.shape[1]} vs {layers.feature_dim})")
        kernel = resolve_kernel(cfg.kernel, meta.ep)  # per-shard edges
        if kernel != cfg.kernel:
            log("kernel auto -> %s (%d edges/shard)", kernel, meta.ep)
            cfg = dataclasses.replace(cfg, kernel=kernel)
        if isinstance(cfg.overlap, str):
            # overlap="auto" as JAX resolves it off a TPU: hyb (and degree)
            # take an overlap plan, the edgewise path the combined one.
            cfg = dataclasses.replace(
                cfg, overlap=(cfg.overlap == "on" if cfg.overlap != "auto"
                              else kernel in ("hyb", "degree")))
        problem = _unsupported(cfg, n)
        if problem is not None:
            raise NotImplementedError(f"dorylus_tpu_torch ShardedEngine: {problem} "
                                      "(see ROADMAP.md)")
        if cfg.reuse == "auto":
            log("reuse auto -> off (the payoff gate's constants are TPU-fitted)")
            cfg = dataclasses.replace(cfg, reuse="off")
        overlap = bool(cfg.overlap) and n > 1
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.layers, self.cfg, self.meta, self.shard = layers, cfg, meta, shard
        self.kernel_selected = kernel
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.halo_plan = None
        if n > 1:
            # JAX: exact where the platform can; torch.distributed takes
            # per-pair split sizes on every backend.
            wire = "ragged" if cfg.halo == "auto" else cfg.halo
            self.halo_plan = HaloPlan(shard, n, wire, self.device)
        self.halo = make_halo_fn(self.halo_plan, overlap, n > 1)
        spmm_op = spmm_split = edge_op = None
        if kernel == "hyb":
            op = ShardedHybSpMM(
                shard, n, edges="fused" if overlap else "combined",
                static_vals=not gat,
                gather_dtype=torch.bfloat16 if cfg.agg_dtype == "bfloat16" else None,
                device=self.device)
            spmm_op, spmm_split = (None, op) if overlap else (op, None)
        else:
            if cfg.edge_chunk:
                log("edge_chunk ignored: the CSR kernels build no (E, F) "
                    "message tensor to bound")
            e = shard.num_edges
            edge_op = EdgeSpMM(shard.src[:e], shard.dst[:e],
                               meta.vp + n * meta.max_h, meta.vp, device=self.device)
        self.batch = shard_batch(shard, meta.denom, self.device,
                                 edge_arrays=edge_op is not None)
        if gat:
            self.model = GAT(layers, spmm_op=spmm_op, edge_op=edge_op,
                             spmm_split=spmm_split)
        else:
            self.model = GCN(layers, spmm_op=spmm_op,
                             optimize_order=cfg.optimize_order, edge_op=edge_op,
                             spmm_split=spmm_split)
        self.params = self.model.init_params(seed=cfg.seed)
        self.opt_state = adam_init(self.params) if cfg.adam else None
        self.report = RunReport()
        ghosts = 0 if self.halo_plan is None else int(self.halo_plan.recv_cnt.sum())
        log("dorylus_tpu_torch sharded engine, rank %d/%d on %s (%s): %s, %d local "
            "vertices, %d edges, %d ghosts, max_h %d, kernel %s, overlap %s, halo %s, "
            "agg %s", me, n, self.device, multihost.backend_name(), cfg.model,
            shard.num_local, shard.num_edges, ghosts, meta.max_h, kernel, overlap,
            "none" if self.halo_plan is None else self.halo_plan.wire, cfg.agg_dtype)

    def _stats(self, mask: torch.Tensor) -> tuple[float, float, float]:
        """(correct, loss, count) over the masked rows of every shard."""
        with torch.no_grad():
            probs = row_softmax(self.model.forward(self.batch, halo=self.halo))
            stats = torch.stack(accuracy_and_loss(probs, self.batch.onehot, mask))
            c, loss, cnt = multihost.all_reduce_sum(stats).tolist()
        return c, loss, cnt

    def _train_epoch(self, lr: float) -> torch.Tensor:
        cfg = self.cfg
        loss = self.model.loss(self.batch, self.compute_dtype, self.halo)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        # One buffer, one all-reduce: the weight gradients and the loss.
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        multihost.all_reduce_sum(flat)
        sizes = [g.numel() for g in grads]
        pieces = torch.split(flat, sizes + [1])
        grads = {k: p.view_as(g) for k, p, g in zip(names, pieces, grads)}
        if cfg.adam:
            self.params, self.opt_state = adam_update(
                self.params, grads, self.opt_state, lr=lr, beta1=cfg.beta1,
                beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
        else:
            self.params = sgd_update(self.params, grads, lr)
        return pieces[-1][0]

    def run(self, epochs: Optional[int] = None) -> RunReport:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        monitor = ConvergeMonitor(cfg.target_accuracy, cfg.switch_threshold)
        self.report.notes["kernel"] = self.kernel_selected
        self.report.notes["device"] = str(self.device)
        self.report.notes["shards"] = self.n
        t_run = time.perf_counter()
        flags = eval_flags(0, epochs, epochs, cfg)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            lr = (decay_lr(cfg.learning_rate, epoch, cfg.lr_decay_every,
                           cfg.lr_decay_factor)
                  if cfg.lr_decay_every else cfg.learning_rate)
            loss = self._train_epoch(lr)
            acc = None
            if flags[epoch]:
                c, vloss, cnt = self._stats(self.batch.val_mask)
                acc, vloss = c / max(1.0, cnt), vloss / max(1.0, cnt)
            loss_f = float(loss)  # waits for the device
            dt_ms = 1e3 * (time.perf_counter() - t0)
            if acc is not None and self.rank == 0:
                log("Epoch %d: %.2f ms, train loss %.4f, val acc %.4f, "
                    "val loss %.4f", epoch, dt_ms, loss_f, acc, vloss)
            self.report.add_epoch(EpochRecord(epoch, dt_ms, loss=loss_f,
                                              accuracy=acc))
            monitor.update(acc)
            if monitor.done:  # the same accuracy on every rank: all stop
                log("Target accuracy %.3f reached at epoch %d — stopping.",
                    cfg.target_accuracy, epoch)
                break
        self.report.notes["converge_state"] = monitor.state.name
        self.report.total_time_s = time.perf_counter() - t_run
        c, _, cnt = self._stats(self.batch.val_mask)
        self.report.final_accuracy = c / max(1.0, cnt)
        c, _, cnt = self._stats(self.batch.test_mask)
        self.report.test_accuracy = c / max(1.0, cnt)
        return self.report

    def profile(self, iters: int = 5) -> dict:
        raise NotImplementedError("ShardedEngine.profile: stage profiling is "
                                  "still to port (ROADMAP.md queue 1 item 11)")

    def output(self, path: Optional[str] = None) -> str:
        if path:
            self.report.write(path)
        return self.report.summary()

    def predict(self, softmax: bool = False) -> np.ndarray:
        """Per-vertex final-layer outputs (V, C) in GLOBAL vertex order,
        on every rank (each shard's rows gathered and placed through its
        global_ids)."""
        with torch.no_grad():
            local = self.model.forward(self.batch, halo=self.halo).float()
        stacked = multihost.all_gather_rows(local).cpu().numpy()  # (n, vp, C)
        gids = multihost.all_gather_rows(
            torch.tensor(self.shard.global_ids, device=self.device)).cpu().numpy()
        out = np.zeros((self.meta.num_vertices, stacked.shape[-1]), np.float32)
        live = gids >= 0
        out[gids[live]] = stacked[live]
        if softmax:
            e = np.exp(out - out.max(axis=1, keepdims=True))
            out = e / e.sum(axis=1, keepdims=True)
        return out
