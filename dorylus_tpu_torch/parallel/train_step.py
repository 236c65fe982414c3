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

Scope: every kernel / overlap / reuse combination of the JAX engine on
the graph axis, for GCN and GAT, on both halo wire formats:

  kernel="hyb"     overlap on: the fused-overlap plan; off: the combined
                   plan (ops/hyb_sharded.py);
  kernel="degree"  overlap on: the (interior, boundary) plan pair; off: the
                   combined plan (ops/degree_sharded.py);
  kernel="xla"     (and "auto" up to 8M edges per shard) overlap on: the
                   edgewise split, two EdgeSpMM over the interior and the
                   boundary edges; off: EdgeSpMM over the shard's real
                   edges, gathering from `halo_exchange`'s table;
  overlap="auto"   (the default) per kernel from AUTO_OVERLAP: on for all
                   three on the card (JAX off a TPU: off for xla);
  reuse="pairs"    on hyb: the per-shard pair rewrite (ops/reuse_sharded.py)
                   on the combined table, which turns overlap off; on any
                   other kernel it is logged and off, as in JAX;
  reuse="auto"     JAX's payoff gate on the whole graph's counts, then the
                   pair rewrite, kept where the cut summed over the shards
                   clears REUSE_AUTO_MIN_CUT (engine/engine.py).

With an overlap plan the models get the ghost rows alone from the exchange,
in two steps (parallel/halo.py `Halo.start` / `finish`): each layer starts
the exchange, issues the work that reads the local rows alone (K8's pure
range, the degree pair's or the edgewise split's interior op) and only
then finishes it, so that work runs while the rows are in flight, as XLA
schedules JAX's ("XLA overlaps the all_to_all with local aggregation",
dorylus_tpu/parallel/train_step.py:14-15). The backward does the same with
the reverse exchange: HaloRecvFn's backward starts it once the ghost rows'
cotangent exists, autograd runs the layer's gradient work that does not
read it (the interior op's backward, the self term, GAT's attention
gradient), and the join on h (`HaloJoinFn`) finishes it, as XLA may
schedule JAX's `_planned_bwd` / `_ragged_bwd`. Gloo's thread moves the
bytes beside it; NCCL runs the collective on a side stream, forked and
joined by events, inside the epoch's CUDA graph too, both directions. The
combined plan and tensor parallelism call the exchange whole both ways.

The epoch loop is the single-device engine's group loop (`run_loop`), with
its bounded staleness, checkpoints and resume (JAX `parallel/train_step.py`
`:104-200`, `:495-516`), and every rank reads the group's losses and stats
once, as JAX's sharded `multi` returns them; every rank computes the same
groups. On the card with no process group or over NCCL, a group's epochs
replay the engine's CUDA graphs (engine/graphs.py, JAX's compiled
`make_multi`): the train graph holds the forward with its halo exchanges,
the backward with their reverse (enqueued by autograd's device thread; on
the overlap plans each forked in one node and joined in a later one), the
one all-reduce of the gradients and the loss, Adam and the window's roll;
the eval graph the forward and the sum of the stats. Nothing in either
reads the device from the host: the split sizes are fixed per plan and the
receive buffers come from the graph's pool, where they stay across
replays. The graphs are kept as long as the engine. Under gloo (and on the
CPU) the groups run eagerly (`eager_group`): gloo stages a CUDA tensor
through a host buffer, which a capture refuses; the engine's construction
log says which. `profile`, `predict` and the checkpoint's barrier stay
eager, outside any graph. A stale epoch runs its forward
and backward, the halo exchanges and their reverse included, on every rank
at the window's oldest copy, and its gradients go into the one flat
all-reduce; rank 0 writes a checkpoint and every rank waits for it at a
barrier before the next group; every rank loads on resume.

Tensor parallelism (cfg.feat_shards = m > 1; JAX's mesh of (n, m) with a
'feat' axis): the world of n * m ranks is a mesh (parallel/mesh.py), rank r
on graph shard r // m at feat index r % m. Each rank of a feat group holds
the same shard and aggregates an F/m column slice (models/gcn.py,
models/gat.py `_forward_tp`); the halo exchange runs over the graph group
at F/m. Every input and hidden width must divide m (JAX's refusal; nothing
is padded), and the overlap plans are off (the combined plan, as in JAX).
The reductions, each over its own group:

    weight gradients        the world (both axes: the feat ranks' W row
                            blocks assemble, the graph ranks' sums add)
    the loss                the graph group: the feat ranks hold the same
                            loss, so in the one flat buffer only feat index
                            0 adds it
    evaluation sums         the graph group
    predict                 a gather over the graph group (each shard once)

`profile` times the stages on the engine's plan (engine/profiling.py
`profile_stages_sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig, resolve_kernel
from dorylus_tpu_torch.common.logging import log
from dorylus_tpu_torch.common.metrics import RunReport
from dorylus_tpu_torch.engine.checkpoint import save_checkpoint
from dorylus_tpu_torch.engine.engine import (_DTYPES, _max_agg_width, below_reuse_floor,
                                             check_staleness, checkpoint_due, dispatch_group,
                                             epoch_graph_refusal, epoch_mode, gate_reuse_auto,
                                             resolve_device, resolve_reuse_budget, resume,
                                             run_graphed)
from dorylus_tpu_torch.graph.graph import Graph
from dorylus_tpu_torch.graph.partition import (Shard, ShardMeta, partition_graph,
                                               shard_edges)
from dorylus_tpu_torch.models.base import FeatAxis, GraphBatch, check_divisible
from dorylus_tpu_torch.models.gat import GAT
from dorylus_tpu_torch.models.gcn import GCN
from dorylus_tpu_torch.ops.activations import accuracy_and_loss, row_softmax
from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM, exchange_rank1_factor
from dorylus_tpu_torch.ops.spmm import EdgeSpMM
from dorylus_tpu_torch.optim.adam import adam_init, adam_update, sgd_update
from dorylus_tpu_torch.parallel import multihost
from dorylus_tpu_torch.parallel.halo import HaloPlan, make_halo_fn
from dorylus_tpu_torch.parallel.mesh import make_mesh

# overlap="auto" per kernel: True takes the kernel's overlap plan (hyb the
# fused plan, degree the (interior, boundary) pair, xla the edgewise split),
# False the combined plan. The values were fitted before the exchange ran
# beside the interior work, on device work alone: both plans ship the same
# bytes, and the one with less device work won.
# tools/switch_points.py measures that work: kernel ms per rank and step,
# the max over ranks, f32, the Reddit-shaped graph's 4- and 2-way range
# partitions on gloo ranks of one NVIDIA H100 80GB HBM3 (700.00 W), two
# runs pooled; a plan is taken where it wins by more than the spread for
# both models at both partitions, else JAX's off-TPU choice stays.
#   xla: the split wins everywhere (GCN 2.469 / 2.650 ms at 4 ranks, 4.241 /
#        4.613 at 2; GAT 2.928 / 3.064, 4.862 / 5.165): True (JAX: False).
#   hyb: fused below combined everywhere (GCN 2.421 / 2.540 at 4 ranks, GAT
#        2.558 / 2.683), but GCN's 4-rank gap is inside the combined plan's
#        spread (0.129 ms): JAX's True stays.
#   degree: GCN's pair wins (2.507 / 2.614), GAT's loses (2.780 / 2.748):
#        JAX's True stays.
# The overlap plans now also run the exchange beside their interior work,
# both ways, which can only add to their side. Re-fitting by wall time needs a card a
# rank (ROADMAP queue 2 point 4): on one card the gloo ranks' wall time is
# the host's transport, not the card's.
AUTO_OVERLAP = {"hyb": True, "degree": True, "xla": True}


def _unsupported(cfg: TrainConfig) -> Optional[str]:
    """The first configuration outside the ported slice, with its ROADMAP
    item, or None."""
    checks = [
        (cfg.model not in ("gcn", "gat"), f"model={cfg.model!r}"),
        (cfg.kernel not in ("hyb", "xla", "degree"), f"kernel={cfg.kernel!r}"),
        (cfg.param_dtype != "float32", f"param_dtype={cfg.param_dtype!r}"),
        (cfg.compute_dtype not in _DTYPES or cfg.agg_dtype not in _DTYPES,
         f"compute_dtype={cfg.compute_dtype!r} / agg_dtype={cfg.agg_dtype!r}"),
        (cfg.halo not in ("auto", "padded", "ragged"), f"halo={cfg.halo!r}"),
    ]
    return next((msg for bad, msg in checks if bad), None)


def shard_batch(shard: Shard, denom: float, device: torch.device,
                edge_arrays: bool, split: Optional[str] = None) -> GraphBatch:
    """One shard's GraphBatch on `device` (JAX `_local_batch`): vp rows,
    the shard's real edges (or zero-length stubs when the plans carry what
    aggregation reads), the global loss denominator. split: None (no
    overlap split: the six split fields stay None), "stubs" (zero-length
    split arrays: the split ops' plans carry what aggregation reads) or
    "edges" (the interior and boundary edges of the edgewise split)."""
    def t(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def edge_fields(names, src, dst, val):
        return dict(zip(names, (t(src, torch.int32), t(dst, torch.int32),
                                t(val, torch.float32))))

    src, dst, val = shard_edges(shard, "combined")
    e = len(src) if edge_arrays else 0
    fields = edge_fields(("src", "dst", "edge_val"), src[:e], dst[:e], val[:e])
    if split is not None:
        for part, names in (("interior", ("src_int", "dst_int", "val_int")),
                            ("boundary", ("src_bnd", "dst_bnd", "val_bnd"))):
            arrays = shard_edges(shard, part)
            if split == "stubs":
                arrays = tuple(a[:0] for a in arrays)
            fields.update(edge_fields(names, *arrays))
    return GraphBatch(
        x=t(shard.x, torch.float32), onehot=t(shard.onehot),
        self_val=t(shard.self_val, torch.float32),
        train_mask=t(shard.train_mask, torch.float32),
        val_mask=t(shard.val_mask, torch.float32),
        test_mask=t(shard.test_mask, torch.float32),
        denom=torch.tensor(np.float32(denom), device=device), **fields)


class ShardedEngine:
    """One rank of the sharded engine: the same surface as `Engine`, SPMD
    over the process group this process has joined (parallel/multihost.py
    `spawn_local` or `init_from_env`); without a group it is one shard.

    graph: the whole `Graph` (every rank partitions it the same way and
    keeps its own shard), or this rank's `(Shard, ShardMeta)` as
    `load_shard` returns it (the parent of a local launch partitions once;
    under tensor parallelism rank r holds shard r // feat_shards).
    device: None means the card, and raises when there is none; the CPU
    only when the caller passes "cpu"."""

    def __init__(self, graph: Graph | tuple[Shard, ShardMeta], layers: LayerConfig,
                 cfg: TrainConfig, device: str | torch.device | None = None,
                 partition_method: str = "range",
                 parts: Optional[np.ndarray] = None):
        m = max(1, cfg.feat_shards)
        if m > 1:
            for d in layers.dims[:-1]:
                check_divisible(d, m, "layer")
        # every rank makes the groups, in the same order
        self.mesh = make_mesh(cfg.num_shards if m > 1 and cfg.num_shards > 1 else None, m)
        n, me = self.mesh.n_shards, self.mesh.graph_index
        self.n, self.rank, self.world = n, multihost.rank(), multihost.world_size()
        gat = cfg.model == "gat"
        if isinstance(graph, tuple):
            shard, meta = graph
            if meta.n_shards != n or shard.shard_id != me:
                raise ValueError(f"shard {shard.shard_id} of {meta.n_shards} handed "
                                 f"to rank {self.rank}, graph shard {me} of {n}")
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
        if m > 1:
            # The column slices run the combined plan (the slice already
            # narrows the exchange, which is what overlap mostly buys).
            if cfg.overlap:
                cfg = dataclasses.replace(cfg, overlap=False)
            if self.rank == 0:
                log("tensor parallelism: %d feat shards x %d graph shards", m, n)
        problem = _unsupported(cfg)
        if problem is not None:
            raise NotImplementedError(f"dorylus_tpu_torch ShardedEngine: {problem} "
                                      "(see ROADMAP.md)")
        if isinstance(cfg.overlap, str):
            cfg = dataclasses.replace(
                cfg, overlap=(cfg.overlap == "on" if cfg.overlap != "auto"
                              else AUTO_OVERLAP[kernel]))
        check_staleness(cfg)
        reuse_on, reuse_cap = cfg.reuse in ("pairs", "auto") and kernel == "hyb", 0
        if cfg.reuse == "pairs" and not reuse_on:
            log("pair reuse requires kernel=hyb (have %s) — off", kernel)
        if reuse_on and cfg.reuse == "auto":
            # the payoff gate before mining, on the whole graph's counts
            # (mining is per shard but sums to the same edges)
            reuse_on = gate_reuse_auto(cfg, meta.num_vertices, meta.num_edges)
        # The table the models aggregate over: local then ghost rows; one
        # graph shard has no halo, so the model hands the vp local rows.
        table_rows = meta.vp + n * meta.max_h if n > 1 else meta.vp
        if reuse_on:
            # Budget against the per-shard GATHER table (local + ghost rows),
            # at the column slice a feat rank gathers.
            width = max(1, _max_agg_width(layers, cfg, table_rows) // m)
            reuse_cap, reuse_on = resolve_reuse_budget(cfg, table_rows, width)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self.halo_plan = None
        if n > 1:
            # JAX: exact where the platform can; torch.distributed takes
            # per-pair split sizes on every backend.
            wire = "ragged" if cfg.halo == "auto" else cfg.halo
            self.halo_plan = HaloPlan(shard, n, wire, self.device,
                                      group=self.mesh.graph_group)
        spmm_op = spmm_split = edge_op = edge_split = None
        gather_dtype = torch.bfloat16 if cfg.agg_dtype == "bfloat16" else None
        kw = dict(gather_dtype=gather_dtype, device=self.device)
        if reuse_on:
            f_local = np.sqrt(shard.self_val)
            f_in = (None if gat else f_local if self.halo_plan is None
                    else exchange_rank1_factor(f_local, self.halo_plan))
            spmm_op = ShardedReuseSpMM(shard, n, rank1_factor=f_in, passes=cfg.reuse_passes,
                                       max_pairs=reuse_cap, **kw)
            st = spmm_op.plan_fwd.stats
            # the floor reads the cut over every shard, as JAX sums it
            rows = torch.tensor([st["rows_before"], st["rows_after"]], dtype=torch.int64,
                                device=self.device)
            rows_b, rows_a = multihost.all_reduce_sum(rows, self.mesh.graph_group).tolist()
            if below_reuse_floor(cfg, 1 - rows_a / max(1, rows_b), "sharded row cut"):
                spmm_op, reuse_on = None, False
            else:
                log("sharded pair reuse, rank %d: %d fwd pairs, gathered rows %d -> %d "
                    "(-%.1f%%)", me, spmm_op.num_pairs, st["rows_before"],
                    st["rows_after"], 100 * st["row_reduction"])
        if reuse_on and cfg.overlap and n > 1:
            # A pair may combine an interior and a ghost row: reuse runs the
            # combined-plan path.
            cfg = dataclasses.replace(cfg, overlap=False)
            log("pair reuse: interior/boundary overlap split disabled (rewrites "
                "span the combined edge set)")
        overlap = bool(cfg.overlap) and n > 1
        self.layers, self.cfg, self.meta, self.shard = layers, cfg, meta, shard
        self.kernel_selected = kernel
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.halo = make_halo_fn(self.halo_plan, overlap, n > 1)
        if reuse_on:
            pass  # the rewrite, kept above
        elif kernel == "hyb":
            op = ShardedHybSpMM(shard, n, edges="fused" if overlap else "combined",
                                static_vals=not gat, **kw)
            spmm_op, spmm_split = (None, op) if overlap else (op, None)
        elif kernel == "degree":
            if overlap:
                # The models never touch the combined plan on this path:
                # it is not built.
                spmm_split = tuple(ShardedDegreeSpMM(shard, n, edges=e, static_vals=not gat,
                                                     **kw)
                                   for e in ("interior", "boundary"))
            else:
                spmm_op = ShardedDegreeSpMM(shard, n, static_vals=not gat, **kw)
        else:
            if cfg.edge_chunk:
                log("edge_chunk ignored: the CSR kernels build no (E, F) "
                    "message tensor to bound")
            if overlap:
                edge_split = tuple(
                    EdgeSpMM(*shard_edges(shard, e)[:2], rows, meta.vp, device=self.device)
                    for e, rows in (("interior", meta.vp), ("boundary", n * meta.max_h)))
            else:
                edge_op = EdgeSpMM(*shard_edges(shard, "combined")[:2], table_rows,
                                   meta.vp, device=self.device)
        # With an overlap plan the batch carries the split: zero-length
        # stubs where the plans hold what aggregation reads (the JAX rule),
        # the interior and boundary edges for the edgewise split.
        split = None if not overlap else "edges" if edge_split is not None else "stubs"
        self.batch = shard_batch(shard, meta.denom, self.device,
                                 edge_arrays=edge_op is not None, split=split)
        model_kw = dict(spmm_op=spmm_op, edge_op=edge_op, spmm_split=spmm_split,
                        edge_split=edge_split,
                        tp=FeatAxis(m, self.mesh.feat_index, self.mesh.feat_group)
                        if m > 1 else None)
        if gat:
            self.model = GAT(layers, **model_kw)
        else:
            self.model = GCN(layers, optimize_order=cfg.optimize_order, **model_kw)
        self.params = self.model.init_params(seed=cfg.seed)
        self.opt_state = adam_init(self.params) if cfg.adam else None
        self.report = RunReport()
        self._windows: dict = {}
        resume(self)  # every rank loads
        self.graph_refusal = epoch_graph_refusal(self.device, multihost.backend_name())
        ghosts = 0 if self.halo_plan is None else int(self.halo_plan.recv_cnt.sum())
        log("dorylus_tpu_torch sharded engine, rank %d/%d (shard %d/%d, feat %d/%d) on %s "
            "(%s): %s, %d local vertices, %d edges, %d ghosts, max_h %d, kernel %s, "
            "overlap %s, halo %s, agg %s, epochs %s", self.rank, self.world, me, n,
            self.mesh.feat_index, m, self.device, multihost.backend_name(), cfg.model,
            shard.num_local, shard.num_edges, ghosts, meta.max_h, kernel, overlap,
            "none" if self.halo_plan is None else self.halo_plan.wire, cfg.agg_dtype,
            epoch_mode(self.graph_refusal))

    _graphs = None  # the engine's EpochGraphs, on the card

    def _stats(self, mask: torch.Tensor) -> torch.Tensor:
        """(3,) on the device: correct, loss, count over the masked rows of
        every shard (each shard once: summed over the graph group)."""
        with torch.no_grad():
            probs = row_softmax(self.model.forward(self.batch, halo=self.halo))
            stats = torch.stack(accuracy_and_loss(probs, self.batch.onehot, mask))
            return multihost.all_reduce_sum(stats, self.mesh.graph_group)

    def _train_epoch(self, lr: float | None, stale: Optional[dict] = None,
                     lr_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update on every rank; the gradients are taken at `stale`
        (the staleness window's oldest copy) when given, else at the
        current params. lr_t: a 0-dim device tensor that holds the step's
        rate (Adam's bias-corrected lr_t, SGD's lr), in place of lr (a
        captured epoch)."""
        cfg = self.cfg
        at = self.params if stale is None else stale
        loss = self.model.loss(self.batch, self.compute_dtype, self.halo, params=stale)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [at[k] for k in names])
        # One buffer, one all-reduce over the world: the weight gradients and
        # the loss, which feat index 0 alone adds (the feat ranks hold the
        # same loss: summed over the graph group only).
        loss = loss.detach().reshape(1)
        if self.mesh.feat_index:
            loss = torch.zeros_like(loss)
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss])
        multihost.all_reduce_sum(flat)
        sizes = [g.numel() for g in grads]
        pieces = torch.split(flat, sizes + [1])
        grads = {k: p.view_as(g) for k, p, g in zip(names, pieces, grads)}
        if cfg.adam:
            self.params, self.opt_state = adam_update(
                self.params, grads, self.opt_state, lr=lr, beta1=cfg.beta1,
                beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay, lr_t=lr_t)
        else:
            self.params = sgd_update(self.params, grads, lr if lr_t is None else lr_t)
        return pieces[-1][0]

    def _dispatch(self, lrs: list, flags: np.ndarray, window) -> tuple:
        return dispatch_group(self, lrs, flags, window)

    def _maybe_checkpoint(self, epoch: int) -> None:
        """Rank 0 writes; every rank waits for the file before the next
        epoch, so none can resume from a half-written one."""
        if not checkpoint_due(self.cfg, epoch):
            return
        if self.rank == 0:
            save_checkpoint(self.cfg.checkpoint_dir, epoch + 1, self.params,
                            self.opt_state)
        multihost.barrier(self.device)

    def run(self, epochs: Optional[int] = None, graphs: bool = True) -> RunReport:
        """`Engine.run` on every rank: the epochs replayed as the engine's
        kept CUDA graphs where it captures (`graph_refusal` is None),
        eagerly with graphs=False, which drops them. Every rank must call
        it with the same arguments."""
        self.report.notes["shards"] = self.n
        if self.mesh.feat_shards > 1:
            self.report.notes["feat_shards"] = self.mesh.feat_shards
        return run_graphed(self, epochs, graphs)

    def profile(self, iters: int = 5) -> dict:
        """Per-stage times in ms (engine/profiling.py
        `profile_stages_sharded`; JAX `ShardedEngine.profile`), the same on
        every rank; they also land in report.stage_times. Every rank must
        call it."""
        from dorylus_tpu_torch.engine.profiling import profile_stages_sharded, stage_times

        times = profile_stages_sharded(self, iters=iters)
        self.report.stage_times = stage_times(times, iters)
        return times

    def output(self, path: Optional[str] = None) -> str:
        if path:
            self.report.write(path)
        return self.report.summary()

    def predict(self, softmax: bool = False) -> np.ndarray:
        """Per-vertex final-layer outputs (V, C) in GLOBAL vertex order,
        on every rank (each shard's rows gathered over the graph group and
        placed through its global_ids)."""
        grp = self.mesh.graph_group
        with torch.no_grad():
            local = self.model.forward(self.batch, halo=self.halo).float()
        stacked = multihost.all_gather_rows(local, grp).cpu().numpy()  # (n, vp, C)
        gids = multihost.all_gather_rows(
            torch.tensor(self.shard.global_ids, device=self.device), grp).cpu().numpy()
        out = np.zeros((self.meta.num_vertices, stacked.shape[-1]), np.float32)
        live = gids >= 0
        out[gids[live]] = stacked[live]
        if softmax:
            e = np.exp(out - out.max(axis=1, keepdims=True))
            out = e / e.sum(axis=1, keepdims=True)
        return out

    def dump_predictions(self, path: str, softmax: bool = False) -> None:
        """Per-vertex final-layer outputs in global vertex order, one line
        per vertex (JAX `ShardedEngine.dump_predictions`). Every rank takes
        part in the gather; rank 0 writes."""
        out = self.predict(softmax=softmax)
        if self.rank == 0:
            np.savetxt(path, out, fmt="%.6f")
