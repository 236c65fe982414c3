"""The single-device training engine (port of dorylus_tpu/engine/engine.py
`Engine` and the sync path of `run_group_loop`).

The JAX engine compiles groups of epochs into one `lax.scan` call; PyTorch
runs eagerly, so here an epoch is a plain Python iteration: loss, backward,
Adam (or SGD) with the decay_lr schedule, then evaluation on the eval_every
cadence with the f32 forward on the updated params, the per-epoch log line,
and the converge state machine's early stop. The final val/test accuracy,
`predict` and the RunReport are as in JAX.

Scope, synchronous (staleness 0): GCN and GAT on kernel="hyb" (GCN on the
static-mode hybrid-ELL kernel, GAT on its mask mode), on kernel="degree"
(the degree-padded plans on the same kernels), on kernel="hyb" with
reuse="pairs" (the pair-reuse rewrite: the pair-table kernel, then the
mask pass) and on kernel="xla" (the edgewise CSR kernels), with
kernel="auto" resolved by `resolve_kernel` as in JAX (xla up to 8M edges,
hyb past). Everything else raises NotImplementedError naming its
ROADMAP.md item.

reuse="pairs" sizes its pair budget as JAX does (`resolve_reuse_budget`,
`_max_agg_width`, copied below with the 64 MiB gather-cliff constant, so
both packages mine the same rewrite). reuse="auto" stays off: JAX's payoff
gate is calibrated on a TPU.
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
from dorylus_tpu_torch.graph.graph import Graph
from dorylus_tpu_torch.engine.convergence import ConvergeMonitor
from dorylus_tpu_torch.engine.batch import build_batch
from dorylus_tpu_torch.models.gat import GAT
from dorylus_tpu_torch.models.gcn import GCN
from dorylus_tpu_torch.ops.activations import accuracy_and_loss, row_softmax
from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
from dorylus_tpu_torch.ops.spmm import EdgeSpMM
from dorylus_tpu_torch.optim.adam import adam_init, adam_update, decay_lr, sgd_update

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The JAX engine's switch to dst-blocked edgewise aggregation
# (engine/engine.py:445-457) and its block size (ops/spmm.py
# build_dst_blocks): the port routes that branch to the same CSR op.
_DST_BLOCKED_VERTICES = 400_000
_DST_BLOCK_ROWS = 131072

# The JAX package's bf16 gather-table cliff (models/gcn.py AGG_CLIFF_BYTES),
# measured on a TPU v5e and to be re-fit on the H100. It is kept for one
# reason: the pair budget below derives from it, and both packages must
# mine the same rewrite (as hyb_plan.py keeps _LAMBDA_SLOTS).
AGG_CLIFF_BYTES = 64 << 20


def past_agg_cliff(gather_itemsize: int, n_rows: int, narrow_width: int) -> bool:
    """JAX models/gcn.py `past_agg_cliff` on a gather itemsize: a bf16
    table of (n_rows, narrow_width) past the cliff. The port's models do
    not reorder on it; only the pair budget's width estimate reads it."""
    return (narrow_width < 128 and gather_itemsize == 2
            and n_rows * narrow_width * 2 >= AGG_CLIFF_BYTES)


def _max_agg_width(layers: LayerConfig, cfg: TrainConfig,
                   num_vertices: int = 0) -> int:
    """Widest feature dim the SpMM will see (a copy of JAX
    engine/engine.py `_max_agg_width`): GCN with optimize_order
    aggregates at min(in, out) per layer, GAT at the output width; past
    the cliff a layer whose input fits 128 lanes counts at its input
    width, as JAX's regime rule would aggregate it there."""
    item = 2 if cfg.agg_dtype == "bfloat16" else 4
    dims = layers.dims
    widths = []
    if cfg.model == "gat":
        for a, b in zip(dims, dims[1:]):
            w = b
            if num_vertices and a <= 128 and past_agg_cliff(item, num_vertices, b):
                w = max(w, a)
            widths.append(w)
        return max(widths)
    if cfg.optimize_order:
        for a, b in zip(dims, dims[1:]):
            w = min(a, b)
            if (num_vertices and a > b and a <= 128
                    and past_agg_cliff(item, num_vertices, b)):
                w = a
            widths.append(w)
        return max(widths)
    return max(dims[:-1])


def resolve_reuse_budget(cfg: TrainConfig, base_rows: int,
                         width: int) -> tuple[int, bool]:
    """(max_pairs, enabled) for the pair-reuse rewrite (a copy of JAX
    engine/engine.py `resolve_reuse_budget`). reuse_max_pairs = -1
    (auto): when the base gather table sits below the cliff, cap the
    appended pair rows per pass so the table stays under it; a per-pass
    auto budget under 1,024 rows disables reuse; past the cliff no cap.
    An explicit budget (>= 0; 0 = unlimited) is honored."""
    item = 2 if cfg.agg_dtype == "bfloat16" else 4
    cap = cfg.reuse_max_pairs
    if cap < 0:
        if base_rows * width * item < AGG_CLIFF_BYTES:
            passes = max(1, cfg.reuse_passes)
            cap = (AGG_CLIFF_BYTES // (width * item) - base_rows) // passes
            if cap < 1024:  # includes 0 — too small to ever pay
                log("reuse auto pair budget %d/pass is too small to pay "
                    "(< 1024) — reuse off; pass --reuse-max-pairs to "
                    "force", cap)
                return max(cap, 0), False
            log("reuse auto pair budget: %d per pass x %d pass(es) "
                "(keeps the %d-wide table under the gather cliff)",
                cap, passes, width)
        else:
            cap = 0  # already past the cliff: unlimited
    return max(cap, 0), True


def eval_flags(epoch: int, k: int, end: int, cfg: TrainConfig) -> np.ndarray:
    """(k,) bool: which of epochs [epoch, epoch+k) evaluate (the eval_every
    cadence, plus always the final epoch)."""
    eps = np.arange(epoch, epoch + k)
    if not cfg.eval_every:
        return np.zeros(k, bool)
    return (eps % cfg.eval_every == 0) | (eps == end - 1)


def _unsupported(cfg: TrainConfig, kernel: str) -> Optional[str]:
    """The first configuration outside the ported slice, with its ROADMAP
    item, or None."""
    checks = [
        (cfg.model not in ("gcn", "gat"), f"model={cfg.model!r}"),
        (kernel not in ("hyb", "xla", "degree"), f"kernel={kernel!r}"),
        (bool(cfg.staleness), f"staleness={cfg.staleness}: bounded staleness "
                              "is still to port (queue 1 item 3)"),
        (bool(cfg.checkpoint_dir) or cfg.resume,
         "checkpoint_dir/resume: checkpoint interop is queue 1 item 7"),
        (cfg.num_shards > 1 or cfg.feat_shards > 1,
         "num_shards/feat_shards > 1: the sharded engine is queue 1 items "
         "12-13"),
        (cfg.param_dtype != "float32", f"param_dtype={cfg.param_dtype!r}"),
        (cfg.compute_dtype not in _DTYPES or cfg.agg_dtype not in _DTYPES,
         f"compute_dtype={cfg.compute_dtype!r} / agg_dtype={cfg.agg_dtype!r}"),
    ]
    return next((msg for bad, msg in checks if bad), None)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an engine runs on: None means the card and raises when
    there is none; nothing falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dorylus_tpu_torch runs on the card by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" to "
                "run on the CPU")
        device = "cuda"
    return torch.device(device)


class Engine:
    """Single-device engine: `Engine(graph, layers, cfg, device).run(n)`.

    device: where the graph, plans and params live. None means the card
    ("cuda"), and raises when no card is visible; the CPU is used only
    when the caller passes device="cpu". On a CUDA device the aggregation
    runs the hand-written kernel (or raises); it never moves work to the
    CPU."""

    def __init__(self, graph: Graph, layers: LayerConfig, cfg: TrainConfig,
                 device: str | torch.device | None = None):
        if layers.feature_dim != graph.features.shape[1]:
            raise ValueError("feature dim mismatch vs layer config "
                             f"({graph.features.shape[1]} vs {layers.feature_dim})")
        kernel = resolve_kernel(cfg.kernel, graph.num_edges)
        if kernel != cfg.kernel:
            log("kernel auto -> %s (%d edges)", kernel, graph.num_edges)
            cfg = dataclasses.replace(cfg, kernel=kernel)
        problem = _unsupported(cfg, kernel)
        if problem is not None:
            raise NotImplementedError(f"dorylus_tpu_torch Engine: {problem} "
                                      "(see ROADMAP.md)")
        if cfg.reuse == "auto":
            # JAX's payoff gate (engine/engine.py reuse_payoff) is fitted on
            # a TPU; off until re-fit on the H100. At the Reddit scale the
            # JAX gate itself mines only past ~373 GCN epochs, so both
            # packages train without reuse at the default 100.
            log("reuse auto -> off (the payoff gate's constants are "
                "TPU-fitted; --reuse pairs forces the rewrite)")
            cfg = dataclasses.replace(cfg, reuse="off")
        if cfg.reuse == "pairs" and kernel != "hyb":
            log("pair reuse requires kernel=hyb (have %s) — off", kernel)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 layer matmuls in full f32, as JAX's f32 dot.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.graph, self.layers, self.cfg = graph, layers, cfg
        self.kernel_selected = kernel
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        gat = cfg.model == "gat"
        v = graph.num_vertices
        spmm_op = edge_op = None
        blk_rows = 0
        gather_dtype = torch.bfloat16 if cfg.agg_dtype == "bfloat16" else None
        if kernel == "hyb" and cfg.reuse == "pairs":
            width = _max_agg_width(layers, cfg, v)
            cap, reuse_on = resolve_reuse_budget(cfg, v, width)
            if reuse_on:
                # Exact for both models' unit-weight inner sums: GCN through
                # its rank-1 norm factor f = sqrt(self_norm), GAT through
                # its dst-only attention.
                spmm_op = ReuseSpMM(graph.src, graph.dst, v, v,
                                    gather_dtype=gather_dtype,
                                    rank1_factor=(None if gat
                                                  else np.sqrt(graph.self_norm)),
                                    passes=cfg.reuse_passes, max_pairs=cap,
                                    device=self.device)
                st = spmm_op.plan_fwd.stats
                log("pair reuse: %d fwd pairs, gathered rows %d -> %d (-%.1f%%)",
                    spmm_op.plan_fwd.num_pairs, st["rows_before"], st["rows_after"],
                    100 * st["row_reduction"])
        if kernel in ("hyb", "degree") and spmm_op is None:
            # GCN: static plans with the norms baked in; GAT: plans without
            # values (dst-functional attention needs no per-edge values).
            op_cls = HybSpMM if kernel == "hyb" else DegreeSpMM
            spmm_op = op_cls(graph.src, graph.dst, v, v, gather_dtype=gather_dtype,
                             static_val=None if gat else graph.edge_norm,
                             device=self.device)
        elif kernel == "xla":
            # As in JAX, the edgewise path ignores agg_dtype: it gathers in
            # the compute dtype.
            if cfg.edge_chunk:
                log("edge_chunk ignored: the CSR kernels build no (E, F) "
                    "message tensor to bound")
            edge_op = EdgeSpMM(graph.src, graph.dst, v, v, device=self.device)
            if v > _DST_BLOCKED_VERTICES:
                blk_rows = _DST_BLOCK_ROWS
                self.kernel_selected = "xla+dst_blocked"
                log("dst-blocked aggregation -> the CSR op (one writer per "
                    "row needs no blocking)")
        # The slot plans carry what aggregation reads (GCN: static values or
        # the rank-1 factor; GAT: dst-functional): ship COO stubs (the JAX
        # rule); the edgewise path reads the COO arrays.
        stubbed = spmm_op is not None and (gat or spmm_op.has_static_vals)
        self.batch = build_batch(graph, self.device, for_gat=gat,
                                 edge_arrays=not stubbed)
        if gat:
            self.model = GAT(layers, spmm_op=spmm_op, edge_op=edge_op,
                             blk_rows=blk_rows)
        else:
            self.model = GCN(layers, spmm_op=spmm_op,
                             optimize_order=cfg.optimize_order, edge_op=edge_op,
                             blk_rows=blk_rows)
        self.params = self.model.init_params(seed=cfg.seed)
        self.opt_state = adam_init(self.params) if cfg.adam else None
        self.report = RunReport()
        log("dorylus_tpu_torch engine on %s: %s, %d vertices, %d edges, "
            "kernel %s, agg %s", self.device, cfg.model, graph.num_vertices,
            graph.num_edges, self.kernel_selected, cfg.agg_dtype)

    def _evaluate(self, mask: torch.Tensor) -> tuple[float, float, float]:
        with torch.no_grad():
            probs = row_softmax(self.model.forward(self.batch))
            c, loss, n = accuracy_and_loss(probs, self.batch.onehot, mask)
        return float(c), float(loss), float(n)

    def _train_epoch(self, lr: float) -> torch.Tensor:
        cfg = self.cfg
        loss = self.model.loss(self.batch, self.compute_dtype)
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [self.params[k] for k in names])))
        if cfg.adam:
            self.params, self.opt_state = adam_update(
                self.params, grads, self.opt_state, lr=lr, beta1=cfg.beta1,
                beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
        else:
            self.params = sgd_update(self.params, grads, lr)
        return loss.detach()

    def run(self, epochs: Optional[int] = None) -> RunReport:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        monitor = ConvergeMonitor(
            cfg.target_accuracy, cfg.switch_threshold)
        self.report.notes["kernel"] = self.kernel_selected
        self.report.notes["device"] = str(self.device)
        t_run = time.perf_counter()
        # Like the JAX engine, every run() numbers its epochs from 0 (LR
        # schedule, eval cadence) while Adam's step counter carries on.
        flags = eval_flags(0, epochs, epochs, cfg)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            lr = (decay_lr(cfg.learning_rate, epoch, cfg.lr_decay_every,
                           cfg.lr_decay_factor)
                  if cfg.lr_decay_every else cfg.learning_rate)
            loss = self._train_epoch(lr)
            acc = None
            if flags[epoch]:
                c, vloss, n = self._evaluate(self.batch.val_mask)
                acc, vloss = c / max(1.0, n), vloss / max(1.0, n)
            loss_f = float(loss)  # waits for the device
            dt_ms = 1e3 * (time.perf_counter() - t0)
            if acc is not None:
                log("Epoch %d: %.2f ms, train loss %.4f, val acc %.4f, "
                    "val loss %.4f", epoch, dt_ms, loss_f, acc, vloss)
            self.report.add_epoch(EpochRecord(epoch, dt_ms, loss=loss_f,
                                              accuracy=acc))
            monitor.update(acc)
            if monitor.done:
                log("Target accuracy %.3f reached at epoch %d — stopping.",
                    cfg.target_accuracy, epoch)
                break
        self.report.notes["converge_state"] = monitor.state.name
        self.report.total_time_s = time.perf_counter() - t_run
        c, _, n = self._evaluate(self.batch.val_mask)
        self.report.final_accuracy = c / max(1.0, n)
        c, _, n = self._evaluate(self.batch.test_mask)
        self.report.test_accuracy = c / max(1.0, n)
        return self.report

    def predict(self, softmax: bool = False) -> np.ndarray:
        """Per-vertex final-layer outputs (V, C): raw logits by default,
        softmax rows if asked."""
        with torch.no_grad():
            out = (self.model.predict(self.batch) if softmax
                   else self.model.forward(self.batch))
        return out.cpu().numpy()
