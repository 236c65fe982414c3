"""The single-device training engine (port of dorylus_tpu/engine/engine.py
`Engine` and the sync path of `run_group_loop`).

The JAX engine compiles groups of epochs into one `lax.scan` call; PyTorch
runs eagerly, so here an epoch is a plain Python iteration: loss, backward,
Adam (or SGD) with the decay_lr schedule, then evaluation on the eval_every
cadence with the f32 forward on the updated params, the per-epoch log line,
and the converge state machine's early stop. The final val/test accuracy,
`predict` and the RunReport are as in JAX.

Scope: GCN on the static-mode hybrid-ELL kernel, synchronous (staleness 0).
Everything else raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig, resolve_kernel
from dorylus_tpu.common.logging import log
from dorylus_tpu.common.metrics import EpochRecord, RunReport
from dorylus_tpu.graph.graph import Graph
from dorylus_tpu_torch._shared import load
from dorylus_tpu_torch.engine.batch import build_batch
from dorylus_tpu_torch.models.gcn import GCN
from dorylus_tpu_torch.ops.activations import accuracy_and_loss, row_softmax
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
from dorylus_tpu_torch.optim.adam import adam_init, adam_update, decay_lr, sgd_update

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        (cfg.model != "gcn", f"model={cfg.model!r}: GAT is queue 1 item 6"),
        (kernel != "hyb", f"kernel={kernel!r}: the edgewise path is queue 1 "
                          "item 2, the degree kernel item 8"),
        (cfg.reuse == "pairs", "reuse='pairs': pair reuse is queue 1 item 9"),
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


class Engine:
    """Single-device engine: `Engine(graph, layers, cfg, device).run(n)`.

    device: where the graph, plans and params live; None picks "cuda" when
    a card is visible, else "cpu". On a CUDA device the aggregation runs
    the hand-written kernel (or raises); it never moves work to the CPU."""

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
            # The JAX payoff gate is calibrated on a TPU; off until re-fit.
            log("reuse auto -> off (pair reuse is not ported; ROADMAP.md)")
            cfg = dataclasses.replace(cfg, reuse="off")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # f32 layer matmuls in full f32, as JAX's f32 dot.
            torch.backends.cuda.matmul.allow_tf32 = False
        self.graph, self.layers, self.cfg = graph, layers, cfg
        self.kernel_selected = kernel
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        spmm_op = HybSpMM(graph.src, graph.dst, graph.num_vertices,
                          graph.num_vertices,
                          gather_dtype=(torch.bfloat16 if cfg.agg_dtype == "bfloat16"
                                        else None),
                          static_val=graph.edge_norm, device=self.device)
        # The static plan carries the edge values: ship COO stubs.
        self.batch = build_batch(graph, self.device, edge_arrays=False)
        self.model = GCN(layers, spmm_op=spmm_op, optimize_order=cfg.optimize_order)
        self.params = self.model.init_params(seed=cfg.seed)
        self.opt_state = adam_init(self.params) if cfg.adam else None
        self.report = RunReport()
        log("dorylus_tpu_torch engine on %s: %d vertices, %d edges, kernel "
            "%s, agg %s", self.device, graph.num_vertices, graph.num_edges,
            kernel, cfg.agg_dtype)

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
        monitor = load("engine/convergence.py").ConvergeMonitor(
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
