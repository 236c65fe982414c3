"""The single-device training engine (port of dorylus_tpu/engine/engine.py
`Engine` and `run_group_loop`).

Epochs run in groups, as JAX's compiled `lax.scan` calls do (`run_loop`,
which both engines share): `group_len` cuts the run at the last epoch, at
an eval epoch when a target accuracy is set, at a checkpoint epoch and at
`epochs_per_call` (0: AUTO_GROUP_CAP), and the engine's `_dispatch` runs a
group's epochs, each one loss, backward, Adam (or SGD) with the decay_lr
schedule, then, on the epochs `eval_flags` picks, evaluation with the f32
forward on the updated params. The group's losses and stats stay on the
device; the loop reads them once a group, logs each evaluated epoch, adds
one record per epoch at the group's wall time over k, checkpoints at the
group's last epoch and feeds the converge state machine (the switch to
synchronous training, the early stop) the group's last accuracy. On the
card both engines replay the epoch as CUDA graphs (engine/graphs.py), kept
from one run() to the next as JAX keeps its compiled groups; on the CPU,
and in a sharded engine over gloo, the group runs eagerly. The final
val/test accuracy, `predict`, `dump_predictions` and the RunReport are as
in JAX.

Bounded staleness (staleness = S > 0; the reference's async pipeline,
pipeline.cpp:95-102, with weight stashing): `StaleWindow` holds S+1
detached copies of the params; each epoch takes its gradients at the
oldest (up to S epochs old) through `torch.func.functional_call`, Adam
applies them to the current params, and the window rolls. Every `run()`
starts the window afresh from the params it holds, as JAX's does (the
window is not stored in a checkpoint): the engine keeps one window per
staleness and refills it in place (`stale_window`), so a kept graph reads
the same copies. staleness 0 or None is synchronous.

Checkpoints (engine/checkpoint.py) hold the params and the Adam state in
the JAX package's npz layout; `resume=True` loads the latest and numbers
the epochs on from its step (LR schedule, eval cadence, checkpoint steps),
as JAX's `start_epoch` does.

Scope: GCN and GAT on kernel="hyb" (GCN on the static-mode hybrid-ELL
kernel, GAT on its mask mode), on kernel="degree" (the degree-padded plans
on the same kernels), on kernel="hyb" with reuse="pairs" (the pair-reuse
rewrite: the pair-table kernel, then the mask pass) and on kernel="xla"
(the edgewise CSR kernels), with kernel="auto" resolved by
`resolve_kernel` as in JAX (xla up to 8M edges, hyb past). Everything else
raises NotImplementedError naming its ROADMAP.md item.

reuse="pairs" sizes its pair budget as JAX does (`resolve_reuse_budget`,
`_max_agg_width`, copied below with the 64 MiB gather-cliff constant, so
both packages mine the same rewrite). reuse="auto" runs JAX's payoff gate
before mining (`gate_reuse_auto`) and its row-cut floor after it
(`REUSE_AUTO_MIN_CUT`), with the gate's constants fitted on the H100.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig, resolve_kernel
from dorylus_tpu_torch.common.device import resolve_device
from dorylus_tpu_torch.common.logging import log
from dorylus_tpu_torch.common.metrics import EpochRecord, RunReport, span
from dorylus_tpu_torch.graph.graph import Graph
from dorylus_tpu_torch.engine.batch import build_batch
from dorylus_tpu_torch.engine.checkpoint import (latest_checkpoint, load_checkpoint,
                                                 save_checkpoint)
from dorylus_tpu_torch.engine.convergence import ConvergeMonitor
from dorylus_tpu_torch.interop import adam_state_from_numpy, params_from_numpy
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


# reuse="auto" (JAX engine/engine.py:75-135, the same arithmetic): the
# payoff gate before mining, then the row-cut floor after it. The
# constants are the card's, fitted on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit from `python -m dorylus_tpu_torch.cli bench` (its reuse_*
# cells) and chip_smoke.py phases 4e and 12b (PERF.md §6). On the
# card the rewrite saves nothing, so the gate never opens: its log line
# shows the 0 s/row.
#
# Minimum mined row cut to keep the rewrite: JAX's value. The card's cells
# show cuts of 29.8% and 32.8% losing (below): no cut wins, so there is no
# winning cut to move the floor to, and the shut gate never reaches it.
REUSE_AUTO_MIN_CUT = 0.10
# Seconds an epoch saves per gathered row the rewrite cuts, (epoch off -
# epoch pairs) / (row cut x V), GCN on the Reddit-size community graph (a
# 29.8% cut): the bench's pair read 9.390 ms off against 11.353 with pairs
# (-2.8e-8 s/row) and 9.619 against 14.924 (-7.6e-8); its 1.6M-vertex pass
# pair (a 32.8% cut) 1.565 ms plain against 3.041 with K6 + K2. No saving:
# 0.
REUSE_SAVE_S_PER_ROW = 0.0
# Each model's saving per row over GCN's. GAT's pair saves nothing either
# (chip_smoke.py phase 4e: warm epoch 8.338 ms with pairs against 7.963
# off, train step 5.885 against 5.142): 0.
REUSE_MODEL_EFF = {"gcn": 1.0, "gat": 0.0}
# The best mined cut ever observed plus a margin: a property of mined
# graphs, JAX's value.
REUSE_CUT_CAP = 0.45
# The miner's seconds per edge on the card's host (the numpy miner: the
# host cannot build native/libgraphcore.so), both directions and both
# plans, at the slower of the two graphs: the Reddit-size community graph's
# ReuseSpMM build, 7.89 and 8.51 s over 11,619,013 edges (the 1.6M-vertex
# graph's forward mining, two passes, 15.2 s over 23,940,344).
REUSE_MINE_S_PER_EDGE = 7.3e-7


def reuse_payoff(cfg: TrainConfig, num_vertices: int,
                 num_edges: int) -> tuple[bool, float, float]:
    """Pre-mine gate for reuse="auto": (worth_mining, ceiling_s, mine_s)
    (JAX `reuse_payoff`). ceiling_s is the best-case saving over
    cfg.epochs (the cut capped at REUSE_CUT_CAP, scaled by the model's
    efficiency); mine_s the predicted cost of mining."""
    eff = REUSE_MODEL_EFF.get(cfg.model, 1.0)
    ceiling = (REUSE_CUT_CAP * num_vertices * REUSE_SAVE_S_PER_ROW
               * eff * max(1, cfg.epochs))
    mine = num_edges * REUSE_MINE_S_PER_EDGE
    return ceiling >= mine, ceiling, mine


def gate_reuse_auto(cfg: TrainConfig, num_vertices: int,
                    num_edges: int) -> bool:
    """The reuse="auto" pre-mine gate with its decision log (JAX
    `gate_reuse_auto`), shared by Engine and ShardedEngine."""
    worth, ceiling, mine = reuse_payoff(cfg, num_vertices, num_edges)
    if not worth:
        log("reuse auto: predicted saving ceiling %.2fs "
            "(cut<=%.2f x %d rows x %.1e s/row x eff %.2f x "
            "%d epochs) < mine cost %.2fs (%d edges x %.1e "
            "s/edge) — skipping mining; --reuse pairs forces",
            ceiling, REUSE_CUT_CAP, num_vertices,
            REUSE_SAVE_S_PER_ROW,
            REUSE_MODEL_EFF.get(cfg.model, 1.0), cfg.epochs,
            mine, num_edges, REUSE_MINE_S_PER_EDGE)
    return worth


def below_reuse_floor(cfg: TrainConfig, cut: float, what: str = "row cut") -> bool:
    """reuse="auto"'s floor after mining: True (with JAX's log line) where
    the mined cut is below REUSE_AUTO_MIN_CUT and the run takes plain
    hyb."""
    if cfg.reuse != "auto" or cut >= REUSE_AUTO_MIN_CUT:
        return False
    log("reuse auto: %s %.1f%% below the %.0f%% profitability floor — plain hyb",
        what, 100 * cut, 100 * REUSE_AUTO_MIN_CUT)
    return True


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


# Auto group size (epochs_per_call=0), JAX's: it bounds how long a group
# runs between progress lines. JAX's second auto cap, by edges
# (AUTO_GROUP_EDGE_BUDGET), keeps a call under the remote TPU's watchdog
# and is not ported.
AUTO_GROUP_CAP = 25


def group_len(epoch: int, end: int, cfg: TrainConfig) -> int:
    """Epochs of the group that starts at `epoch` (JAX `group_len`): it ends
    at the last epoch, at an eval epoch when target_accuracy must inspect
    it, at a checkpoint epoch, and at epochs_per_call (0: AUTO_GROUP_CAP;
    1: one epoch a group)."""
    if epoch >= end:  # empty range: run(0) is a no-op, not a hang
        return 0
    if cfg.epochs_per_call == 1:
        return 1
    cap = cfg.epochs_per_call if cfg.epochs_per_call else AUTO_GROUP_CAP
    k = 1
    while True:
        ep = epoch + k - 1
        if ep == end - 1:
            break
        if cfg.target_accuracy and cfg.eval_every and ep % cfg.eval_every == 0:
            break
        if checkpoint_due(cfg, ep):
            break
        if k >= cap:
            break
        k += 1
    return k


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
        (cfg.num_shards > 1 or cfg.feat_shards > 1,
         "num_shards/feat_shards > 1: run the sharded engine, "
         "parallel.ShardedEngine (JAX's Engine ignores both)"),
        (cfg.param_dtype != "float32", f"param_dtype={cfg.param_dtype!r}"),
        (cfg.compute_dtype not in _DTYPES or cfg.agg_dtype not in _DTYPES,
         f"compute_dtype={cfg.compute_dtype!r} / agg_dtype={cfg.agg_dtype!r}"),
    ]
    return next((msg for bad, msg in checks if bad), None)


def check_staleness(cfg: TrainConfig) -> None:
    if cfg.staleness is not None and cfg.staleness < 0:
        raise ValueError(f"staleness={cfg.staleness}: a window of epochs, >= 0")


def lr_at(cfg: TrainConfig, epoch: int) -> float:
    """The learning rate of `epoch` (the reference's decay schedule)."""
    if not cfg.lr_decay_every:
        return cfg.learning_rate
    return decay_lr(cfg.learning_rate, epoch, cfg.lr_decay_every, cfg.lr_decay_factor)


class StaleWindow:
    """The bounded-staleness weight stash (JAX's (S+1)-stacked `history`):
    S+1 detached copies of the params, all equal to them at the start;
    `oldest` is the version this epoch's gradients are taken at, and
    `roll(params)` shifts each copy one place towards the oldest and writes
    the just-updated params into the newest, as JAX's stack roll
    (`concatenate([hi[1:], p[None]])`) does. The copies keep their storage,
    so an epoch captured as a CUDA graph reads the right version on every
    replay."""

    def __init__(self, params: dict, staleness: int):
        self.copies = [{k: p.detach().clone().requires_grad_(True)
                        for k, p in params.items()} for _ in range(staleness + 1)]

    def fill(self, params: dict) -> None:
        """Every copy equal to `params` again, in place (a run's start)."""
        with torch.no_grad():
            for copy in self.copies:
                for k, t in copy.items():
                    t.copy_(params[k])

    @property
    def oldest(self) -> dict:
        return self.copies[0]

    def roll(self, params: dict) -> None:
        with torch.no_grad():
            for older, newer in zip(self.copies, self.copies[1:] + [params]):
                for k, t in older.items():
                    t.copy_(newer[k])


def stale_window(eng, staleness: Optional[int]) -> Optional[StaleWindow]:
    """The engine's window for `staleness` at a run's start (JAX's
    `make_stack` per run), or None when synchronous: made at the first run
    and refilled from the params in every later one, so the copies a kept
    graph captured stay the ones it reads."""
    if not staleness:
        return None
    window = eng._windows.get(staleness)
    if window is None:
        window = eng._windows[staleness] = StaleWindow(eng.params, staleness)
    else:
        window.fill(eng.params)
    return window


def resume(eng) -> None:
    """The resume branch (JAX `Engine.__init__`): with cfg.resume and a
    checkpoint in cfg.checkpoint_dir, load its params into the model, its
    Adam state, and number the epochs on from its step."""
    cfg = eng.cfg
    eng.start_epoch = 0
    if not (cfg.resume and cfg.checkpoint_dir):
        return
    path = latest_checkpoint(cfg.checkpoint_dir)
    if path is None:
        return
    ck = load_checkpoint(path)
    # in place, so eng.params (the model's own parameters) stays valid
    eng.model.load_state_dict(params_from_numpy(ck["params"], eng.device))
    if ck["opt_state"] is not None and cfg.adam:
        eng.opt_state = adam_state_from_numpy(ck["opt_state"], eng.device)
    eng.start_epoch = int(ck["step"])
    if eng.rank == 0:
        log("resumed from %s (epoch %d)", path, eng.start_epoch)


def checkpoint_due(cfg: TrainConfig, epoch: int) -> bool:
    return bool(cfg.checkpoint_dir and cfg.checkpoint_every
                and (epoch + 1) % cfg.checkpoint_every == 0)


def eager_group(eng, lrs: list, flags: np.ndarray,
                window: Optional[StaleWindow]) -> tuple[torch.Tensor, torch.Tensor]:
    """A group's epochs run eagerly: for each, the update at lr
    (`_train_epoch`, gradients at the window's oldest copy when there is a
    window, which then rolls) and, where flagged, the evaluation
    (`_stats`). Returns (losses (k,), stats (k, 3): correct, loss sum,
    count; zeros where not flagged) on the engine's device, unread."""
    k = len(lrs)
    losses = torch.zeros(k, device=eng.device)
    stats = torch.zeros((k, 3), device=eng.device)
    for i, (lr, flag) in enumerate(zip(lrs, flags)):
        losses[i] = eng._train_epoch(lr, None if window is None else window.oldest)
        if window is not None:
            window.roll(eng.params)
        if flag:
            stats[i] = eng._stats(eng.batch.val_mask)
    return losses, stats


def epoch_graph_refusal(device: torch.device, backend: str) -> Optional[str]:
    """Why an engine on `device` whose collectives run over `backend`
    ("none" without a process group) runs its epochs eagerly, or None when
    it captures them as CUDA graphs (engine/graphs.py). Decided by the
    names when the engine is built, never by a failed attempt."""
    from dorylus_tpu_torch.parallel import multihost  # the package imports this module

    if device.type != "cuda":
        return "the CPU has no CUDA graphs"
    if not multihost.collectives_capturable(backend):
        return (f"{backend} stages every CUDA tensor through a host buffer, which a "
                "capture refuses")
    return None


def epoch_mode(refusal: Optional[str]) -> str:
    """The construction log's words for how the epochs run."""
    return "replayed as CUDA graphs" if refusal is None else f"eager ({refusal})"


def dispatch_group(eng, lrs: list, flags: np.ndarray,
                   window: Optional[StaleWindow]) -> tuple[torch.Tensor, torch.Tensor]:
    """Both engines' `_dispatch`: a group's epochs replayed as the engine's
    CUDA graphs where it keeps them, else eagerly."""
    if eng._graphs is not None:
        return eng._graphs.run_group(eng, lrs, flags, window)
    return eager_group(eng, lrs, flags, window)


def run_graphed(eng, epochs: Optional[int], graphs: bool) -> RunReport:
    """Both engines' `run`: the group loop through the engine's kept
    EpochGraphs (made at the first run that can capture: `graph_refusal`
    is None), or eagerly with graphs=False, which drops them."""
    from dorylus_tpu_torch.engine.graphs import EpochGraphs

    if not graphs:
        eng._graphs = None
    elif eng._graphs is None and eng.graph_refusal is None:
        eng._graphs = EpochGraphs(eng.device)
    return run_loop(eng, epochs if epochs is not None else eng.cfg.epochs)


def run_loop(eng, epochs: int) -> RunReport:
    """The group loop of both engines (JAX `run_group_loop`). The engine
    supplies `_dispatch(lrs, flags, window)` (a group's epochs -> its
    losses (k,) and stats (k, 3) as device tensors), `_windows` (its
    staleness windows, `stale_window`), `_stats(mask)` ((3,):
    correct, loss, count over every shard), `_maybe_checkpoint(epoch)`,
    `rank` (0 logs), `world` (the ranks: the cost note's GPU count, JAX's
    mesh.size) and the report. One host read a group; every rank computes
    the same groups, so all checkpoint and stop together. The report's
    notes gain JAX's "cost" (GPU-seconds and an estimate at an assumed
    price, engine/profiling.py) and, on the card, "hbm".

    Spans (common/metrics.py): engine.run (the whole call) around one
    engine.group a group (attributes: epochs, evals, replayed: through the
    engine's kept CUDA graphs, none captured), which holds
    engine.dispatch, engine.group_read (the host read) and
    engine.group_records (the logs, records, checkpoint and monitor), then
    engine.run_end around engine.report (the cost and memory notes) and two
    engine.final_eval (val, test)."""
    from dorylus_tpu_torch.engine.profiling import report_cost, report_memory

    cfg = eng.cfg
    speak = eng.rank == 0
    with span("engine.run", epochs=epochs):
        monitor = ConvergeMonitor(cfg.target_accuracy, cfg.switch_threshold)
        eng.report.notes["kernel"] = eng.kernel_selected
        eng.report.notes["device"] = str(eng.device)
        t_run = time.perf_counter()
        window = stale_window(eng, cfg.staleness)
        # Resume continues the original numbering: LR schedule, eval cadence
        # and checkpoint steps pick up where the prior run left off.
        epoch, end = eng.start_epoch, eng.start_epoch + epochs
        while epoch < end:
            with span("engine.group") as grp:
                k = group_len(epoch, end, cfg)
                t0 = time.perf_counter()
                flags = eval_flags(epoch, k, end, cfg)
                lrs = [lr_at(cfg, ep) for ep in range(epoch, epoch + k)]
                graphs = eng._graphs
                captures = graphs.captures if graphs is not None else None
                with span("engine.dispatch"):
                    losses, stats = eng._dispatch(lrs, flags, window)
                grp.attrs.update(epochs=k, evals=int(flags.sum()),
                                 replayed=graphs is not None and graphs.captures == captures)
                # the group's one host read: it waits for the device
                with span("engine.group_read"):
                    rows = torch.cat([losses[:, None], stats], 1).tolist()
                dt_ms = 1e3 * (time.perf_counter() - t0) / k
                with span("engine.group_records"):
                    acc = None
                    for i, (loss_f, c, vloss, n) in enumerate(rows):
                        ep_acc = None
                        if flags[i]:
                            acc = ep_acc = c / max(1.0, n)
                            if speak:
                                log("Epoch %d: %.2f ms, train loss %.4f, val acc %.4f, "
                                    "val loss %.4f", epoch + i, dt_ms, loss_f, ep_acc,
                                    vloss / max(1.0, n))
                        eng.report.add_epoch(EpochRecord(epoch + i, dt_ms, loss=loss_f,
                                                         accuracy=ep_acc))
                    last = epoch + k - 1
                    eng._maybe_checkpoint(last)
                    # Converge state machine (weightserver.cpp:270-294): CLOSE
                    # drains the stale window (async -> sync), DONE stops. The
                    # accuracy is every shard's, so every rank switches and
                    # stops together.
                    monitor.update(acc)
                    if window is not None and monitor.synchronous:
                        if speak:
                            log("Converge state CLOSE at epoch %d — switching to sync.", last)
                        window = None
            if monitor.done:
                if speak:
                    log("Target accuracy %.3f reached at epoch %d — stopping.",
                        cfg.target_accuracy, last)
                break
            epoch += k
        with span("engine.run_end"):
            eng.report.notes["converge_state"] = monitor.state.name
            with span("engine.report"):
                eng.report.total_time_s = time.perf_counter() - t_run
                eng.report.notes["cost"] = report_cost(eng.report.total_time_s,
                                                       n_gpus=eng.world)
                mem = report_memory(eng.device)
                if mem:
                    eng.report.notes["hbm"] = mem
            with span("engine.final_eval", mask="val"):
                c, _, n = eng._stats(eng.batch.val_mask).tolist()
                eng.report.final_accuracy = c / max(1.0, n)
            with span("engine.final_eval", mask="test"):
                c, _, n = eng._stats(eng.batch.test_mask).tolist()
                eng.report.test_accuracy = c / max(1.0, n)
    return eng.report


class Engine:
    """Single-device engine: `Engine(graph, layers, cfg, device).run(n)`.

    device: where the graph, plans and params live. None means the card
    ("cuda"), and raises when no card is visible; the CPU is used only
    when the caller passes device="cpu". On a CUDA device the aggregation
    runs the hand-written kernel (or raises); it never moves work to the
    CPU. The build is the span engine.build (attribute: edges), around the
    aggregation op's own spans (ops/hyb_spmm.py), engine.batch and
    engine.params (the model, its weights, Adam's state)."""

    def __init__(self, graph: Graph, layers: LayerConfig, cfg: TrainConfig,
                 device: str | torch.device | None = None):
        with span("engine.build", edges=graph.num_edges):
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
            check_staleness(cfg)
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
            reuse_on = kernel == "hyb" and cfg.reuse in ("pairs", "auto")
            if reuse_on and cfg.reuse == "auto":
                # the payoff gate before mining (model- and horizon-aware)
                reuse_on = gate_reuse_auto(cfg, v, graph.num_edges)
            if reuse_on:
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
                    if below_reuse_floor(cfg, st["row_reduction"]):
                        spmm_op = None
                    else:
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
            self._edge_arrays_stubbed = stubbed
            with span("engine.batch"):
                self.batch = build_batch(graph, self.device, for_gat=gat,
                                         edge_arrays=not stubbed)
            with span("engine.params"):
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
            self._windows: dict = {}
            resume(self)
            self.graph_refusal = epoch_graph_refusal(self.device, "none")
            log("dorylus_tpu_torch engine on %s: %s, %d vertices, %d edges, "
                "kernel %s, agg %s, epochs %s", self.device, cfg.model, graph.num_vertices,
                graph.num_edges, self.kernel_selected, cfg.agg_dtype,
                epoch_mode(self.graph_refusal))

    rank = 0  # the one shard: it logs
    world = 1
    _graphs = None  # the engine's EpochGraphs, on the card

    def _stats(self, mask: torch.Tensor) -> torch.Tensor:
        """(3,) on the device: correct, loss, count over the masked rows."""
        with torch.no_grad():
            probs = row_softmax(self.model.forward(self.batch))
            return torch.stack(accuracy_and_loss(probs, self.batch.onehot, mask))

    def _train_epoch(self, lr: float | None, stale: Optional[dict] = None,
                     lr_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update; the gradients are taken at `stale` (the staleness
        window's oldest copy) when given, else at the current params. lr_t:
        a 0-dim device tensor that holds the step's rate (Adam's
        bias-corrected lr_t, SGD's lr), in place of lr (a captured epoch)."""
        cfg = self.cfg
        at = self.params if stale is None else stale
        loss = self.model.loss(self.batch, self.compute_dtype, params=stale)
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(loss, [at[k] for k in names])))
        if cfg.adam:
            self.params, self.opt_state = adam_update(
                self.params, grads, self.opt_state, lr=lr, beta1=cfg.beta1,
                beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay, lr_t=lr_t)
        else:
            self.params = sgd_update(self.params, grads, lr if lr_t is None else lr_t)
        return loss.detach()

    def _dispatch(self, lrs: list, flags: np.ndarray,
                  window: Optional[StaleWindow]) -> tuple[torch.Tensor, torch.Tensor]:
        return dispatch_group(self, lrs, flags, window)

    def _maybe_checkpoint(self, epoch: int) -> None:
        if checkpoint_due(self.cfg, epoch):
            save_checkpoint(self.cfg.checkpoint_dir, epoch + 1, self.params,
                            self.opt_state)

    def run(self, epochs: Optional[int] = None, graphs: bool = True) -> RunReport:
        """Train `epochs` (cfg.epochs by default) from `start_epoch`. A
        second run() starts again at start_epoch while Adam's step carries
        on, as JAX's does. On the card the epochs are captured and replayed
        as CUDA graphs (engine/graphs.py), kept for the next run();
        graphs=False runs them eagerly there, to compare with, and drops
        the kept graphs."""
        return run_graphed(self, epochs, graphs)

    def profile(self, iters: int = 5) -> dict:
        """Per-stage times in ms (engine/profiling.py `profile_stages`; JAX
        `Engine.profile`); they also land in report.stage_times. When the
        training batch ships stub edge arrays, the brackets run on a full
        batch, as JAX's do."""
        from dorylus_tpu_torch.engine.profiling import profile_stages, stage_times

        batch = self.batch
        if self._edge_arrays_stubbed:
            batch = build_batch(self.graph, self.device, for_gat=self.cfg.model == "gat")
        times = profile_stages(self.model, self.params, batch, iters=iters)
        self.report.stage_times = stage_times(times, iters)
        return times

    def output(self, path: Optional[str] = None) -> str:
        """Write/return the final report (JAX `Engine.output`; analog of
        output_<node>, engine/utils.cpp:109-212)."""
        if path:
            self.report.write(path)
        return self.report.summary()

    def predict(self, softmax: bool = False) -> np.ndarray:
        """Per-vertex final-layer outputs (V, C): raw logits by default,
        softmax rows if asked."""
        with torch.no_grad():
            out = (self.model.predict(self.batch) if softmax
                   else self.model.forward(self.batch))
        return out.cpu().numpy()

    def dump_predictions(self, path: str, softmax: bool = False) -> None:
        """Write per-vertex final-layer outputs, one line per vertex (JAX
        `Engine.dump_predictions`): what tools/compare_output.py diffs (its
        line-sum metric needs raw logits; softmax rows always sum to 1)."""
        np.savetxt(path, self.predict(softmax=softmax), fmt="%.6f")
