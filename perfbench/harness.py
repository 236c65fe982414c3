"""One run of one cell, on the users' training path: `Engine(graph,
LayerConfig, TrainConfig, device)`, then repeated `Engine.run(k)`.

Set-up (timed from the process's start): the inputs from the seed, the
`Graph` and its `finalize`, the `Engine` with the seed's weights copied in,
then the checked epochs through the window's own call: `run(1)` (the eager
first epoch and the capture of the epoch graphs), one `run(1)` for each
further step (a replay of the captured train and eval graphs), then one
`run(2)`: a group as the window's, whose first epoch replays the train
graph and whose second the measuring train graph, which hands back the
first's val stats, before the eval graph. Each epoch's loss, the eval
logits of each group's last epoch and the val stats the group returns for
each other epoch are read from what the groups return, the first gradient
from Adam's first moment after one step, and the parameters and moments
after each epoch are copied on the device between the epochs and to the
host after each group. The same engine then runs the window: whole
`run(k)` calls, each ending in its host read, until `seconds` have passed.
After the window the peak memory is read, the program is freed, and the
plain reference takes each checked epoch from the state the program
started it from, on the same inputs (`check`).
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.engine.engine import Engine
from dorylus_tpu_torch.graph.graph import Graph
from perfbench import check
from perfbench.inputs import Inputs, make_inputs
from perfbench.reference import gnn as reference
from perfbench.spec import Cell
from perfbench.devtrace import Trace, traced

GATHER_ROUNDING = {"float32": None, "bfloat16": torch.bfloat16}


@dataclass
class Context:
    """What a metric reads: the cell's files, the host clocks, the peak
    memory and, in a traced run, the window's trace."""

    config: dict
    traffic: dict
    clock: dict  # setup_s, engine_build_s, capture_s, window_s, epochs, runs
    peak_bytes: int
    trace: Trace | None


def train_config(config: dict, traffic: dict) -> TrainConfig:
    opt = config["optimizer"]
    return TrainConfig(model=config["model"], learning_rate=config["learning_rate"],
                       adam=opt["name"] == "adam", beta1=opt["beta1"], beta2=opt["beta2"],
                       eps=opt["eps"], param_dtype=config["param_dtype"],
                       compute_dtype=config["compute_dtype"], agg_dtype=config["agg_dtype"],
                       kernel=config["kernel"], optimize_order=config["optimize_order"],
                       eval_every=traffic["eval_every"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(config: dict, traffic: dict, inp: Inputs, device: torch.device) -> Engine:
    """The Graph the users hand the engine, finalised, and the engine with
    the seed's weights in place of its own."""
    g = Graph(num_vertices=inp.num_vertices, src=inp.src, dst=inp.dst,
              features=inp.features, labels=inp.labels, num_classes=config["dims"][-1])
    g.split_ids = inp.split_ids
    g.finalize()
    eng = Engine(g, LayerConfig(list(config["dims"])), train_config(config, traffic),
                 device=device)
    with torch.no_grad():
        for k, p in eng.params.items():
            p.copy_(inp.weights[k])
    return eng


class EvalTap:
    """Keeps the logits of the engine's eval forward (`Engine._stats` runs
    `model.forward` without grad): an eager call's output at `eager`, the
    capture's at `captured`, the tensor each replay of the eval graph
    writes."""

    def __init__(self, model):
        self.model, self.forward = model, model.forward
        self.eager = self.captured = None
        model.forward = self

    def __call__(self, *args, **kwargs):
        out = self.forward(*args, **kwargs)
        if not torch.is_grad_enabled():
            if out.is_cuda and torch.cuda.is_current_stream_capturing():
                self.captured = out
            else:
                self.eager = out
        return out

    def remove(self) -> None:
        del self.model.forward


class Recorder:
    """Passes the engine's group dispatch through and keeps, for each epoch
    of the checked groups: its loss; the parameters and Adam moments after
    it (copied on the device as its step returns, so that the group's
    epochs run on with no host read between them, then to the host); and
    what evaluates the parameters it left: the validation rows of the eval
    logits where it is its group's last epoch (from the eager eval in the
    group that captured the graphs, from the replayed eval graph after
    that), else the val stats (correct, loss sum, count) the group returns
    for it (where the group folds, the next epoch's training forward's)."""

    def __init__(self, eng):
        self.eng, self.dispatch, self.tap = eng, eng._dispatch, EvalTap(eng.model)
        self.val = eng.batch.val_mask > 0
        self.losses, self.evals, self.val_stats = [], [], []
        self.states = [reference.on_cpu(state_of(eng))]

    def __call__(self, lrs, flags, window):
        eng, graphs = self.eng, self.eng._graphs
        if not all(flags):
            raise ValueError("the checked epochs are evaluated epochs")
        captures = graphs.captures if graphs is not None else 0
        # each epoch's step: the graphs' (eager, capture or replay) on the
        # card, the engine's own on the CPU
        owner, name = (graphs, "_train") if graphs is not None else (eng, "_train_epoch")
        step, kept = getattr(owner, name), []

        def stepped(*args, **kwargs):
            out = step(*args, **kwargs)
            kept.append({part: {k: x.detach().clone() for k, x in leaves.items()}
                         for part, leaves in state_of(eng).items()})
            return out

        setattr(owner, name, stepped)
        try:
            losses, stats = self.dispatch(lrs, flags, window)
        finally:
            delattr(owner, name)
        k = len(lrs)
        if len(kept) != k:
            raise ValueError(f"a group of {k} epochs took {len(kept)} steps")
        replayed = graphs is not None and graphs.captures == captures
        logits = self.tap.captured if replayed else self.tap.eager
        self.losses += losses.tolist()
        self.states += [reference.on_cpu(s) for s in kept]
        self.evals += [None] * (k - 1) + [logits[self.val].cpu()]
        self.val_stats += [stats[i, 0].cpu() for i in range(k - 1)] + [None]
        return losses, stats

    def remove(self) -> None:
        self.tap.remove()
        del self.eng._dispatch


def state_of(eng: Engine) -> dict:
    """The program's parameters and Adam moments, as it holds them."""
    st = eng.opt_state
    return {"params": eng.params, "m": st.m, "v": st.v}


# The epochs of the last checked group: a group as the window runs them,
# whose first epoch replays the train graph and whose second the measuring
# one, which hands back the first's val stats.
FOLDED_GROUP = 2


def checked_epochs(steps: int) -> list[bool]:
    """For each epoch `first_steps(eng, steps)` checks, whether its eval is
    the val stats its group returns for it (True) or the eval logits
    (False)."""
    return [False] * steps + [True] * (FOLDED_GROUP - 1) + [False]


def first_steps(eng: Engine, steps: int) -> tuple[dict, float]:
    """The checked epochs: `steps` run(1) calls (the first also the eager
    first epoch and the capture), then one run(FOLDED_GROUP). Returns the
    program's readings, {"losses", "evals" (the val logits, None where the
    val stats are read), "val_stats" (None where the logits are read),
    "grad1", "states": the parameters and moments each epoch started from,
    then the last's end}, and the seconds of the first run(), synchronised."""
    rec = eng._dispatch = Recorder(eng)
    t = time.perf_counter()
    eng.run(1)
    sync(eng.device)
    capture_s = time.perf_counter() - t
    for _ in range(steps - 1):
        eng.run(1)
    eng.run(FOLDED_GROUP)
    rec.remove()
    beta1 = eng.cfg.beta1
    grad1 = {k: m / (1.0 - beta1) for k, m in rec.states[1]["m"].items()}
    return {"losses": rec.losses, "evals": rec.evals, "val_stats": rec.val_stats,
            "grad1": grad1, "states": rec.states}, capture_s


def window(eng: Engine, seconds: float, k: int) -> tuple[float, int, int]:
    """Whole run(k) calls until `seconds` have passed: (wall seconds,
    epochs, runs)."""
    epochs = runs = 0
    t0 = time.perf_counter()
    while True:
        eng.run(k)
        epochs, runs = epochs + k, runs + 1
        if time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0, epochs, runs


def problem(cell: Cell, inp: Inputs, device: torch.device) -> reference.Problem:
    return reference.Problem(cell.config["model"], inp.src, inp.dst, inp.features, inp.labels,
                             inp.split_ids, gather_dtype=GATHER_ROUNDING[cell.config["agg_dtype"]],
                             device=device)


def adam_args(cell: Cell) -> dict:
    """The configuration's Adam, as the reference's steps take it."""
    opt = cell.config["optimizer"]
    return {"lr": cell.config["learning_rate"], "beta1": opt["beta1"], "beta2": opt["beta2"],
            "eps": opt["eps"]}


def reference_train(cell: Cell, prob: reference.Problem, inp: Inputs, **kw) -> dict:
    """The reference's own trajectory over the checked epochs from the
    seed's weights (kw: `reference.train`'s tf32, stale_rate,
    keep_moments)."""
    steps = len(checked_epochs(int(cell.traffic["check_steps"])))
    return reference.train(prob, inp.weights, steps=steps, **adam_args(cell), **kw)


def run_of(cell: Cell, prob: reference.Problem, traj: dict, evals: list | None = None) -> dict:
    """A reference trajectory put in the program's place: its readings as
    `first_steps` gives the program's, the eval of each epoch from `evals`
    (the trajectory's logits after each step by default) as logits or, where
    the program's group hands back val stats, as val stats."""
    evals = traj["evals"] if evals is None else evals
    folded = checked_epochs(int(cell.traffic["check_steps"]))
    return dict(traj, evals=[None if f else e for f, e in zip(folded, evals)],
                val_stats=[prob.val_stats(e) if f else None for f, e in zip(folded, evals)])


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_process: float) -> dict:
    """One run of `cell`; the result line's keys, with "checks" last."""
    cuda = device.type == "cuda"
    inp = make_inputs(cell.config, cell.traffic, seed, device)
    free(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    eng = build_engine(cell.config, cell.traffic, inp, device)
    sync(device)
    build_s = time.perf_counter() - t
    prog, capture_s = first_steps(eng, int(cell.traffic["check_steps"]))
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    log(f"set-up {setup_s:.2f} s: engine build {build_s:.2f} s, first run {capture_s:.2f} s")
    k = int(cell.traffic["epochs_per_run"])
    tr = None
    if trace:
        (wall, epochs, runs), events = traced(lambda: window(eng, seconds, k), device)
        tr = Trace(events, epochs, runs)
        del events
    else:
        wall, epochs, runs = window(eng, seconds, k)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del eng
    free(device)
    t = time.perf_counter()
    ref = reference.follow(problem(cell, inp, device), prog["states"], **adam_args(cell))
    log(f"window {wall:.3f} s, {epochs} epochs in {runs} runs; reference "
        f"{time.perf_counter() - t:.2f} s")
    log(f"delta_gap over the leaves {', '.join(check.kept_leaves(ref['grad1']))}")
    correct, checks = check.judge(check.readings(prog, ref), cell.limits)
    ctx = Context(cell.config, cell.traffic,
                  {"setup_s": setup_s, "engine_build_s": build_s, "capture_s": capture_s,
                   "window_s": wall, "epochs": epochs, "runs": runs}, peak, tr)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": epochs, "failed": 0, "metrics": metrics,
              "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.span_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result
