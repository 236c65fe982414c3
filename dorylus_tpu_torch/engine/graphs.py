"""A training epoch of either engine captured as CUDA graphs and replayed k
times a group (the counterpart of JAX engine/engine.py `_make_step`'s
`multis` and parallel/train_step.py `make_multi`, k epochs in one
`jax.jit(lax.scan)` call).

`EpochGraphs` holds, for one engine and as long as it lives:

  train[history]  the loss, `torch.autograd.grad` (in the sharded engine
                  with the halo exchanges and their reverse, then the one
                  all-reduce of the gradients and the loss), Adam (or SGD)
                  in place and, with a staleness window (history=True),
                  the window's roll: JAX's `with_history` axis;
  eval            the f32 forward on the updated params and
                  accuracy_and_loss over val_mask into a (3,) tensor (summed
                  over the shards), replayed after train on the flagged
                  epochs only (JAX's eval modes none, all and mixed are the
                  flag pattern).

A group runs, for each epoch: write the step's rate into the scalar the
graph reads, replay train, copy the loss into losses[i]; where flagged,
replay eval and copy its stats into stats[i]. None of it waits for the
device: the loop reads the group once.

The first epoch that needs a graph runs eagerly on a side stream, as
`torch.cuda.graph` asks (it initialises cuBLAS, fills every plan's
descriptor layouts, gather_parts.PartTable.layout, and creates every NCCL
communicator the body uses: one created inside a capture raises), and
counts as an epoch (Adam steps once); the capture that follows runs
nothing and changes no state.

The graphs live as long as the engine, as JAX keeps its compiled groups: a
second run() captures nothing and replays from its first epoch. A graph is
captured again only where a tensor it captured was replaced by another
object: each graph records, at its capture, the identity and address of
the state it reads and writes in place (the params, Adam's m and v, the
staleness window's copies), and each group checks the graphs it replays
against the engine's state. A resume, or a caller that assigns a new
tensor into the params or the Adam state, replaces them; the engines' own
updates work in place, and each engine keeps one window per staleness,
refilled at each run's start. The rate scalar belongs to the graphs. Each
graph has its own memory pool: train replays without eval break the replay
order a shared pool needs.

Whether an engine captures at all is decided once, when it is built
(engine/engine.py `epoch_graph_refusal`): on the card with no process
group or over NCCL; not on the CPU, and not under gloo, which stages a
CUDA tensor through a host buffer and copies it back on the host
(parallel/multihost.py), which a capture refuses.

The step counter stays on the host. Before each replay the host computes
the step's rate in f32 (`adam_lr_t`, or SGD's lr) and writes it into the
scalar with `fill_`, a kernel on the replay's stream. The kernels' launch
counters are Python integers their wrappers bump as they launch, which a
capture does and a replay does not: each graph takes back what its capture
added and adds it again on every replay, so the counters count the
kernels the device ran on both paths.

A failed capture or replay raises; nothing falls back to the eager loop.

Recorded (common/metrics.py): the span graphs.eager around each warm-up
epoch and graphs.capture (attribute: key) around each capture, whose count
is the process's captures (the attribute `captures` counts this object's).
"""

from __future__ import annotations

import gc
import importlib
import weakref
from typing import Callable

import numpy as np
import torch

from dorylus_tpu_torch.common.metrics import span
from dorylus_tpu_torch.optim.adam import adam_lr_t

# The modules whose *_LAUNCHES integers count the kernels' launches.
_COUNTER_MODULES = ("dorylus_tpu_torch.ops.hyb_spmm", "dorylus_tpu_torch.ops.degree_spmm",
                    "dorylus_tpu_torch.ops.reuse_spmm", "dorylus_tpu_torch.ops.spmm",
                    "dorylus_tpu_torch.ops.hyb_sharded", "dorylus_tpu_torch.parallel.halo")

# Dicts of launch counts kept beside those: a caller that tallies launches
# its own way (by wrapping a launcher) lists its dict here while it
# tallies, and replays add to it too.
LAUNCH_TALLIES: list[dict] = []


def _counters() -> list[dict]:
    return [vars(importlib.import_module(m)) for m in _COUNTER_MODULES] + LAUNCH_TALLIES


def _read(ns: dict) -> dict:
    if "__name__" in ns:  # a module: its *_LAUNCHES integers
        return {k: v for k, v in ns.items() if k.endswith("_LAUNCHES")}
    return dict(ns)


def _state(eng, window=None) -> list[torch.Tensor]:
    """The engine's tensors a captured epoch reads and writes in place: the
    params, Adam's m and v and, with a window, its copies."""
    out = list(eng.params.values())
    if eng.opt_state is not None:
        out += list(eng.opt_state.m.values()) + list(eng.opt_state.v.values())
    if window is not None:
        out += [t for copy in window.copies for t in copy.values()]
    return out


def _marks(tensors: list[torch.Tensor]) -> list:
    # weak references: the graphs keep no tensor of the engine alive
    return [(weakref.ref(t), t.data_ptr()) for t in tensors]


def _unchanged(marks: list, tensors: list[torch.Tensor]) -> bool:
    return len(marks) == len(tensors) and all(
        ref() is t and ptr == t.data_ptr() for (ref, ptr), t in zip(marks, tensors))


class _Graph:
    """One captured graph, its output and the launch counts its capture
    added (taken back after the capture, added again on every replay)."""

    def __init__(self, body: Callable[[], torch.Tensor]):
        spaces = _counters()
        before = [_read(ns) for ns in spaces]
        self.graph = torch.cuda.CUDAGraph()
        # No garbage collection during the capture: a collected object that
        # holds another graph destroys it there (cudaGraphExecDestroy),
        # which a global-mode capture refuses, and the capture fails.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.out = body()
        finally:
            if collecting:
                gc.enable()
        self.added = []
        for ns, was in zip(spaces, before):
            for key, n in _read(ns).items():
                if n != was.get(key, 0):
                    self.added.append((ns, key, n - was.get(key, 0)))
                    if key in was:
                        ns[key] = was[key]
                    else:
                        del ns[key]

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for ns, key, n in self.added:
            ns[key] = ns.get(key, 0) + n
        return self.out


class EpochGraphs:
    """The train and eval graphs of an engine on the card, kept as long as
    the engine keeps them; the engine passes itself to `run_group` (the
    graphs hold no reference to it, so that dropping the engine frees them
    at once). A train graph with history is bound to the window it
    captured: the engine keeps that window for its life."""

    def __init__(self, device: torch.device):
        self.device = device
        # the step's rate the captured update reads: Adam's lr_t, SGD's lr
        self.rate = torch.zeros((), dtype=torch.float32, device=device)
        self.train: dict[bool, _Graph] = {}
        self.eval: _Graph | None = None
        self.marks: dict = {}  # graph key -> _marks of the state it captured
        self.captures = 0  # graphs captured so far
        self.side = None  # the warm-up's stream, made at its first use

    def _eager(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """fn() on the side stream, ordered after and before the current
        stream's work (the warm-up torch.cuda.graph asks for)."""
        cur = torch.cuda.current_stream(self.device)
        if self.side is None:
            self.side = torch.cuda.Stream(self.device)
        self.side.wait_stream(cur)
        with span("graphs.eager"), torch.cuda.stream(self.side):
            out = fn()
        cur.wait_stream(self.side)
        return out

    def _capture(self, key, body: Callable[[], torch.Tensor],
                 state: list[torch.Tensor]) -> _Graph:
        with span("graphs.capture", key=str(key)):
            g = _Graph(body)
        self.marks[key] = _marks(state)
        self.captures += 1
        return g

    def _drop_replaced(self, eng, window, evals: bool) -> None:
        """Forget the graphs this group would replay whose captured state
        the engine has replaced: they are captured again."""
        history = window is not None
        if history in self.train and not _unchanged(self.marks[("train", history)],
                                                    _state(eng, window)):
            del self.train[history]
        if evals and self.eval is not None and not _unchanged(self.marks["eval"],
                                                              list(eng.params.values())):
            self.eval = None

    def _train(self, eng, lr: float, window) -> torch.Tensor:
        """One epoch's update at lr; its loss."""
        history = window is not None
        stale = window.oldest if history else None

        def epoch(rate=None):
            loss = eng._train_epoch(lr, stale, lr_t=rate)
            if history:
                window.roll(eng.params)
            return loss

        if history not in self.train:
            loss = self._eager(epoch)
            state = eng.opt_state
            self.train[history] = self._capture(("train", history), lambda: epoch(self.rate),
                                                _state(eng, window))
            eng.opt_state = state  # the capture ran no step
            return loss
        adam = eng.cfg.adam
        self.rate.fill_(adam_lr_t(lr, eng.opt_state.step + 1, eng.cfg.beta1, eng.cfg.beta2)
                        if adam else lr)
        loss = self.train[history].replay()
        if adam:
            eng.opt_state = eng.opt_state._replace(step=eng.opt_state.step + 1)
        return loss

    def _eval(self, eng) -> torch.Tensor:
        def stats():
            return eng._stats(eng.batch.val_mask)

        if self.eval is None:
            out = self._eager(stats)
            self.eval = self._capture("eval", stats, list(eng.params.values()))
            return out
        return self.eval.replay()

    def run_group(self, eng, lrs: list, flags: np.ndarray,
                  window) -> tuple[torch.Tensor, torch.Tensor]:
        """`eager_group`'s contract (engine/engine.py) for `eng`, through
        the graphs."""
        self._drop_replaced(eng, window, bool(np.any(flags)))
        losses = torch.zeros(len(lrs), device=self.device)
        stats = torch.zeros((len(lrs), 3), device=self.device)
        for i, (lr, flag) in enumerate(zip(lrs, flags)):
            losses[i] = self._train(eng, lr, window)
            if flag:
                stats[i] = self._eval(eng)
        return losses, stats
