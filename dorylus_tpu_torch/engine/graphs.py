"""A training epoch of the single-device engine captured as CUDA graphs and
replayed k times a group (the counterpart of JAX engine/engine.py
`_make_step`'s `multis`, k epochs in one `jax.jit(lax.scan)` call).

`EpochGraphs` holds, for one `Engine.run()`:

  train[history]  the loss, `torch.autograd.grad`, Adam (or SGD) in place
                  and, with a staleness window (history=True), the
                  window's roll: JAX's `with_history` axis;
  eval            the f32 forward on the updated params and
                  accuracy_and_loss over val_mask into a (3,) tensor,
                  replayed after train on the flagged epochs only (JAX's
                  eval modes none, all and mixed are the flag pattern).

A group runs, for each epoch: write the step's rate into the scalar the
graph reads, replay train, copy the loss into losses[i]; where flagged,
replay eval and copy its stats into stats[i]. None of it waits for the
device: the loop reads the group once.

The first epoch that needs a graph runs eagerly on a side stream, as
`torch.cuda.graph` asks (it initialises cuBLAS and fills every plan's
descriptor layouts, gather_parts.PartTable.layout), and counts as an epoch
(Adam steps once); the capture that follows runs nothing and changes no
state. Every run() captures anew: a resume replaces the Adam state's
tensors and the staleness may change between runs. Each graph has its own
memory pool: train replays without eval break the replay order a shared
pool needs.

The step counter stays on the host. Before each replay the host computes
the step's rate in f32 (`adam_lr_t`, or SGD's lr) and writes it into the
scalar with `fill_`, a kernel on the replay's stream. The kernels' launch
counters are Python integers their wrappers bump as they launch, which a
capture does and a replay does not: each graph takes back what its capture
added and adds it again on every replay, so the counters count the
kernels the device ran on both paths.

A failed capture or replay raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import gc
import importlib
from typing import Callable

import numpy as np
import torch

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
    """The train and eval graphs of one run of an `Engine` on the card,
    which passes itself to `run_group` (the graphs hold no reference to it,
    so that dropping the engine frees them at once). A staleness window is
    bound to the train graph that captured it: a run keeps one window until
    the converge monitor drops it."""

    def __init__(self, device: torch.device):
        self.device = device
        # the step's rate the captured update reads: Adam's lr_t, SGD's lr
        self.rate = torch.zeros((), dtype=torch.float32, device=device)
        self.train: dict[bool, _Graph] = {}
        self.eval: _Graph | None = None
        self.side = None  # the warm-up's stream, made at its first use

    def _eager(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """fn() on the side stream, ordered after and before the current
        stream's work (the warm-up torch.cuda.graph asks for)."""
        cur = torch.cuda.current_stream(self.device)
        if self.side is None:
            self.side = torch.cuda.Stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            out = fn()
        cur.wait_stream(self.side)
        return out

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
            self.train[history] = _Graph(lambda: epoch(self.rate))
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
            self.eval = _Graph(stats)
            return out
        return self.eval.replay()

    def run_group(self, eng, lrs: list, flags: np.ndarray,
                  window) -> tuple[torch.Tensor, torch.Tensor]:
        """`eager_group`'s contract (engine/engine.py) for `eng`, through
        the graphs."""
        losses = torch.zeros(len(lrs), device=self.device)
        stats = torch.zeros((len(lrs), 3), device=self.device)
        for i, (lr, flag) in enumerate(zip(lrs, flags)):
            losses[i] = self._train(eng, lr, window)
            if flag:
                stats[i] = self._eval(eng)
        return losses, stats
