"""A run of the harness with the timed path broken underneath comes out
`correct` false, once for each fault a one-chip training cell can have: a
step that leaves its state unchanged, half of the batch left out with the
mean taken over the rest, and the eval's answer altered where it is
produced (read from the parameters before the step's update). The run
skips run.py's look for a card and drives the rest on the CPU (the port's
plain passes) at a tiny size, held to the real full cell's limits; the same
run unbroken comes out correct."""

import pytest
import torch

import dorylus_tpu_torch.engine.engine as engine_mod
from perfbench.harness import run_cell


def unchanged(monkeypatch):
    monkeypatch.setattr(engine_mod, "adam_update",
                        lambda params, grads, state, **kw: (params, state._replace(step=state.step + 1)))


def half_batch(monkeypatch):
    build = engine_mod.build_batch

    def halved(*args, **kwargs):
        b = build(*args, **kwargs)
        keep = torch.zeros_like(b.train_mask)
        keep[::2] = 1
        return b._replace(train_mask=b.train_mask * keep, denom=b.denom / 2)

    monkeypatch.setattr(engine_mod, "build_batch", halved)


def stale_eval(monkeypatch):
    train, Engine = engine_mod.Engine._train_epoch, engine_mod.Engine

    def train_after_eval(self, *args, **kwargs):
        with torch.no_grad():
            self.model.forward(self.batch)  # the eval's logits, before the update
        return train(self, *args, **kwargs)

    monkeypatch.setattr(Engine, "_train_epoch", train_after_eval)
    monkeypatch.setattr(Engine, "_stats", lambda self, mask: torch.zeros(3, device=self.device))


def run(cell):
    return run_cell(cell, 2**31 + 99, 0.2, False, torch.device("cpu"), 0.0)


def test_sound_run_is_correct(tiny_cell):
    result = run(tiny_cell("gcn"))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_batch, stale_eval], ids=lambda f: f.__name__)
def test_fault_is_not_correct(tiny_cell, monkeypatch, fault):
    cell = tiny_cell("gcn")
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]
