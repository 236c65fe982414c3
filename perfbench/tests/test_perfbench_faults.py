"""A run of the harness with the timed path broken underneath comes out
`correct` false, once for each fault a one-chip training cell can have: a
step that leaves its state unchanged, half of the batch left out with the
mean taken over the rest, the eval's answer altered where it is produced
(read from the parameters before the step's update), the val stats a
group hands back for an epoch read from the parameters after the next
epoch's update, every step taken at step 1's bias-corrected rate (the rate
not refilled), and the moments each step after the first computes not
written back (the next step reads the old ones). The run skips
run.py's look for a card and drives the rest on the CPU (the port's plain
passes) at a tiny size, GCN and GAT, held to the real full cell's limits;
the same run unbroken comes out correct."""

import pytest
import torch

import dorylus_tpu_torch.engine.engine as engine_mod
from dorylus_tpu_torch.optim.adam import adam_lr_t
from perfbench.harness import run_cell

MODELS = ["gcn", "gat"]


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


def fold_ahead(monkeypatch):
    train, Engine = engine_mod.Engine._train_epoch, engine_mod.Engine

    def measured_after_update(self, lr, stale=None, lr_t=None, val=False):
        loss, _ = train(self, lr, stale, lr_t=lr_t, val=False)
        return loss, self._stats((self.batch.val_mask,)) if val else None

    monkeypatch.setattr(Engine, "_train_epoch", measured_after_update)


def unwritten_moments(monkeypatch):
    update = engine_mod.adam_update

    def moments_dropped(params, grads, state, **kw):
        if state.step == 0:
            return update(params, grads, state, **kw)
        scratch = state._replace(m={k: x.clone() for k, x in state.m.items()},
                                 v={k: x.clone() for k, x in state.v.items()})
        params, after = update(params, grads, scratch, **kw)
        return params, state._replace(step=after.step)

    monkeypatch.setattr(engine_mod, "adam_update", moments_dropped)


def stale_rate(monkeypatch):
    update = engine_mod.adam_update

    def first_rate(params, grads, state, **kw):
        kw["lr_t"] = adam_lr_t(kw["lr"], 1, kw["beta1"], kw["beta2"])
        return update(params, grads, state, **kw)

    monkeypatch.setattr(engine_mod, "adam_update", first_rate)


def run(cell):
    return run_cell(cell, 2**31 + 99, 0.2, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("model", MODELS)
def test_sound_run_is_correct(tiny_cell, model):
    result = run(tiny_cell(model))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_batch, stale_eval, fold_ahead, stale_rate,
                                   unwritten_moments],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("model", MODELS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, model, fault):
    cell = tiny_cell(model)
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"], result["checks"]
