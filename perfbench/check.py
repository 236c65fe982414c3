"""The comparison that decides a run's `correct`: the program's first steps
against the plain reference's from the same inputs.

Each reading is a share of the reference's value:
  loss_gap   the widest |loss - ref| / |ref| over the checked steps;
  grad_gap   the first step's gradient (the program's worked out from Adam's
             first moment after one step, m / (1 - beta1)), by the worst
             leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
  delta_gap  the same of the parameters' change over the checked steps, over
             the leaves whose reference gradient is at least a thousandth of
             the median leaf's (a leaf below it moves under Adam by
             round-off alone);
  eval_gap   the eval forward's logits on the validation rows after each
             checked step: |L - L_ref| / |L_ref| (Frobenius), the widest
             over the steps. Continuous values, not a count of argmax
             agreements, which flips on a near-tie from rounding alone.

Every checked step is read: the first is the engine's eager first epoch,
the later ones replays of the captured train and eval graphs, which the
window times.
"""

from __future__ import annotations

import statistics

import torch

NAMES = ("loss_gap", "grad_gap", "delta_gap", "eval_gap")
# a leaf whose reference gradient is under this share of the median leaf's
# is left out of delta_gap
NEGLIGIBLE_GRAD = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in leaves.items()}


def worst_leaf(prog: dict, ref: dict, keep) -> float:
    """The widest gap of norms over the leaves in `keep`, each against the
    larger of its own reference norm and the median leaf's."""
    p, r = _norms(prog), _norms(ref)
    median = statistics.median(r[k] for k in keep)
    return max(abs(p[k] - r[k]) / max(r[k], median) for k in keep)


def logits_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """|prog - ref| / |ref| over all rows (Frobenius norms)."""
    if prog.shape != ref.shape:
        raise ValueError(f"eval logits {tuple(prog.shape)} against {tuple(ref.shape)}")
    ref = ref.double()
    return float(torch.linalg.vector_norm(prog.double() - ref) / torch.linalg.vector_norm(ref))


def kept_leaves(grad1: dict) -> list:
    norms = _norms(grad1)
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= NEGLIGIBLE_GRAD * median]


def readings(prog: dict, ref: dict) -> dict:
    """The four readings of a program's checked steps against the
    reference's. prog and ref hold "losses", "grad1", "deltas" and "evals"
    as `reference.gnn.train` returns them."""
    n = len(ref["losses"])
    if len(prog["losses"]) != n or len(prog["evals"]) != n or len(prog["deltas"]) != n:
        raise ValueError("the program and the reference ran different numbers of steps")
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": worst_leaf(prog["grad1"], ref["grad1"], list(ref["grad1"])),
        "delta_gap": worst_leaf(prog["deltas"][-1], ref["deltas"][-1],
                                kept_leaves(ref["grad1"])),
        "eval_gap": max(logits_gap(a, b) for a, b in zip(prog["evals"], ref["evals"])),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every reading
    is a number within its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
