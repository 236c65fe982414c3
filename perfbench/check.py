"""The comparison that decides a run's `correct`: each of the program's
checked epochs against the plain reference's step from the same state.

The program's parameters and Adam moments are kept before each checked
epoch and after the last. The reference takes its step t from the state
the program started epoch t from, t by the harness's own count
(`reference.gnn.follow`), so no reading rests on a trajectory that may
part from the program's after one step. Step 1 starts from the seed's
weights and zero moments on both sides, a check with nothing of the
program's in it. Each reading is a share of the reference's value:
  loss_gap   |loss - ref| / |ref| of each epoch's loss on its start
             parameters; the widest over the epochs;
  grad_gap   the first step's gradient (the program's worked out from Adam's
             first moment after one step, m / (1 - beta1)), by the worst
             leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
  delta_gap  the same of each epoch's own change of the parameters, p_t -
             p_(t-1), and of Adam's moments, m_t - m_(t-1) and v_t -
             v_(t-1), against the reference's from the same start, over the
             leaves whose first reference gradient is at least a thousandth
             of the median leaf's (a leaf below it moves under Adam by
             round-off alone); the widest over the three and the epochs. The
             moments' changes hold what a step writes for the next to read:
             the next step's reference reads the program's moments;
  eval_gap   the eval logits of the validation rows after each group's last
             epoch against the reference's forward on the program's p_t:
             |L - L_ref| / |L_ref| (Frobenius), the widest over those epochs.
             Continuous values, not a count of argmax agreements, which
             flips on a near-tie from rounding alone;
  fold_gap   the val stats a group returns for each of its other epochs
             (where the group folds, the next epoch's training forward's)
             against the reference's of its forward on the program's p_t:
             the larger of the loss sum's |s - s_ref| / |s_ref| and the row
             count's (the correct count, an argmax count, is not read); the
             widest over those epochs. A number of its own: the loss sum
             over the validation rows moves far less from step to step than
             the logits do.

Every checked epoch is read: the first is the engine's eager first epoch,
the later ones replays of the captured train, measuring train and eval
graphs, which the window times, and the folded val stats the window's
groups return.
"""

from __future__ import annotations

import math
import statistics

import torch

NAMES = ("loss_gap", "grad_gap", "delta_gap", "eval_gap", "fold_gap")
# what a step changes: the parameters and Adam's two moments
PARTS = ("params", "m", "v")
# a leaf whose reference gradient is under this share of the median leaf's
# is left out of delta_gap
NEGLIGIBLE_GRAD = 1e-3


def widest(values) -> float:
    """The largest value; NaN where any is NaN (`max` would drop it)."""
    values = list(values)
    return math.nan if any(x != x for x in values) else max(values)


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in leaves.items()}


def worst_leaf(prog: dict, ref: dict, keep) -> float:
    """The widest gap of norms over the leaves in `keep`, each against the
    larger of its own reference norm and the median leaf's."""
    p, r = _norms(prog), _norms(ref)
    median = statistics.median(r[k] for k in keep)
    return widest(abs(p[k] - r[k]) / max(r[k], median) for k in keep)


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


def stats_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Val stats (correct, loss sum, rows) against the reference's: the
    larger relative gap of the loss sum and the rows (the correct count is
    an argmax count, not compared)."""
    return widest(abs(float(prog[i]) - float(ref[i])) / abs(float(ref[i])) for i in (1, 2))


def step_change(before: dict, after: dict) -> dict:
    """{part: {leaf: after - before}} over `PARTS`."""
    return {part: {k: after[part][k] - x for k, x in before[part].items()} for part in PARTS}


def step_readings(prog: dict, ref: dict) -> list:
    """loss_gap, delta_gap, and eval_gap or fold_gap, of each checked epoch
    alone. prog holds "losses", "grad1", "evals" (the val logits, or None),
    "val_stats" (the val stats where "evals" has None) and "states" (each
    epoch's start, then the last's end); ref "losses", "grad1", "after",
    "evals" and "val_stats" as `reference.gnn.follow` returns them from
    prog's states."""
    n = len(ref["losses"])
    states = prog["states"]
    if any(len(prog[k]) != n for k in ("losses", "evals", "val_stats")) or len(states) != n + 1:
        raise ValueError("the program and the reference ran different numbers of steps")
    keep = kept_leaves(ref["grad1"])
    out = []
    for t in range(n):
        mine = step_change(states[t], states[t + 1])
        theirs = step_change(states[t], ref["after"][t])
        step = {"loss_gap": abs(prog["losses"][t] - ref["losses"][t]) / abs(ref["losses"][t]),
                "delta_gap": widest(worst_leaf(mine[p], theirs[p], keep) for p in PARTS)}
        if prog["evals"][t] is not None:
            step["eval_gap"] = logits_gap(prog["evals"][t], ref["evals"][t])
        else:
            step["fold_gap"] = stats_gap(prog["val_stats"][t], ref["val_stats"][t])
        out.append(step)
    return out


def readings(prog: dict, ref: dict) -> dict:
    """The readings of a program's checked epochs against the reference's
    steps from the same states (`step_readings`' arguments), each the widest
    over the epochs that have it."""
    steps = step_readings(prog, ref)
    out = {k: widest(s[k] for s in steps if k in s) for k in NAMES if k != "grad_gap"}
    out["grad_gap"] = worst_leaf(prog["grad1"], ref["grad1"], list(ref["grad1"]))
    return {k: out[k] for k in NAMES}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every reading
    is a number within its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
