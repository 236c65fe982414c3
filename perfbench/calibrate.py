"""The readings the limits of a cell's output check are set from, at the
cell's own size, one JSON line a seed:

    python3 perfbench/calibrate.py --workload gcn-reddit.full --seeds 11 12 13 [--program]

For each seed, each side is a run of the checked epochs judged as a run of
the program is: each of its epochs against the float32 reference's step
from the state it started that epoch from (`check`). The sides, put in the
program's place:
  control     the reference in the nearest precision below the
              configuration's: its float32 matmuls in TF32;
  half_batch  the reference with every other training row left out and the
              mean taken over the rest;
  stale_eval  the reference's eval answered from the parameters before each
              step's update (p_(t-1) in place of p_t);
  fold_ahead  the val stats a group hands back for an epoch answered from
              the parameters after the next epoch's update (p_(t+1));
  unchanged   steps that leave the state unchanged;
  stale_rate  the reference with every step at step 1's bias-corrected
              rate (the rate scalar not refilled);
  stale_moments  the reference with the moments of each step after the
              first not kept (the next step reads the old ones);
  reference_again  the float32 reference itself (its f32 sums are atomic
              adds, in another order each run): its own spread;
  program     (with --program) the program's checked steps, as a run makes
              them (sound runs: the lower reading).
Each with its readings, its readings by epoch (loss_gap, delta_gap and
eval_gap of each epoch alone) and whether the cell's limits call it
correct.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check  # noqa: E402
from perfbench.harness import (adam_args, build_engine, checked_epochs,  # noqa: E402
                               first_steps, free, log, problem, reference_train, run_of)
from perfbench.inputs import make_inputs  # noqa: E402
from perfbench.reference.gnn import TRAIN_PORTION, follow, split_masks  # noqa: E402
from perfbench.spec import Cell  # noqa: E402


def unchanged(cell: Cell, prob, again: dict) -> dict:
    """A run whose every step leaves the seed's state as it was: each loss
    and eval those of the seed's weights, Adam's moments zero."""
    n = len(again["losses"])
    start = again["states"][0]
    still = {"losses": [again["losses"][0]] * n, "evals": [again["eval0"]] * n,
             "grad1": {k: torch.zeros_like(g) for k, g in again["grad1"].items()},
             "states": [start] * (n + 1)}
    return run_of(cell, prob, still)


def sides(cell: Cell, prob, inp) -> dict:
    """Each side but the program's, as a run of the checked epochs."""
    train, _ = split_masks(inp.split_ids, inp.num_vertices)
    half = train & (inp.split_ids % 2 == 0)
    den = float(np.float32(inp.num_vertices * TRAIN_PORTION))
    again = reference_train(cell, prob, inp)
    evals = again["evals"]
    # the folded epochs' stats from the next epoch's parameters, the others as they are
    folded = checked_epochs(int(cell.traffic["check_steps"]))
    ahead = [evals[t + 1] if f else e for t, (f, e) in enumerate(zip(folded, evals))]

    def ran(p=prob, **kw):
        return run_of(cell, prob, reference_train(cell, p, inp, **kw))

    return {"control": ran(tf32=True),
            "half_batch": ran(prob.with_train_rows(half, den / 2)),
            "stale_eval": run_of(cell, prob, again, [again["eval0"]] + evals[:-1]),
            "fold_ahead": run_of(cell, prob, again, ahead),
            "unchanged": unchanged(cell, prob, again),
            "stale_rate": ran(stale_rate=True),
            "stale_moments": ran(keep_moments=True),
            "reference_again": run_of(cell, prob, again)}


def judged(cell: Cell, prob, runs: dict) -> dict:
    """Each side's readings, readings by epoch and verdict; a side whose
    states are another's (stale_eval's and fold_ahead's are
    reference_again's) shares its reference."""
    out, followed = {}, {}
    for name, side in runs.items():
        key = id(side["states"])
        if key not in followed:
            followed[key] = follow(prob, side["states"], **adam_args(cell))
        ref = followed[key]
        values = check.readings(side, ref)
        out[name] = values
        out[name + "_by_epoch"] = check.step_readings(side, ref)
        out[name + "_correct"] = check.judge(values, cell.limits)[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell, device = Cell(args.workload), torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        inp = make_inputs(cell.config, cell.traffic, seed, device)
        runs = {}
        if args.program:
            eng = build_engine(cell.config, cell.traffic, inp, device)
            runs["program"], _ = first_steps(eng, int(cell.traffic["check_steps"]))
            del eng
            free(device)
        prob = problem(cell, inp, device)
        runs.update(sides(cell, prob, inp))
        line = {"workload": cell.name, "seed": seed, **judged(cell, prob, runs)}
        del prob
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        log(f"seed {seed}: {line['seconds']:.1f} s")
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
