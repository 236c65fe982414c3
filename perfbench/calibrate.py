"""The readings the limits of a cell's output check are set from, at the
cell's own size, one JSON line a seed:

    python3 perfbench/calibrate.py --workload gcn-reddit.full --seeds 11 12 13 [--program]

For each seed, against the plain reference from the seed's inputs:
  control     the reference in the nearest precision below the
              configuration's: its float32 matmuls in TF32;
  half_batch  the reference with every other training row left out and the
              mean taken over the rest;
  stale_eval  the reference's eval answered from the parameters before each
              step's update;
  unchanged   a step that leaves the state unchanged (no run needed);
  reference_again  the reference run a second time (its f32 sums are
              atomic adds, in another order each run): its own spread;
  program     (with --program) the program's checked steps, as a run makes
              them (sound runs: the lower reading).
Each with its readings and whether the cell's limits call it correct; the
program, the control and the second reference also by step (loss_gap,
delta_gap and eval_gap read up to each).
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
from perfbench.harness import build_engine, first_steps, free, log, reference_steps  # noqa: E402
from perfbench.inputs import make_inputs  # noqa: E402
from perfbench.reference.gnn import TRAIN_PORTION, split_masks  # noqa: E402
from perfbench.spec import Cell  # noqa: E402


def first(side: dict, k: int) -> dict:
    """A side's first k checked steps."""
    return dict(side, **{key: side[key][:k] for key in ("losses", "evals", "deltas")})


def by_step(side: dict, ref: dict) -> list:
    """loss_gap, delta_gap and eval_gap read up to each step."""
    out = []
    for k in range(1, len(ref["losses"]) + 1):
        r = check.readings(first(side, k), first(ref, k))
        out.append({"loss_gap": r["loss_gap"], "delta_gap": r["delta_gap"],
                    "eval_gap": r["eval_gap"]})
    return out


def fault_readings(cell: Cell, inp, ref: dict, device: torch.device) -> dict:
    def read(side):
        return check.readings(side, ref)

    control = reference_steps(cell, inp, device, tf32=True)
    again = reference_steps(cell, inp, device)
    out = {"control": read(control), "control_by_step": by_step(control, ref),
           "reference_again": read(again), "reference_again_by_step": by_step(again, ref)}
    train, _ = split_masks(inp.split_ids, inp.num_vertices)
    half = train & (inp.split_ids % 2 == 0)
    den = float(np.float32(inp.num_vertices * TRAIN_PORTION))
    out["half_batch"] = read(reference_steps(cell, inp, device, train_mask=half, denom=den / 2))
    out["stale_eval"] = read(dict(ref, evals=[ref["eval0"]] + ref["evals"][:-1]))
    n = len(ref["losses"])
    out["unchanged"] = read(
        {"losses": [ref["losses"][0]] * n, "evals": [ref["eval0"]] * n,
         "grad1": {k: torch.zeros_like(g) for k, g in ref["grad1"].items()},
         "deltas": [{k: torch.zeros_like(d) for k, d in ref["deltas"][0].items()}] * n})
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
        line = {"workload": cell.name, "seed": seed}
        if args.program:
            eng = build_engine(cell.config, cell.traffic, inp, device)
            prog, _ = first_steps(eng, int(cell.traffic["check_steps"]))
            del eng
            free(device)
        ref = reference_steps(cell, inp, device)
        if args.program:
            line["program"] = check.readings(prog, ref)
            line["program_by_step"] = by_step(prog, ref)
        line.update(fault_readings(cell, inp, ref, device))
        for key in ("program", "control", "half_batch", "stale_eval", "unchanged",
                    "reference_again"):
            if key in line:
                line[key + "_correct"] = check.judge(line[key], cell.limits)[0]
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        log(f"seed {seed}: {line['seconds']:.1f} s")
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
