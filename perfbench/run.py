"""Run one cell of the benchmark of dorylus_tpu_torch once, on the card.

    python3 perfbench/run.py --workload gcn-reddit.full --seed 7 --seconds 10 --trace 0

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics), device, with --trace 1 breakdown, and checks (each
number the output check compared, beside its limit), which also end
standard error. Exits 2 without a result where torch sees no card or fewer
cards than the cell asks for, and 3 where the process holds JAX or the JAX
package once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this script's folder, whose module names
# are the benchmark's own
sys.path[0] = str(Path(__file__).resolve().parent.parent)

# top-level module names the measured process must not hold, compared whole
FORBIDDEN = {"jax", "jaxlib", "flax", "dorylus_tpu"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.spec import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); torch sees {n}",
              file=sys.stderr)
        return 2
    from perfbench.harness import log, run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_PROCESS)
    held = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if held:
        print(f"perfbench: the process holds {', '.join(held)}", file=sys.stderr)
        return 3
    log(f"card {card_line()}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
