"""The sharded engine at the reference's widest cluster, 32 graph servers
(benchmarks/run-friendster-gcn): 32 ranks against one device.

    python -m dorylus_tpu_torch.tools.validate_32way [--ranks 32]
        [--vertices 131072] [--degree 16] [--epochs 4] [--device cpu]
        [--out FILE]

`clustered_synthetic_graph(vertices, degree, 32, 8, seed=7, cut=0.1)`,
layers 32-16-8, kernel="hyb", reuse="off", a range partition into `--ranks`
shards: `--ranks` gloo ranks (scale_pipeline.py `train_shards`) each train
the `ShardedEngine` of their shard; the port's one-device `Engine` trains
the same graph. The losses must agree to 1e-3 (the sharded-parity bar of the
JAX package's tools/validate_32way.py). This checks that the exchange, the
per-rank plans and the summed update run and agree at that width; it is
no speed measurement (32 ranks share the host's cores). By default the
engine and every rank run on the one card (gloo through the host), and the
tool raises without one; `--device cpu` runs them all on the CPU. Prints
one JSON record with the JAX record's keys
(benchmarks/results/sharded_32way_r5.json): max_abs_loss_delta, parity_ok,
the losses, and the wall seconds of the ranks' run (their start and plan
builds included).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

DIMS = [32, 16, 8]


def validate(ranks: int = 32, vertices: int = 131_072, degree: int = 16, epochs: int = 4,
             device: Optional[str] = None) -> dict:
    """The record (parity_ok: the losses within 1e-3 of one device's);
    device None means the card."""
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.common.device import resolve_device
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph
    from dorylus_tpu_torch.tools.scale_pipeline import train_shards

    dev = resolve_device(device)
    g = clustered_synthetic_graph(vertices, degree, 32, 8, seed=7, cut=0.1)
    cfg_kw = dict(epochs=epochs, eval_every=0, kernel="hyb", reuse="off")
    single = Engine(g, LayerConfig(DIMS), TrainConfig(**cfg_kw), device=dev).run()
    losses_1 = [e.loss for e in single.epochs]
    res, _, wall = train_shards(g, ranks, DIMS, cfg_kw, dev)
    losses_n = res[0]["losses"]
    if any(r["losses"] != losses_n for r in res):
        raise AssertionError("the ranks report different losses")
    delta = max(abs(a - b) for a, b in zip(losses_1, losses_n))
    return {
        "what": f"{ranks}-rank sharded execution against one device (not a speed "
                f"measurement: {ranks} ranks share the host). Reference width: 32 graph "
                "servers, benchmarks/run-friendster-gcn",
        "num_vertices": int(g.num_vertices), "num_edges": int(g.num_edges),
        "kernel": res[0]["kernel"], "overlap": res[0]["overlap"], "wire": res[0]["wire"],
        "ranks": ranks, "device": str(dev), "epochs": epochs,
        "loss_single": losses_1, "loss_32way": losses_n,
        "max_abs_loss_delta": delta, "parity_ok": bool(delta < 1e-3),
        "wall_s_32way": wall,
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="validate_32way")
    ap.add_argument("--ranks", type=int, default=32)
    ap.add_argument("--vertices", type=int, default=131_072)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default=None, help="the card by default, or cpu")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    rec = validate(a.ranks, a.vertices, a.degree, a.epochs, a.device)
    text = json.dumps(rec, indent=1)
    print(text, flush=True)
    if a.out:
        Path(a.out).write_text(text)
    if not rec["parity_ok"]:
        print(f"validate_32way: max |loss delta| {rec['max_abs_loss_delta']:.3e} >= 1e-3",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
