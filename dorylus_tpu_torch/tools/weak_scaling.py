"""Weak-scaling harness: edges/s at 1..N shards with the graph growing with
the shard count, so the work a shard holds stays constant (the port's
counterpart of the JAX package's tools/weak_scaling.py, with its flags,
defaults and JSON keys).

    python -m dorylus_tpu_torch.tools.weak_scaling [--cpu | --pin]
        [--base-vertices 8192] [--degree 16] [--feature-dim 64] [--classes 8]
        [--epochs 10] [--shards 1 2 4 8] [--kernel {xla,degree,hyb}]
        [--model {gcn,gat}] [--repeats 1] [--graph {clustered,random}]
        [--cut 0.1] [--overlap {on,off,both}] [--decompose] [--out FILE]

JAX runs one process over a mesh of n devices; the port runs one process a
shard (parallel/multihost.py `spawn_local`), rank = shard id. The parent
builds the graph and its partition once and hands rank r the file of shard
r, so the halo record and the ranks read the same partition. Three modes:

  device (neither flag)  n NCCL ranks, one card each (cuda:{rank}); a count
                         above the card count is skipped; without a card
                         the tool raises. Nothing falls back to gloo or to
                         the CPU.
  --cpu  "shared-cpu"    n gloo ranks on the host's shared cores, each with
                         os.cpu_count() // n threads (torch's default would
                         give every rank every core: oversubscription).
  --pin  "pinned-cpu"    each count re-run as a child under
                         `taskset -c 0-(n-1)`, its ranks one thread each on
                         the cores they inherit; counts above
                         os.cpu_count() are skipped.

A record, as JAX's `_measure`: a warm-up `run()`, then `--repeats` runs; a
run's epoch ms is the mean of its last `--epochs` epochs, taken as the max
over ranks (the SPMD program's epoch); the median run gives `edges_per_s`
and `epoch_ms`. In device mode the engine captures its epochs as CUDA
graphs in the warm-up run (as JAX's warm-up holds its compiles) and keeps
them, so the measured runs are replays; gloo ranks run their epochs
eagerly (parallel/train_step.py). `--overlap both` also measures the combined plan
(overlap=False) on the same shard (`serial`, `overlap_speedup`);
`--decompose` attaches `ShardedEngine.profile(iters=3)` (`stages_ms`, the
max over ranks); at n > 1 `halo` gives the exchange's rows and bytes a
epoch. efficiency(n) = edges_per_s(n) / (n * edges_per_s(1)).

What the numbers are: on the CPU the ranks run the kernels' plain torch
versions, so the CPU modes measure the SPMD program's scaling and gloo's
transport, not the kernels, and their rates are not comparable with the
JAX package's XLA:CPU results. `overlap_speedup` compares the overlap plan,
whose exchanges run beside each rank's work that does not read them, the
forward ones beside the interior gathers and the reverse ones beside the
gradient work (gloo's thread moves the rows, NCCL's side stream in device
mode; parallel/halo.py `Halo.start` / `finish`, `ReverseExchange`), with the
combined plan, which runs them whole: two plans' work and the concurrency
together.

The summary carries JAX's keys plus `backend` (gloo or nccl),
`threads_per_rank` (the torch threads of each rank, by shard count) and
`epoch_timing` ("replayed": the epochs were CUDA-graph replays, or
"eager").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_REPO = Path(__file__).resolve().parents[2]
RANK_TIMEOUT_S = 3600.0
# The launch counters a record's window reads, by the kernel names of
# chip_smoke.py's kernels line: (module, counter).
_COUNTERS = {
    "hyb_static_pass": ("hyb_spmm", "KERNEL_LAUNCHES"),
    "hyb_mask_pass": ("hyb_spmm", "MASK_LAUNCHES"),
    "hyb_dynamic_pass": ("hyb_spmm", "DYN_LAUNCHES"),
    "csr_spmm": ("spmm", "SPMM_LAUNCHES"),
    "csr_spmm_dh": ("spmm", "SPMM_T_LAUNCHES"),
    "csr_spmm_dval": ("spmm", "SPMM_DVAL_LAUNCHES"),
    "segment_sum": ("spmm", "SEGSUM_LAUNCHES"),
    "degree_pass": ("degree_spmm", "DEGREE_LAUNCHES"),
    "fused_pass": ("hyb_sharded", "FUSED_LAUNCHES"),
    "halo_row_gather": ("halo", "PACK_LAUNCHES"),
    "halo_segsum": ("halo", "HALO_BWD_LAUNCHES"),
}


def _halo_traffic(sharded, layers, model: str) -> dict:
    """Per-epoch halo bytes: padded (what the fixed-shape all_to_all
    ships) vs needed (distinct ghost rows each shard actually
    references), fwd + bwd (the collective's VJP is another all_to_all
    of the same shape). Widths follow the models' exchange widths (GCN
    transforms first when shrinking; GAT exchanges z at the out width)."""
    n, vp, mh = sharded.n_shards, sharded.vp, sharded.max_h
    needed = 0
    for s in sharded.shards:
        src = np.asarray(s.src[: s.num_edges])
        gsrc = src[src >= vp] - vp
        blocks = gsrc // mh
        for q in range(n):
            needed += len(np.unique(gsrc[blocks == q]))
    sent_rows = n * (n - 1) * mh  # per exchange, excluding self blocks
    dims = layers.dims
    widths = [dims[l + 1] if model == "gat" else min(dims[l], dims[l + 1])
              for l in range(len(dims) - 1)]
    per_row = sum(widths) * 4 * 2  # all layers, fwd + bwd, f32
    return {
        "max_h": mh,
        "ghost_rows_needed": int(needed),
        "ghost_rows_sent_per_exchange": int(sent_rows),
        "padding_waste": round(1 - needed / max(1, sent_rows), 3),
        "halo_bytes_per_epoch_sent": int(sent_rows * per_row),
        "halo_bytes_per_epoch_needed": int(needed * per_row),
    }


def mode_of(args) -> str:
    if args.pin:
        return "pinned-cpu"
    return "shared-cpu" if args.cpu else "device"


def threads_per_rank(args, n: int) -> Optional[int]:
    """The torch threads a rank runs: one in a pinned child (a core a
    rank), the host's cores over n in shared-cpu mode, torch's default
    (None) on the card."""
    if args._child is not None or args.pin:
        return 1
    return max(1, (os.cpu_count() or 1) // n) if args.cpu else None


def make_graph(args, n: int):
    """JAX's `run_once` graph at n shards."""
    from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph, synthetic_graph

    if args.graph == "clustered":
        return clustered_synthetic_graph(
            args.base_vertices * n, args.degree, args.feature_dim,
            args.classes, seed=123, window=max(64, args.base_vertices // 8),
            cut=args.cut)
    return synthetic_graph(args.base_vertices * n, args.degree, args.feature_dim,
                           args.classes, seed=123)


def make_config(args):
    """JAX's `run_once` layers and config. Reuse pinned off: the harness
    measures the scaling of one fixed kernel."""
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig

    layers = LayerConfig([args.feature_dim, 32, args.classes])
    cfg = TrainConfig(epochs=args.epochs, eval_every=0, kernel=args.kernel,
                      model=args.model, overlap=args.overlap != "off", reuse="off")
    return layers, cfg


def _launches() -> dict:
    from dorylus_tpu_torch.ops import degree_spmm, hyb_sharded, hyb_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    mods = {"hyb_spmm": hyb_spmm, "spmm": spmm, "degree_spmm": degree_spmm,
            "hyb_sharded": hyb_sharded, "halo": halo}
    return {k: getattr(mods[m], c) for k, (m, c) in _COUNTERS.items()}


def _measure(eng, edges: int, epochs: int, repeats: int) -> tuple[dict, list]:
    """JAX's `_measure` on every rank, each run's epoch the max over the
    world's ranks; also the warm-up run's losses."""
    warm = eng.run()  # warm-up: the first groups, cuBLAS's and the plans' first calls
    losses = [e.loss for e in warm.epochs[-epochs:]]
    runs = []
    for _ in range(max(1, repeats)):
        rep = eng.run()
        ms = torch.tensor([np.mean([e.time_ms for e in rep.epochs[-epochs:]])],
                          dtype=torch.float64, device=eng.device)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        runs.append(round(edges / (float(ms) / 1e3), 1))
    runs.sort()
    return {
        "edges_per_s": runs[len(runs) // 2],
        "epoch_ms": round(edges / runs[len(runs) // 2] * 1e3, 2),
        "edges_per_s_runs": runs,
    }, losses


def _rank(rank: int, world: int, device, shard_dir: str, dims: list, cfg,
          opts: dict) -> dict:
    """One rank of a record: the ShardedEngine of shard file `rank`, its
    measurement, the combined plan's with `both`, the stage profile with
    `decompose`; the kernel launches of the first engine's measurement, the
    rank's backend, torch threads and cores."""
    from dorylus_tpu_torch.common.config import LayerConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    if opts["threads"] is not None:
        torch.set_num_threads(opts["threads"])
    shard, meta = load_shard(Path(shard_dir) / f"shard_{rank}.npz")
    layers = LayerConfig(list(dims))
    eng = ShardedEngine((shard, meta), layers, cfg, device=device)
    before = _launches()
    measure, losses = _measure(eng, opts["edges"], opts["epochs"], opts["repeats"])
    out = {"measure": measure, "losses": losses, "backend": dist.get_backend(),
           "epoch_timing": "replayed" if eng._graphs is not None else "eager",
           "threads": torch.get_num_threads(), "cores": len(os.sched_getaffinity(0)),
           "launches": {k: n - before[k] for k, n in _launches().items() if n > before[k]}}
    if world > 1 and opts["both"]:
        eng2 = ShardedEngine((shard, meta), layers, dataclasses.replace(cfg, overlap=False),
                             device=device)
        out["serial"] = _measure(eng2, opts["edges"], opts["epochs"], opts["repeats"])[0]
        del eng2
    if opts["decompose"]:
        out["stages_ms"] = {k: round(v, 2) for k, v in eng.profile(iters=3).items()}
    return out


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("weak_scaling: device mode runs one NCCL rank a card and "
                           "torch.cuda.is_available() is False; pass --cpu (shared cores) "
                           "or --pin (a core a rank) to run gloo ranks on the CPU")


def run_shards(args, n: int, timeout_s: float = RANK_TIMEOUT_S) -> tuple[dict, list]:
    """One shard count in this process's mode: (the record with JAX's keys,
    each rank's result). Device mode builds the engines' CUDA libraries
    here first, once, and starts n NCCL ranks; the CPU modes n gloo
    ranks. A rank that fails, or ranks still running after timeout_s,
    raise."""
    from dorylus_tpu_torch.graph.partition import ShardMeta, partition_graph, save_shard
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    if mode_of(args) == "device":
        _need_card()
        from dorylus_tpu_torch import cli
        from dorylus_tpu_torch.ops import cuda_build

        cuda_build.compile_sources(cli._engine_sources())
        backend, device = "nccl", "cuda:{rank}"
    else:
        backend, device = "gloo", "cpu"
    g = make_graph(args, n)
    layers, cfg = make_config(args)
    sharded = partition_graph(g, n, for_gat=args.model == "gat")
    meta = ShardMeta.of(sharded)
    halo = _halo_traffic(sharded, layers, args.model) if n > 1 else None
    shard_dir = tempfile.mkdtemp(prefix="dorylus_weak_")
    try:
        for s in sharded.shards:
            save_shard(Path(shard_dir) / f"shard_{s.shard_id}.npz", s, meta)
        del sharded
        opts = dict(edges=g.num_edges, epochs=args.epochs, repeats=args.repeats,
                    both=args.overlap == "both", decompose=args.decompose,
                    threads=threads_per_rank(args, n))
        ranks = spawn_local(n, _rank, (shard_dir, layers.dims, cfg, opts), backend=backend,
                            device=device, timeout_s=timeout_s)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    r0 = ranks[0]
    rec = {"shards": n, "vertices": g.num_vertices, "edges": g.num_edges,
           "overlap": cfg.overlap}
    rec.update(r0["measure"])
    if n > 1 and args.overlap == "both":
        rec["serial"] = r0["serial"]
        rec["overlap_speedup"] = round(rec["edges_per_s"] / rec["serial"]["edges_per_s"], 3)
    if args.decompose:
        rec["stages_ms"] = r0["stages_ms"]
    if n > 1:
        rec["halo"] = halo
    return rec, ranks


def pinned_efficiency(results: list) -> None:
    """JAX's pinned-mode efficiency, in place: against the first record's
    edges/s scaled by its shard count."""
    base = results[0]
    for r in results:
        r["weak_scaling_efficiency"] = round(
            r["edges_per_s"] / (base["edges_per_s"] * r["shards"] / base["shards"]), 3)


def efficiency(rec: dict, base_eps: float) -> float:
    """JAX's shared and device-mode efficiency: against base_eps, the first
    record's edges/s over its shard count."""
    return round(rec["edges_per_s"] / (base_eps * rec["shards"]), 3)


def what_line(mode: str) -> str:
    """The `#` line printed before the records: what the numbers are."""
    if mode == "device":
        where = ("NCCL ranks, one card each: the kernels' rates and NCCL's transport "
                 "(one card: a world of 1, no exchange)")
    else:
        where = ("gloo ranks on this host's CPU cores, which run the kernels' plain torch "
                 "versions: the SPMD program's scaling and gloo's transport, not the "
                 "kernels; rates not comparable with the JAX package's XLA:CPU results")
    return (f"# {mode}: {where}. overlap_speedup compares two plans' work and the "
            "exchanges run beside the work that does not read them, forward and reverse "
            "(parallel/halo.py Halo.start / finish)")


def _pinned(args, out) -> dict:
    """--pin: each count in a child under taskset, its last line the
    record."""
    ncores = os.cpu_count() or 1
    results, threads = [], {}
    out(what_line("pinned-cpu"))
    for n in args.shards:
        if n > ncores:
            out(f"# skipping {n} shards (only {ncores} cores to pin)")
            continue
        cmd = ["taskset", "-c", f"0-{n - 1}" if n > 1 else "0",
               sys.executable, "-m", "dorylus_tpu_torch.tools.weak_scaling",
               "--_child", str(n),
               "--cpu", "--kernel", args.kernel, "--graph", args.graph,
               "--model", args.model, "--overlap", args.overlap,
               "--cut", str(args.cut), "--epochs", str(args.epochs),
               "--repeats", str(args.repeats),
               "--base-vertices", str(args.base_vertices),
               "--degree", str(args.degree),
               "--feature-dim", str(args.feature_dim),
               "--classes", str(args.classes)] \
            + (["--decompose"] if args.decompose else [])
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO)
        if res.returncode != 0:
            raise RuntimeError(f"weak_scaling: the {n}-shard child exited with "
                               f"{res.returncode}:\n{res.stderr[-4000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        results.append(rec)
        threads[str(n)] = threads_per_rank(args, n)
        out(json.dumps(rec))
    if results:
        pinned_efficiency(results)
    return {"weak_scaling": results, "mode": "pinned-cpu", "graph": args.graph,
            "cut": args.cut, "kernel": args.kernel, "model": args.model,
            "cores": ncores, "repeats": args.repeats, "backend": "gloo",
            "threads_per_rank": threads, "epoch_timing": "eager"}


def sweep(args, out=print, timeout_s: float = RANK_TIMEOUT_S) -> tuple[dict, dict]:
    """Every shard count the mode can run, in order, each record printed
    through `out` as it comes (skip lines for counts above the cores or
    cards): (the summary, each run count's rank results; none for the
    pinned children)."""
    mode = mode_of(args)
    if mode == "pinned-cpu":
        return _pinned(args, out), {}
    if mode == "device":
        _need_card()
    results, threads, by_n, timing = [], {}, {}, None
    base_eps = None
    out(what_line(mode))
    for n in args.shards:
        if mode == "device" and n > torch.cuda.device_count():
            out(f"# skipping {n} shards (only {torch.cuda.device_count()} devices)")
            continue
        rec, ranks = run_shards(args, n, timeout_s)
        if base_eps is None:
            base_eps = rec["edges_per_s"] / n
        rec["weak_scaling_efficiency"] = efficiency(rec, base_eps)
        results.append(rec)
        threads[str(n)] = ranks[0]["threads"]
        timing = ranks[0]["epoch_timing"]  # one mode, one backend: every rank's
        by_n[n] = ranks
        out(json.dumps(rec))
    summary = {"weak_scaling": results, "mode": mode, "graph": args.graph, "cut": args.cut,
               "kernel": args.kernel, "model": args.model,
               "backend": "nccl" if mode == "device" else "gloo",
               "threads_per_rank": threads, "epoch_timing": timing}
    return summary, by_n


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="weak_scaling")
    ap.add_argument("--base-vertices", type=int, default=8192)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--feature-dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the host's shared cores")
    ap.add_argument("--kernel", default="xla", choices=["xla", "degree", "hyb"],
                    help="aggregation kernel (see TrainConfig.kernel)")
    ap.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    ap.add_argument("--repeats", type=int, default=1,
                    help="median-of-N measured runs on the warm engine")
    ap.add_argument("--graph", default="clustered", choices=["clustered", "random"],
                    help="clustered = METIS-partitioned-real-graph analog")
    ap.add_argument("--cut", type=float, default=0.1,
                    help="cross-window edge fraction for --graph clustered")
    ap.add_argument("--overlap", default="on", choices=["on", "off", "both"],
                    help="interior/boundary overlap plan; 'both' also measures the "
                         "combined plan on the same partition")
    ap.add_argument("--decompose", action="store_true",
                    help="attach ShardedEngine.profile's per-stage bracket")
    ap.add_argument("--pin", action="store_true",
                    help="re-run each shard count under taskset with one host core per "
                         "shard (caps shard counts at the core count)")
    ap.add_argument("--out", default=None, help="write the summary JSON here")
    ap.add_argument("--_child", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args._child is not None:
        print(json.dumps(run_shards(args, args._child)[0]), flush=True)
        return 0
    summary = sweep(args, out=lambda line: print(line, flush=True))[0]
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
