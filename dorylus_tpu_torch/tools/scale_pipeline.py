"""The host pipeline at the reference's scale, and a large sharded run
against one device (the port's counterpart of the JAX package's
tools/scale_pipeline.py).

    python -m dorylus_tpu_torch.tools.scale_pipeline partition-1b [--edges 1.02e9]
        [--shards 32] [--degree 16] [--feature-dim 8] [--out FILE]
    python -m dorylus_tpu_torch.tools.scale_pipeline train-300m [--edges 3e8]
        [--ranks 8] [--degree 16] [--epochs 3] [--device cpu] [--out FILE]

partition-1b: generate a clustered graph of `--edges` edges
(`gen_graph`), range-partition it into `--shards` shards, build each
shard's exact-wire halo plan (parallel/halo.py `HaloPlan`, the per-peer
counts taken from every shard's ghost ranks, as the collective would
learn them) and its fused-overlap hyb plan (ops/hyb_sharded.py
`ShardedHybSpMM`, static values, f32), the ranks one after another in this
process on the CPU, each over its own edges as a rank of the port builds
it. Each phase's seconds and the host's peak RSS after it; each rank's plan
bytes (logical: the tensors' bytes, no tile padding) and their total. A
rank's plans are freed before the next rank's are built.

train-300m: a graph of `--edges` edges, layers 16-32-16, kernel="hyb",
bf16 gather tables: the one-device `Engine` on `--device` (the card by
default), then `ShardedEngine` on `--ranks` gloo ranks of the same device
on the same graph (the parent partitions once and writes a shard file a
rank); the two trajectories must agree to 2e-3 (the JAX tool's bar).

Each prints one JSON record and writes it to `--out` if given.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np


def rss_gb() -> float:
    """The peak RSS of this process so far, GiB: VmHWM where /proc has it
    (a spawned rank's own, which ru_maxrss is not: it keeps the parent's
    peak across exec), else ru_maxrss (KiB on Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def gen_graph(num_edges: int, deg: int, feature_dim: int, classes: int,
              seed: int = 17, cut: float = 0.1):
    from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph

    v = int(num_edges) // deg
    return clustered_synthetic_graph(v, deg, feature_dim, classes,
                                     seed=seed, window=8192, cut=cut)


def plan_bytes(obj) -> int:
    """Logical bytes of the tensors and arrays an op or a plan holds
    (dicts, lists and tuples walked; each tensor counted once)."""
    import torch

    seen, total, stack = set(), 0, [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, np.ndarray):
            total += x.nbytes
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            stack.extend(vars(x).values())
    return total


def partition_1b(edges: float, shards: int = 32, degree: int = 16,
                 feature_dim: int = 8) -> dict:
    from dorylus_tpu_torch.graph.partition import partition_graph
    from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
    from dorylus_tpu_torch.parallel.halo import HaloPlan, ghost_counts

    n = shards
    rec = {"requested_edges": int(edges), "shards": n, "feature_dim": feature_dim,
           "degree": degree, "phases": {}, "rss_gb": {}}

    def done(phase: str, t0: float) -> None:
        rec["phases"][f"{phase}_s"] = time.perf_counter() - t0
        rec["rss_gb"][f"after_{phase}"] = rss_gb()
        print(f"{phase}: {rec['phases'][f'{phase}_s']:.1f} s, peak rss "
              f"{rec['rss_gb'][f'after_{phase}']:.2f} GiB", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    g = gen_graph(edges, degree, feature_dim, 16)
    rec["vertices"], rec["edges"] = int(g.num_vertices), int(g.num_edges)
    done("generate", t0)

    t0 = time.perf_counter()
    sharded = partition_graph(g, n, method="range")
    rec.update(vp=int(sharded.vp), ep=int(sharded.ep), max_h=int(sharded.max_h))
    cut = sum(int(s.num_edges - s.num_int) for s in sharded.shards)
    rec["edge_cut"] = cut / max(1, g.num_edges)
    rec["feature_shape"] = list(g.features.shape)
    done("partition", t0)
    del g
    gc.collect()

    # the exact wire: every shard's ghost rows per owner, and what each
    # shard sends (the transpose), as the plan's all-to-all of counts gives
    t0 = time.perf_counter()
    recv = np.stack([ghost_counts(s, n, sharded.vp, sharded.max_h) for s in sharded.shards])
    send = recv.T
    halo_bytes, wire_rows = [], []
    for r, s in enumerate(sharded.shards):
        plan = HaloPlan(s, n, "ragged", "cpu", counts=(send[r], recv[r]))
        halo_bytes.append(plan_bytes(plan))
        wire_rows.append(plan.wire_rows(r))
        del plan
    rec["halo_plan_bytes"] = halo_bytes
    rec["ragged_rows_on_wire"] = int(sum(wire_rows))
    done("halo_plans", t0)

    t0 = time.perf_counter()
    hyb_bytes, n_pure = [], []
    for s in sharded.shards:
        op = ShardedHybSpMM(s, n, edges="fused", static_vals=True, device="cpu")
        hyb_bytes.append(plan_bytes((op.fwd, op.bwd)))
        n_pure.append(int(op.n_pure))
        del op
        gc.collect()
    rec["hyb_fused_plan_bytes"] = hyb_bytes
    rec["hyb_fused_plan_bytes_total"] = int(sum(hyb_bytes))
    rec["halo_plan_bytes_total"] = int(sum(halo_bytes))
    rec["n_pure_buckets"] = n_pure
    done("hyb_fused_plans", t0)
    rec["rss_peak_gb"] = rss_gb()
    return rec


def _shard_rank(rank: int, world: int, device, shard_dir: str, dims: list,
                cfg_kw: dict) -> dict:
    """One rank of `train_shards`: the ShardedEngine of shard file `rank`."""
    import torch

    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    shard, meta = load_shard(Path(shard_dir) / f"shard_{rank}.npz")
    t0 = time.perf_counter()
    eng = ShardedEngine((shard, meta), LayerConfig(dims), TrainConfig(**cfg_kw),
                        device=device)
    build_s = time.perf_counter() - t0
    rep = eng.run()
    return {"losses": [e.loss for e in rep.epochs], "epoch_ms": [e.time_ms for e in rep.epochs],
            "build_s": build_s, "kernel": eng.kernel_selected,
            "overlap": bool(eng.cfg.overlap), "wire": eng.halo_plan.wire,
            "overlap_fused": bool(getattr(eng.model.spmm_split, "fused", False)),
            "edges": int(shard.num_edges), "rss_gb": rss_gb(),
            "hbm_peak_bytes": (rep.notes.get("hbm") or {}).get("peak_bytes_in_use")}


def train_shards(g, ranks: int, dims: list, cfg_kw: dict, device) -> tuple[list, float, float]:
    """Partition g once into `ranks` range shards, one file each, and train
    the ShardedEngine of each on `ranks` gloo ranks of `device` (the CPU, or
    all on the one card, its libraries built here first); (each rank's
    result, the partition's seconds, the ranks' wall seconds)."""
    import torch

    from dorylus_tpu_torch.graph.partition import ShardMeta, partition_graph, save_shard
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    on_card = torch.device(device).type == "cuda"
    if on_card:
        from dorylus_tpu_torch import cli
        from dorylus_tpu_torch.ops import cuda_build

        cuda_build.compile_sources(cli._engine_sources())
    shard_dir = tempfile.mkdtemp(prefix="dorylus_shards_")
    try:
        t0 = time.perf_counter()
        sharded = partition_graph(g, ranks, method="range")
        meta = ShardMeta.of(sharded)
        for s in sharded.shards:
            save_shard(Path(shard_dir) / f"shard_{s.shard_id}.npz", s, meta)
        del sharded
        gc.collect()
        partition_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = spawn_local(ranks, _shard_rank, (shard_dir, dims, dict(cfg_kw, num_shards=ranks)),
                          backend="gloo", device="cuda:0" if on_card else "cpu",
                          timeout_s=3600)
        return res, partition_s, time.perf_counter() - t0
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)


def train_300m(edges: float, ranks: int = 8, degree: int = 16, feature_dim: int = 16,
               epochs: int = 3, device: Optional[str] = None) -> dict:
    import torch

    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.common.device import resolve_device
    from dorylus_tpu_torch.engine.engine import Engine

    dev = resolve_device(device)
    feature_dim = max(feature_dim, 16)
    dims = [feature_dim, 32, 16]
    kw = dict(epochs=epochs, eval_every=0, kernel="hyb", agg_dtype="bfloat16", reuse="off")
    rec = {"requested_edges": int(edges), "ranks": ranks, "device": str(dev), "phases": {}}
    t0 = time.perf_counter()
    g = gen_graph(edges, degree, feature_dim, 16)
    rec["phases"]["generate_s"] = time.perf_counter() - t0
    rec["vertices"], rec["edges"] = int(g.num_vertices), int(g.num_edges)
    print(f"generated V={g.num_vertices} E={g.num_edges}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    eng = Engine(g, LayerConfig(dims), TrainConfig(**kw), device=dev)
    rec["phases"]["single_engine_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = eng.run()
    rec["phases"]["single_train_s"] = time.perf_counter() - t0
    rec["single_losses"] = [e.loss for e in rep.epochs]
    rec["single_epoch_ms"] = [e.time_ms for e in rep.epochs]
    rec["single_hbm_peak_bytes"] = (rep.notes.get("hbm") or {}).get("peak_bytes_in_use")
    del eng, rep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["rss_after_single_gb"] = rss_gb()

    res, rec["phases"]["partition_s"], rec["phases"]["sharded_s"] = train_shards(
        g, ranks, dims, kw, dev)
    rec["sharded_losses"] = res[0]["losses"]
    rec["sharded_epoch_ms"] = res[0]["epoch_ms"]
    rec["overlap_fused"] = res[0]["overlap_fused"]
    rec["rank_build_s"] = [r["build_s"] for r in res]
    rec["rank_edges"] = [r["edges"] for r in res]
    rec["rank_rss_gb"] = [r["rss_gb"] for r in res]
    rec["rank_hbm_peak_bytes"] = [r["hbm_peak_bytes"] for r in res]
    rec["max_loss_delta"] = max(abs(a - b) for a, b in
                                zip(rec["sharded_losses"], rec["single_losses"]))
    rec["parity_ok"] = bool(rec["max_loss_delta"] < 2e-3)
    rec["rss_peak_gb"] = rss_gb()
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="scale_pipeline")
    ap.add_argument("cmd", choices=["partition-1b", "train-300m"])
    ap.add_argument("--edges", type=float, default=None)
    ap.add_argument("--shards", type=int, default=32, help="partition-1b's shards")
    ap.add_argument("--ranks", type=int, default=8, help="train-300m's gloo ranks")
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--feature-dim", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None, help="train-300m: the card by default, or cpu")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.cmd == "partition-1b":
        rec = partition_1b(a.edges or 1.02e9, a.shards, a.degree, a.feature_dim)
    else:
        rec = train_300m(a.edges or 3.0e8, a.ranks, a.degree, a.feature_dim, a.epochs,
                         a.device)
    text = json.dumps(rec, indent=1)
    print(text, flush=True)
    if a.out:
        Path(a.out).write_text(text)
    if not rec.get("parity_ok", True):
        print(f"scale_pipeline: loss delta {rec['max_loss_delta']:.3e} >= 2e-3",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    # the package module's functions, so the ranks (fresh interpreters) can
    # import their target by name
    from dorylus_tpu_torch.tools.scale_pipeline import main as _main

    sys.exit(_main())
