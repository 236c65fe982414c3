"""Command line of the port (the counterpart of dorylus_tpu/cli.py).

    python -m dorylus_tpu_torch.cli train --dataset synthetic --model gcn --epochs 50
    python -m dorylus_tpu_torch.cli train --data-dir data/cora --config cora --shards 4
    python -m dorylus_tpu_torch.cli infer --data-dir data/cora --config cora \
        --checkpoint-dir ck --out preds.txt
    python -m dorylus_tpu_torch.cli prepare-data --edges g.txt --features f.txt \
        --labels l.txt --out data/mygraph --feature-dim 128 --classes 7
    python -m dorylus_tpu_torch.cli partition --graph data/cora/graph.bsnap --n 4

The subcommands and flags are the JAX package's, so a command line written
for it runs here unchanged. Where the port differs:

  * `--device` replaces `--platform`: the default is the card, and without
    one `train` and `infer` exit non-zero with one line; `--device cpu`
    runs on the CPU (`--platform cpu` is taken as `--device cpu`).
  * `--compile-cache`, `--epochs-per-call` and `--edge-chunk` tune the JAX
    package's compiled epoch groups and XLA's message tensors; they are
    accepted and ignored, with one log line each.
  * What is not ported exits non-zero naming its ROADMAP.md item: the
    `bench` subcommand (item 5).
  * `--shards n --feat-shards m` starts n * m ranks on this host
    (parallel/multihost.py `spawn_local`): one card each over NCCL when
    there are n * m cards, all on the one card over gloo when there are
    fewer, gloo on the CPU under `--device cpu`. The parent partitions the
    graph n ways once and hands rank r the file of shard r // m (m > 1 is
    tensor parallelism, `--feat-shards m` alone one shard on m ranks, as
    the JAX package routes it); rank 0 writes `--output`, and its summary
    is printed.
  * `--profile` times the stages after training (engine/profiling.py) and
    logs each bracket; the report's stage_times hold them.
  * The report's notes gain "setup_s" (seconds: the graph loaded or
    generated, its --reorder, and the engine's build: plans, batch,
    params; with --shards, also the partition and rank 0's build) and
    "graph" (vertices, edges, layer dims).

Exit codes: 0 done, 2 a refusal or a missing card (one line on stderr).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

# A sharded run's ranks may take as long as training does; the launcher
# still stops every rank as soon as one fails.
_RANK_TIMEOUT_S = 7 * 24 * 3600.0


class CliError(Exception):
    """A refusal: printed as one line, exit code 2."""


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | name of a preset config (cora/reddit/...)")
    p.add_argument("--data-dir", default=None,
                   help="directory with graph.bsnap/features.bsnap/labels.bsnap")
    p.add_argument("--config", default=None,
                   help="layer preset name or path to a *.config file")
    p.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--target-acc", type=float, default=None)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--feat-shards", type=int, default=1,
                   help="tensor parallelism: feature-column shards per "
                        "vertex shard, one process each")
    p.add_argument("--shards", type=int, default=1,
                   help="vertex shards, one process each (1 = one device)")
    p.add_argument("--partition", default="range",
                   choices=["range", "hash", "metis", "ldg"],
                   help="vertex partitioner for --shards > 1 (ldg = native "
                        "streaming greedy, the METIS stand-in)")
    p.add_argument("--reorder", default="none",
                   choices=["none", "bfs", "degree", "degree-asc"],
                   help="relabel vertices before training (bfs = RCM-like "
                        "locality order; degree-asc = ascending in-degree)")
    p.add_argument("--parts-file", default=None,
                   help="METIS-style parts file (with --partition metis)")
    p.add_argument("--edge-chunk", type=int, default=0,
                   help="accepted and ignored: the CSR kernels build no "
                        "(E, F) message tensor to chunk")
    p.add_argument("--epochs-per-call", type=int, default=0,
                   help="accepted and ignored: the port runs one epoch a "
                        "Python iteration")
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "xla", "degree", "hyb"],
                   help="aggregation kernel (auto = hyb past 8M edges "
                        "else xla, the edgewise CSR kernels; hyb = hybrid "
                        "ELL, degree = degree-padded blocks)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--agg-bf16", action="store_true",
                   help="gather aggregation tables in bfloat16 (f32 "
                        "accumulation; slot kernels: hyb and degree)")
    p.add_argument("--reuse", default="auto",
                   choices=["auto", "off", "pairs"],
                   help="mine common neighbor pairs into reusable gather-"
                        "table rows (exact; graph/reuse.py); kernel=hyb. "
                        "auto is off in the port")
    p.add_argument("--reuse-passes", type=int, default=1,
                   help="pair-mining hierarchy depth (2 = pairs-of-pairs)")
    p.add_argument("--reuse-max-pairs", type=int, default=-1,
                   help="pair budget per mining pass: -1 = auto, "
                        "0 = unlimited, N = keep the N highest-count pairs")
    p.add_argument("--halo", default="auto",
                   choices=["auto", "padded", "ragged"],
                   help="halo wire format: ragged = exact per-pair row "
                        "counts, padded = max_h rows per pair; auto = ragged")
    p.add_argument("--overlap", default="auto",
                   choices=["auto", "on", "off"],
                   help="halo/compute overlap plan: auto = the fused plan "
                        "on hyb, the (interior, boundary) pair on degree, "
                        "off on xla")
    p.add_argument("--no-overlap", action="store_true",
                   help=argparse.SUPPRESS)  # legacy alias for --overlap off
    p.add_argument("--compile-cache", default=None, metavar="DIR|off",
                   help="accepted and ignored: the JAX package's XLA "
                        "compile cache")
    p.add_argument("--staleness", type=int, default=None,
                   help="bounded-staleness async mode (pipeline.cpp:95-102): "
                        "gradients may be computed against weights up to N "
                        "epochs old; works on both engines. Omit for "
                        "synchronous training (the reference default).")
    p.add_argument("--switch-threshold", type=float, default=0.9,
                   help="async->sync switch point as a fraction of "
                        "--target-acc (weightserver.cpp:270-294)")
    p.add_argument("--lr-decay-every", type=int, default=0,
                   help="decay LR every N epochs (0=off, reference default; "
                        "weightserver.cpp:296-305)")
    p.add_argument("--lr-decay-factor", type=float, default=0.7)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--output", default=None, help="report file (output_<node>)")
    p.add_argument("--profile", action="store_true",
                   help="per-stage timing after training (halo / aggregate "
                        "/ dense / forward / loss+grad), logged and in the "
                        "report's stage_times")
    _add_device_args(p)
    # synthetic graph knobs
    p.add_argument("--synth-vertices", type=int, default=10000)
    p.add_argument("--synth-degree", type=int, default=10)


def _add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device: the card by default (cuda), or cpu")
    p.add_argument("--platform", default=None, choices=["cpu", "tpu"],
                   help=argparse.SUPPRESS)  # the JAX package's flag


def _device(args) -> str:
    """The device a command runs on: --device, the card when none is
    named (a CliError without one), the CPU only when asked."""
    import torch

    from dorylus_tpu_torch.common.logging import log

    if args.platform == "tpu":
        raise CliError("--platform tpu: the port runs on a CUDA card or the CPU "
                       "(--device)")
    if args.platform == "cpu" and args.device is None:
        log("--platform cpu taken as --device cpu")
        args.device = "cpu"
    if args.device is None:
        if not torch.cuda.is_available():
            raise CliError("no CUDA device is visible (torch.cuda.is_available() is "
                           "False); pass --device cpu to run on the CPU")
        args.device = "cuda"
    return args.device


def _log_ignored(args) -> None:
    from dorylus_tpu_torch.common.logging import log

    for flag, given in (("--compile-cache", args.compile_cache is not None),
                        ("--epochs-per-call", args.epochs_per_call != 0),
                        ("--edge-chunk", args.edge_chunk != 0)):
        if given:
            log("%s ignored: it tunes the JAX package's compiled programs "
                "(ROADMAP.md, \"Not to port\")", flag)


def make_config(args):
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.common.logging import log

    cfg = TrainConfig(
        model=args.model, epochs=args.epochs, learning_rate=args.learning_rate,
        target_accuracy=args.target_acc, eval_every=args.eval_every,
        num_shards=args.shards, feat_shards=args.feat_shards,
        kernel=args.kernel, reuse=args.reuse, reuse_passes=args.reuse_passes,
        reuse_max_pairs=args.reuse_max_pairs, halo=args.halo,
        overlap="off" if args.no_overlap else args.overlap,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        agg_dtype="bfloat16" if args.agg_bf16 else "float32",
        staleness=args.staleness, switch_threshold=args.switch_threshold,
        lr_decay_every=args.lr_decay_every, lr_decay_factor=args.lr_decay_factor,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume)
    if args.switch_threshold != 0.9 and args.target_acc is None:
        log("WARNING: --switch-threshold has no effect without --target-acc")
    return cfg


def _layers(name: Optional[str], dataset: Optional[str] = None):
    """Layer config resolution: explicit file > preset name > dataset preset."""
    from dorylus_tpu_torch.common.config import LayerConfig

    if name and name in LayerConfig.PRESETS:
        return LayerConfig.preset(name)
    if name:
        return LayerConfig.from_file(name)
    if dataset in LayerConfig.PRESETS:
        return LayerConfig.preset(dataset)
    return None  # derive from data


def load_graph(args):
    """(graph, layers, parts, seconds) for `train`, as the JAX package's
    cmd_train builds them: the dataset directory or the synthetic graph
    (seed 8888), the --reorder relabelling, and the parts file in the new
    ids; seconds: {"graph": the load or generation (and the parts file),
    "reorder": the relabelling}."""
    from dorylus_tpu_torch.common.config import LayerConfig
    from dorylus_tpu_torch.common.logging import log

    t0 = time.perf_counter()
    layers = _layers(args.config, args.dataset)
    if args.data_dir:
        from dorylus_tpu_torch.graph.dataio import load_dataset
        g = load_dataset(args.data_dir, feature_dim=layers.feature_dim if layers else None)
    else:
        from dorylus_tpu_torch.graph.graph import synthetic_graph
        g = synthetic_graph(args.synth_vertices, args.synth_degree,
                            layers.feature_dim if layers else 32,
                            layers.num_classes if layers else 8, seed=8888)
    if layers is None:
        layers = LayerConfig([g.features.shape[1], 64, g.num_classes])
    log("dataset: %d vertices, %d edges, %d classes; layers %s; model %s",
        g.num_vertices, g.num_edges, g.num_classes, layers.dims, args.model)
    seconds = {"graph": time.perf_counter() - t0, "reorder": 0.0}
    order = None
    if args.reorder != "none":
        from dorylus_tpu_torch.graph import reorder
        t0 = time.perf_counter()
        order = (reorder.bfs_order(g) if args.reorder == "bfs"
                 else reorder.degree_order(g, ascending=args.reorder == "degree-asc"))
        g = reorder.apply_order(g, order)
        seconds["reorder"] = time.perf_counter() - t0
        log("reordered vertices (%s) in %.1f s", args.reorder, seconds["reorder"])
    t0 = time.perf_counter()
    parts = None
    if args.parts_file:
        from dorylus_tpu_torch.graph.dataio import read_parts_file
        parts = read_parts_file(args.parts_file)
        if order is not None:
            # the parts file names ORIGINAL vertex ids; the partition
            # indexes them by the new ones
            parts = parts[order]
    seconds["graph"] += time.perf_counter() - t0
    return g, layers, parts, seconds


def build_engine(args, graph=None, layers=None):
    """The single-device engine `train` runs (device: args.device; None
    means the card and raises without one, as `Engine` does)."""
    from dorylus_tpu_torch.engine.engine import Engine

    if graph is None:
        graph, layers, _, _ = load_graph(args)
    return Engine(graph, layers, make_config(args), device=args.device)


def _engine_sources() -> list:
    """The CUDA sources the engines' paths launch (ops/csrc/)."""
    from dorylus_tpu_torch.ops import hyb_sharded, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    return [hyb_spmm._CSRC, hyb_spmm._DYN_CSRC, spmm._CSRC, reuse_spmm._CSRC,
            hyb_sharded._CSRC, halo._CSRC]


def _log_stages(times: dict) -> None:
    from dorylus_tpu_torch.common.logging import log

    for k, v in times.items():
        log("stage %-18s %8.2f ms", k, v)


def _train_rank(rank: int, world: int, device, shard_dir: str, dims: list, cfg,
                output: Optional[str], profile: bool = False,
                notes: Optional[dict] = None) -> dict:
    """One rank of `train --shards n --feat-shards m`: the file of shard
    rank // m, the sharded engine, the run, the stage profile when asked
    (every rank times; rank 0 logs). Rank 0 writes the report file, its
    notes with the parent's `notes` and this rank's engine build seconds."""
    import torch

    from dorylus_tpu_torch.common.config import LayerConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    shard, meta = load_shard(Path(shard_dir) / f"shard_{rank // max(1, cfg.feat_shards)}.npz")
    t0 = time.perf_counter()
    eng = ShardedEngine((shard, meta), LayerConfig(list(dims)), cfg, device=device)
    if notes:
        eng.report.notes.update(notes)
        eng.report.notes["setup_s"] = dict(notes["setup_s"],
                                           engine=time.perf_counter() - t0)
    report = eng.run()
    times = eng.profile() if profile else None
    if rank == 0 and times:
        _log_stages(times)
    if rank == 0 and output:
        report.write(output)
    return {"summary": report.summary(), "kernel": report.notes.get("kernel"),
            "losses": [e.loss for e in report.epochs], "stages": times}


def _train_sharded(args, g, layers, cfg, parts, device: str, notes: dict) -> dict:
    import torch

    from dorylus_tpu_torch.common.logging import log
    from dorylus_tpu_torch.graph.partition import ShardMeta, partition_graph, save_shard
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    n, world = args.shards, args.shards * max(1, args.feat_shards)
    if torch.device(device).type == "cpu":
        backend, rank_device = "gloo", "cpu"
    elif device == "cuda" and torch.cuda.device_count() >= world:
        backend, rank_device = "nccl", "cuda:{rank}"
    else:
        backend, rank_device = "gloo", "cuda:0" if device == "cuda" else device
    if backend == "nccl" or rank_device.startswith("cuda"):
        # Every rank would build the same libraries: build them once here.
        from dorylus_tpu_torch.ops import cuda_build
        cuda_build.compile_sources(_engine_sources())
    t0 = time.perf_counter()
    sharded = partition_graph(g, n, method=args.partition, parts=parts,
                              for_gat=cfg.model == "gat")
    notes["setup_s"]["partition"] = time.perf_counter() - t0
    meta = ShardMeta.of(sharded)
    shard_dir = tempfile.mkdtemp(prefix="dorylus_shards_")
    try:
        for s in sharded.shards:
            save_shard(Path(shard_dir) / f"shard_{s.shard_id}.npz", s, meta)
        del sharded
        log("%d ranks (%d shards x %d feat shards) over %s on %s", world, n,
            args.feat_shards, backend, rank_device)
        res = spawn_local(world, _train_rank,
                          (shard_dir, layers.dims, cfg, args.output, args.profile, notes),
                          backend=backend, device=rank_device, timeout_s=_RANK_TIMEOUT_S)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    return res[0]


def cmd_train(args) -> int:
    from dorylus_tpu_torch.common.logging import log
    from dorylus_tpu_torch.models.base import check_divisible

    _log_ignored(args)
    device = _device(args)
    g, layers, parts, seconds = load_graph(args)
    notes = {"setup_s": dict(seconds),
             "graph": {"vertices": int(g.num_vertices), "edges": int(g.num_edges),
                       "layer_dims": list(layers.dims)}}
    try:  # the engine's refusal, here before any rank starts
        for d in layers.dims[:-1]:
            check_divisible(d, max(1, args.feat_shards), "layer")
    except ValueError as e:
        raise CliError(f"--feat-shards {args.feat_shards}: {e}") from None
    if args.shards > 1 or args.feat_shards > 1:
        res = _train_sharded(args, g, layers, make_config(args), parts, device, notes)
        log("aggregation kernel: %s", res["kernel"])
        print(res["summary"])
    else:
        t0 = time.perf_counter()
        eng = build_engine(args, g, layers)
        notes["setup_s"]["engine"] = time.perf_counter() - t0
        eng.report.notes.update(notes)
        report = eng.run()
        log("aggregation kernel: %s", report.notes.get("kernel"))
        if args.profile:
            _log_stages(eng.profile())
        print(report.summary())
        if args.output:
            report.write(args.output)
    if args.output:
        log("report written to %s", args.output)
    return 0


def cmd_infer(args) -> int:
    """Inference-only forward pass: load the latest checkpoint, dump
    per-vertex outputs (what tools/compare_output.py diffs)."""
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.common.logging import log
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.graph.dataio import load_dataset

    device = _device(args)
    layers = _layers(args.config)
    g = load_dataset(args.data_dir, feature_dim=layers.feature_dim)
    cfg = TrainConfig(model=args.model, kernel=args.kernel,
                      checkpoint_dir=args.checkpoint_dir, resume=True)
    eng = Engine(g, layers, cfg, device=device)
    if eng.start_epoch == 0:
        log("WARNING: no checkpoint found in %s — dumping predictions "
            "from the initial weights", args.checkpoint_dir)
    eng.dump_predictions(args.out, softmax=args.softmax)
    log("wrote %s (%d vertices)", args.out, g.num_vertices)
    return 0


def cmd_prepare(args) -> int:
    from dorylus_tpu_torch.graph.dataio import prepare_from_text

    g = prepare_from_text(args.edges, args.features, args.labels, args.out,
                          feature_dim=args.feature_dim, label_kinds=args.classes,
                          undirected=not args.directed)
    print(json.dumps({"vertices": g.num_vertices, "edges": g.num_edges,
                      "classes": g.num_classes, "out": args.out}))
    return 0


def cmd_partition(args) -> int:
    import numpy as np

    from dorylus_tpu_torch.graph.dataio import read_graph_bsnap, write_parts_file
    from dorylus_tpu_torch.graph.graph import Graph
    from dorylus_tpu_torch.graph.partition import assign_partitions

    src, dst, num_v = read_graph_bsnap(args.graph)
    g = Graph(num_vertices=num_v, src=src, dst=dst,
              features=np.zeros((num_v, 1), np.float32),
              labels=np.zeros(num_v, np.int32), num_classes=1).finalize()
    parts = assign_partitions(g, args.n, method=args.method)
    write_parts_file(args.out or (args.graph + ".parts"), parts)
    return 0


def cmd_bench(args) -> int:
    raise CliError("bench: the port's benchmark is not written yet (ROADMAP.md "
                   "queue 1 item 5); bench.py is the JAX package's")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="dorylus_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_train_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("prepare-data", help="text -> binary dataset dir")
    p.add_argument("--edges", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--feature-dim", type=int, required=True)
    p.add_argument("--classes", type=int, required=True)
    p.add_argument("--directed", action="store_true")
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("infer", help="forward pass from a checkpoint")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--config", required=True,
                   help="layer preset name or *.config path")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "xla", "degree", "hyb"])
    p.add_argument("--out", required=True, help="per-vertex output file")
    p.add_argument("--softmax", action="store_true",
                   help="write class probabilities instead of raw logits")
    _add_device_args(p)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("partition", help="write a parts file")
    p.add_argument("--graph", required=True, help="graph.bsnap path")
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--method", default="range", choices=["range", "hash", "ldg"])
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_partition)

    p = sub.add_parser("bench", help="the benchmark (not ported yet)")
    p.set_defaults(fn=cmd_bench)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"dorylus_tpu_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    # The package module's functions, so the ranks of a sharded run (fresh
    # interpreters) can import their target by name.
    from dorylus_tpu_torch.cli import main as _main

    sys.exit(_main())
