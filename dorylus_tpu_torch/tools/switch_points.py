"""The card's switch points, measured: kernel="auto"'s edge threshold
(`common/config.py` AUTO_KERNEL_EDGES), overlap="auto"'s plan per kernel
(`parallel/train_step.py` AUTO_OVERLAP) and the width DP's per-bucket cost
(`ops/hyb_plan.py` _LAMBDA_SLOTS).

    python -m dorylus_tpu_torch.tools.switch_points               # the card
    python -m dorylus_tpu_torch.tools.switch_points --device cpu  # a tiny size, for the tests

(a) Kernel points, on `bench.bench_graph(v, deg)` at Reddit's widths
    602-128-41 (KERNEL_POINTS): GCN and GAT on kernel="hyb" and "xla" at the
    defaults (f32 gather and compute, reuse="auto", whose gate is shut on the
    card), and hyb with bf16 gather beside them (xla ignores agg_dtype). Per
    engine: `setup_s`, its construction on the host clock after a
    synchronize; `first_epoch_s`, `run(1)`: the eager epoch, the capture of
    the epoch's CUDA graphs and the run's closing evaluation (both from REPS
    constructions); `warm_ms`, a replayed group of GROUP epochs without eval
    by CUDA events (REPS groups, as chip_smoke.py's `group_times`);
    `default_run_s` = setup + first epoch + 99 warm epochs (the medians), what
    a default `train` of 100 epochs holds beyond loading the graph.
(b) Overlap points, on the Reddit-shaped graph's range partition into 4 and 2
    shards, gloo ranks on the one card: hyb (fused against combined), degree
    (pair against combined) and xla (split against combined), GCN and GAT,
    f32: the device's kernel ms per rank and step (torch.profiler's CUDA rows,
    the staging copies left out, as chip_smoke.py's `profile_rank`; REPS
    windows of 2 steps, each the max over ranks), and the host's wall ms of
    a step (gloo's on one card: recorded, it decides nothing). Timed after
    (a) and (c): a profiler session slows every later launch of its process.
(c) λ points (LAMBDAS): K1 bf16 and f32 at F=128 and 41 on the Reddit graph,
    K1 and K2 bf16 at F=64 on the largest kernel point's graph, K1 bf16 at
    F=128 on chip_smoke.py's power-law graph with hubs: each pass held
    against its plain version, then its ms (`bench.time_ms`, REPS means of
    10 calls), the plan's buckets, parts, launches a pass and build seconds.

`decide` applies each constant's rule to the readings (see
`decide_kernel`, `decide_overlap`, `decide_lambda`). Prints one JSON line
with every reading, the decisions and the card's name and power limit; the
ranks' shard files live in a temporary directory removed after. On the CPU
(`--device cpu`, the tests) every time is the host's, and (b)'s kernel ms
are the profiled ops' self CPU time: no number of a CPU run is the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from dorylus_tpu_torch import bench
from dorylus_tpu_torch.common.config import AUTO_KERNEL_EDGES, LayerConfig, TrainConfig
from dorylus_tpu_torch.common.device import resolve_device
from dorylus_tpu_torch.common.logging import log
from dorylus_tpu_torch.engine.engine import Engine
from dorylus_tpu_torch.graph.graph import Graph
from dorylus_tpu_torch.graph.partition import ShardMeta, load_shard, partition_graph, save_shard
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.gather_parts import MAX_PARTS
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan
from dorylus_tpu_torch.ops.hyb_spmm import (_upload, hyb_mask_pass, hyb_mask_pass_plain,
                                            hyb_static_pass, hyb_static_pass_plain)
from dorylus_tpu_torch.parallel.train_step import AUTO_OVERLAP

# (vertices, mean in-degree): 0.47M, 2.0M, ~4M, ~7.9M, 11.6M (Reddit) and
# ~27M edges (Amazon's SCALE 0.12 size at Reddit's widths)
KERNEL_POINTS = {"cuda": ((23_296, 20), (100_000, 20), (232_965, 17), (232_965, 34),
                          (232_965, 50), (1_131_610, 24)),
                 "cpu": ((300, 6), (600, 10))}
OVERLAP_GRAPH = {"cuda": (232_965, 50), "cpu": (600, 10)}
POWERLAW_V = {"cuda": 20_000, "cpu": 500}
LAMBDAS = (0, 1 << 12, 1 << 15, 1 << 17, 1 << 19, 1 << 21)
PARTITIONS = (4, 2)
REPS = 3
GROUP = 10
ITERS = 10
MODELS = (("gcn", 0.01), ("gat", 0.005))
# kernel="auto"'s engines: (kernel, agg_dtype, key)
ENGINES = (("hyb", "float32", "hyb"), ("xla", "float32", "xla"),
           ("hyb", "bfloat16", "hyb_bf16"))
# overlap="auto"'s plans: the plan overlap=True runs, per kernel
OVERLAP_PLANS = {"hyb": "fused", "degree": "pair", "xla": "split"}
# JAX's values, where each rule starts (dorylus_tpu/common/config.py, its
# ShardedEngine's overlap="auto" off a TPU, dorylus_tpu/ops/hyb_spmm.py)
JAX_KERNEL_EDGES = 1 << 23
JAX_OVERLAP = {"hyb": True, "degree": True, "xla": False}
JAX_LAMBDA = 512 * 1024


def powerlaw_edges(v: int, seed: int, empty: float = 0.0):
    """dst-sorted edges with Zipf in-degrees (capped at 2,000; many above
    max_width=8) and uniform sources; vertex ids are not degree-sorted (inv
    layout). `empty`: the share of vertices given no in-edge."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, v), 2000)
    if empty:
        deg[rng.random(v) < empty] = 0
    dst = np.repeat(rng.permutation(v).astype(np.int32), deg)
    dst = np.sort(dst)
    src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    val = rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    return src, dst, val


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def spread(xs) -> dict:
    """The median of readings, their spread (max - min) and the readings."""
    xs = [float(x) for x in xs]
    return {"median": float(np.median(xs)), "spread": max(xs) - min(xs), "runs": xs}


# ---- (a) kernel points ----

def warm_ms(eng, lr: float) -> list:
    """ms per epoch of REPS groups of GROUP epochs without eval, after the
    engine's run: replayed through the run's CUDA graphs and timed by CUDA
    events around the group's dispatch on the card; eager on the host's
    clock to its read on the CPU."""
    k = GROUP
    flags = np.zeros(k, bool)
    out = []
    for _ in range(REPS):
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eng._dispatch([lr] * k, flags, None)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / k)
        else:
            t0 = time.perf_counter()
            eng._dispatch([lr] * k, flags, None)[0].tolist()
            out.append(1e3 * (time.perf_counter() - t0) / k)
    return out


def default_run_s(times: dict) -> float:
    """A default train of 100 epochs beyond loading the graph: set-up, the
    first epoch and 99 warm epochs (the medians)."""
    return (times["setup_s"]["median"] + times["first_epoch_s"]["median"]
            + 99 * times["warm_ms"]["median"] / 1e3)


def engine_times(g: Graph, cfg: TrainConfig, device: torch.device,
                 reps: int = REPS) -> dict:
    """setup_s and first_epoch_s over `reps` constructions of the engine,
    then warm_ms on the last one, and default_run_s from the medians."""
    setup, first = [], []
    for rep in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        eng = Engine(g, LayerConfig(bench.LAYERS), cfg, device=device)
        _sync(device)
        setup.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng.run(1)
        first.append(time.perf_counter() - t0)
        if rep < reps - 1:
            del eng
            _free(device)
    warm = warm_ms(eng, cfg.learning_rate)
    out = {"kernel_selected": eng.kernel_selected, "setup_s": spread(setup),
           "first_epoch_s": spread(first), "warm_ms": spread(warm)}
    out["default_run_s"] = default_run_s(out)
    del eng
    _free(device)
    return out


def kernel_point(g: Graph, device: torch.device) -> dict:
    """Every engine of (a) on one graph: {model: {engine key: times}}."""
    out = {"vertices": g.num_vertices, "edges": g.num_edges}
    for model, lr in MODELS:
        for kernel, agg, key in ENGINES:
            cfg = TrainConfig(model=model, kernel=kernel, agg_dtype=agg, learning_rate=lr,
                              epochs=1, eval_every=0)
            out.setdefault(model, {})[key] = engine_times(g, cfg, device)
            log("switch_points %s E=%d %s %s: %s", model, g.num_edges, key,
                out[model][key]["kernel_selected"],
                json.dumps({k: v["median"] for k, v in out[model][key].items()
                            if isinstance(v, dict)}))
    return out


# ---- (c) λ points ----

def _plan(src, dst, num_out: int, val, lam: int, dtypes, device: torch.device) -> tuple:
    """The forward plan at lam, uploaded once per values dtype; its stats
    and build seconds (the host's DP and fill, then the upload)."""
    _sync(device)
    t0 = time.perf_counter()
    host = build_hyb_plan(src, dst, None, num_out, 512, lam, val)
    n_src = int(src.max()) + 1
    plans = {dt: _upload(host, n_src, dt, device) for dt in dtypes}
    _sync(device)
    build_s = time.perf_counter() - t0
    some = next(iter(plans.values()))
    parts = len(some["parts"].parts)
    buckets = [p["rows"].shape[1] for p in some["buckets"]]
    stats = {"lam_slots": lam, "build_s": build_s, "buckets": len(buckets), "widths": buckets,
             "top_rows": 0 if some["top"] is None else int(some["top"]["rows"].shape[0]),
             "parts": parts, "launches_per_pass": -(-parts // MAX_PARTS),
             "slots": sum(p["rows"].numel() for p in some["parts"].parts)}
    return plans, stats


def _pass_ms(label: str, mode: str, h: torch.Tensor, plan: dict, num_out: int,
             gather_dtype, device: torch.device) -> tuple:
    """One pass held against its plain version (bench.check_close), then
    REPS means of ITERS calls; (the times, the checked output)."""
    run, plain = ((hyb_static_pass, hyb_static_pass_plain) if mode == "static"
                  else (hyb_mask_pass, hyb_mask_pass_plain))
    got = run(h, plan, num_out, gather_dtype)
    bench.check_close(label, got, plain(h, plan, num_out, gather_dtype),
                      gather_dtype or torch.float32)
    return spread(bench.time_ms(lambda: run(h, plan, num_out, gather_dtype), ITERS, device)
                  for _ in range(REPS)), got


def lambda_points(cases: list, device: torch.device) -> dict:
    """cases: (name, src, dst, num_out, val, passes) with passes a list of
    (pass label, mode, F, gather dtype); for each λ (JAX's first) and case
    the plan's stats and each pass's ms, and whether its output equals JAX's
    λ's bit for bit (a λ moves rows between buckets; each row keeps its slot
    order). Returns {case: {pass label: {λ: ms, "bit_equal",
    "max_abs_diff"}}, case + " plan": {λ: stats}}."""
    out = {}
    lams = sorted(LAMBDAS, key=lambda lam: lam != JAX_LAMBDA)
    for name, src, dst, num_out, val, passes in cases:
        rng = np.random.default_rng(0)
        widths = sorted({f for _, _, f, _ in passes})
        hs = {f: torch.tensor(rng.normal(0, 1, size=(int(src.max()) + 1, f))
                              .astype(np.float32), device=device) for f in widths}
        dtypes = sorted({torch.bfloat16 if gd is not None else torch.float32
                         for _, _, _, gd in passes}, key=str)
        ref = {}
        for lam in lams:
            plans, stats = _plan(src, dst, num_out, val, lam, dtypes, device)
            out.setdefault(f"{name} plan", {})[str(lam)] = stats
            for label, mode, f, gd in passes:
                plan = plans[torch.bfloat16 if gd is not None else torch.float32]
                ms, got = _pass_ms(f"{name} {label} lam {lam}", mode, hs[f], plan, num_out,
                                   gd, device)
                want = ref.setdefault(label, got)
                out.setdefault(name, {}).setdefault(label, {})[str(lam)] = dict(
                    ms, bit_equal=bool(torch.equal(got, want)),
                    max_abs_diff=float((got - want).abs().max()) if got.numel() else 0.0)
            log("switch_points lambda %d %s: %s", lam, name, json.dumps(
                {lb: out[name][lb][str(lam)]["median"] for lb, *_ in passes}))
            del plans
            _free(device)
    return out


# ---- (b) overlap points ----

def _device_ms(prof, on_card: bool) -> float:
    """The profiled ops' time: on the card the CUDA rows' device time, the
    staging copies (Memcpy, Memset) left out; on the CPU the ops' self CPU
    time."""
    kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != kind or (on_card and e.key.startswith(("Memcpy", "Memset"))):
            continue
        total += e.self_device_time_total if on_card else e.self_cpu_time_total
    return total / 1e3


def overlap_rank(rank: int, world: int, device, shard_dir: str, runs: list) -> list:
    """One rank of (b) (started by multihost.spawn_local): for each run
    (model, kernel, overlap), a ShardedEngine on this rank's shard, 2 epochs
    to warm up, the host's ms of 2 steps, then REPS profiled windows of 2
    steps: this rank's kernel ms per step in each."""
    from torch.profiler import ProfilerActivity, profile

    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    shard, meta = load_shard(f"{shard_dir}/{rank}.npz")
    out = []
    for model, kernel, overlap in runs:
        lr = dict(MODELS)[model]
        s = shard
        if model == "gat":
            # a GAT partition differs from the GCN one in its edge values
            # alone: 1 on every real edge (the edgewise path's edge mask)
            s = dataclasses.replace(shard, edge_val=np.ones_like(shard.edge_val))
        cfg = TrainConfig(model=model, kernel=kernel, overlap=overlap, learning_rate=lr,
                          epochs=2, eval_every=0, reuse="off")
        eng = ShardedEngine((s, meta), LayerConfig(bench.LAYERS), cfg, device=dev)
        eng.run()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(2):
            eng._train_epoch(lr)
        _sync(dev)
        row = {"wall_ms_per_step": 1e3 * (time.perf_counter() - t0) / 2, "kernel_ms": [],
               "kernel": eng.kernel_selected, "overlap": bool(eng.cfg.overlap)}
        for _ in range(REPS):
            with profile(activities=activities) as prof:
                for _ in range(2):
                    eng._train_epoch(lr)
                _sync(dev)
            row["kernel_ms"].append(_device_ms(prof, on_card) / 2)
        out.append(row)
        del eng
        _free(dev)
    return out


def overlap_points(g: Graph, device: torch.device) -> dict:
    """(b) on g's range partitions: {"n ranks": {model: {kernel: {plan:
    {"kernel_ms": spread of the max over ranks, "wall_ms": the max over
    ranks of the host's ms a step}}}}}."""
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    on_card = device.type == "cuda"
    runs = [(model, kernel, overlap) for model, _ in MODELS for kernel in OVERLAP_PLANS
            for overlap in (True, False)]
    out = {}
    shard_dir = tempfile.mkdtemp(prefix="dorylus_switch_points_")
    try:
        for n in PARTITIONS:
            sg = partition_graph(g, n)
            for s in sg.shards:
                save_shard(f"{shard_dir}/{s.shard_id}.npz", s, ShardMeta.of(sg))
            t0 = time.perf_counter()
            res = spawn_local(n, overlap_rank, (shard_dir, runs), backend="gloo",
                              device="cuda:0" if on_card else "cpu", timeout_s=1200)
            log("switch_points overlap: %d ranks, %d runs in %.1f s", n, len(runs),
                time.perf_counter() - t0)
            part = out[f"{n} ranks"] = {"edges_per_shard": [s.num_edges for s in sg.shards]}
            for i, (model, kernel, overlap) in enumerate(runs):
                rows = [res[r][i] for r in range(n)]
                plan = OVERLAP_PLANS[kernel] if overlap else "combined"
                if any(r["overlap"] != overlap or r["kernel"] != kernel for r in rows):
                    raise AssertionError(f"overlap point {model} {kernel} {plan}: ran "
                                         f"{rows[0]['kernel']} overlap {rows[0]['overlap']}")
                part.setdefault(model, {}).setdefault(kernel, {})[plan] = {
                    "kernel_ms": spread(max(r["kernel_ms"][w] for r in rows)
                                        for w in range(REPS)),
                    "wall_ms": max(r["wall_ms_per_step"] for r in rows)}
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    return out


# ---- the rules ----

def _beats(a: dict, b: dict) -> bool:
    """a's median below b's by more than the larger of their spreads."""
    return b["median"] - a["median"] > max(a["spread"], b["spread"])


def decide_kernel(points: list, start: int = JAX_KERNEL_EDGES) -> dict:
    """AUTO_KERNEL_EDGES' rule. c: the smallest swept edge count at and
    above which hyb's warm_ms beats xla's (by more than the spread), for
    both models, at every larger point. If hyb is slower per epoch (by more
    than the spread, either model) at a swept point above `start`, the
    threshold moves up to c; else, if at some swept point below `start`
    hyb wins per epoch and its default_run_s is lower (both models), it
    moves down to the smallest such point; otherwise it stays. start:
    JAX's threshold."""
    pts = sorted(points, key=lambda p: p["edges"])

    def wins(p):
        return all(_beats(p[m]["hyb"]["warm_ms"], p[m]["xla"]["warm_ms"]) for m, _ in MODELS)

    def slower(p):
        return any(_beats(p[m]["xla"]["warm_ms"], p[m]["hyb"]["warm_ms"]) for m, _ in MODELS)

    def cheaper_run(p):
        return all(p[m]["hyb"]["default_run_s"] < p[m]["xla"]["default_run_s"]
                   for m, _ in MODELS)

    c = None
    for p in reversed(pts):
        if not wins(p):
            break
        c = p["edges"]
    per_point = [{"edges": p["edges"], "hyb_wins_warm": wins(p), "hyb_slower_warm": slower(p),
                  "hyb_default_run_lower": cheaper_run(p)} for p in pts]
    if any(slower(p) for p in pts if p["edges"] > start):
        threshold, why = (c if c is not None else pts[-1]["edges"]), "up"
    else:
        down = [p["edges"] for p in pts
                if p["edges"] < start and wins(p) and cheaper_run(p)]
        threshold, why = (min(down), "down") if down else (start, "kept")
    return {"threshold": threshold, "move": why, "c": c, "points": per_point}


def decide_overlap(parts: dict, start: dict = JAX_OVERLAP) -> dict:
    """overlap="auto"'s rule, per kernel: the plan with the lower device ms
    per rank, by more than the spread, for both models at every partition;
    otherwise (a tie) `start`'s, JAX's off-TPU choice."""
    out = {}
    for kernel, plan in OVERLAP_PLANS.items():
        pairs = [(p[m][kernel][plan]["kernel_ms"], p[m][kernel]["combined"]["kernel_ms"])
                 for p in parts.values() for m, _ in MODELS]
        if all(_beats(a, b) for a, b in pairs):
            out[kernel] = True
        elif all(_beats(b, a) for a, b in pairs):
            out[kernel] = False
        else:
            out[kernel] = start[kernel]
    return out


def decide_lambda(lam_res: dict, start: int = JAX_LAMBDA) -> dict:
    """_LAMBDA_SLOTS' rule: a λ is taken only if it makes the headline pass
    (Reddit's K1 bf16 F=128) faster than at `start` (JAX's λ) by more than
    the spread, and no other swept pass slower by more than its own; of
    those, the fastest headline."""
    passes = [(case, label) for case, v in lam_res.items() if not case.endswith(" plan")
              for label in v]
    hl = lam_res["reddit"]["K1 bf16 F=128"]
    cur = str(start)
    ok = []
    for lam in LAMBDAS:
        key = str(lam)
        if key == cur:
            continue
        if not _beats(hl[key], hl[cur]):
            continue
        if any(_beats(lam_res[c][lb][cur], lam_res[c][lb][key]) for c, lb in passes):
            continue
        ok.append((hl[key]["median"], lam))
    return {"lam_slots": min(ok)[1] if ok else start, "candidates": [lam for _, lam in ok]}


def pool(records: list) -> dict:
    """Records of several runs of the tool as one: each reading's runs
    joined, its median and spread taken over all of them (the spread a rule
    then compares is the one between runs too), default_run_s again from
    the pooled medians; every other value is the first record's."""
    def merge(xs):
        if isinstance(xs[0], dict) and "runs" in xs[0]:
            return dict(xs[0], **spread(r for x in xs for r in x["runs"]))
        if isinstance(xs[0], dict):
            return {k: merge([x[k] for x in xs]) for k in xs[0]}
        if isinstance(xs[0], list):
            return [merge(list(t)) for t in zip(*xs)]
        return xs[0]

    out = merge(records)
    for p in out["kernel_points"]:
        for m, _ in MODELS:
            for _, _, key in ENGINES:
                p[m][key]["default_run_s"] = default_run_s(p[m][key])
    return out


def decide(rec: dict) -> dict:
    return {"AUTO_KERNEL_EDGES": decide_kernel(rec["kernel_points"]),
            "AUTO_OVERLAP": decide_overlap(rec["overlap_points"]),
            "_LAMBDA_SLOTS": decide_lambda(rec["lambda_points"])}


# ---- the sweep ----

def build_kernels() -> None:
    """Every library the sweep launches, built at once before anything is
    timed (a first call would build it inside a timing)."""
    from dorylus_tpu_torch.ops import hyb_sharded, hyb_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    cuda_build.compile_sources([hyb_spmm._CSRC, hyb_spmm._DYN_CSRC, spmm._CSRC,
                                hyb_sharded._CSRC, halo._CSRC])
    for build in (hyb_spmm.build_kernel, hyb_spmm.build_dyn_kernel, spmm.build_kernel,
                  hyb_sharded.build_kernel, halo.build_kernel):
        build()


def main(device: str | torch.device | None = None) -> dict:
    """The three sweeps and their decisions as one JSON line; returns the
    record. device None means the card (raises without one); "cpu" runs a
    tiny size."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    scale = "cuda" if on_card else "cpu"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        build_kernels()
    t_start = time.perf_counter()
    rec = {"platform": "gpu" if on_card else "cpu",
           "device": bench.card_name() if on_card else "cpu",
           "current": {"AUTO_KERNEL_EDGES": AUTO_KERNEL_EDGES, "AUTO_OVERLAP": AUTO_OVERLAP,
                       "_LAMBDA_SLOTS": _LAMBDA_SLOTS},
           "kernel_points": []}
    graphs = {}
    for v, deg in KERNEL_POINTS[scale]:
        t0 = time.perf_counter()
        g = bench.bench_graph(v, deg)
        log("switch_points graph V=%d E=%d (%.1f s)", v, g.num_edges, time.perf_counter() - t0)
        rec["kernel_points"].append(dict(kernel_point(g, dev), graph_s=time.perf_counter() - t0))
        if (v, deg) in (OVERLAP_GRAPH[scale], KERNEL_POINTS[scale][-1]):
            graphs[(v, deg)] = g
        del g
    red, big = graphs[OVERLAP_GRAPH[scale]], graphs[KERNEL_POINTS[scale][-1]]
    bf16 = torch.bfloat16
    psrc, pdst, pval = powerlaw_edges(POWERLAW_V[scale], seed=7)
    cases = [("reddit", red.src, red.dst, red.num_vertices, red.edge_norm,
              [(f"K1 {name} F={f}", "static", f, gd)
               for f in (128, 41) for name, gd in (("bf16", bf16), ("f32", None))]),
             ("largest", big.src, big.dst, big.num_vertices, big.edge_norm,
              [("K1 bf16 F=64", "static", 64, bf16), ("K2 bf16 F=64", "mask", 64, bf16)]),
             ("powerlaw", psrc, pdst, POWERLAW_V[scale], pval,
              [("K1 bf16 F=128", "static", 128, bf16)])]
    del big, graphs
    rec["lambda_points"] = lambda_points(cases, dev)
    del cases
    _free(dev)
    rec["overlap_points"] = overlap_points(red, dev)
    rec["decisions"] = decide(rec)
    rec["seconds"] = time.perf_counter() - t_start
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="switch_points")
    ap.add_argument("--device", default=None, help="the card by default, or cpu")
    main(ap.parse_args().device)
