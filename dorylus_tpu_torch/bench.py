"""The port's benchmark: the counterpart of the repo's bench.py, cell for
cell under the same keys, on the card.

    python -m dorylus_tpu_torch.cli bench            # the card; exit 2 without one
    python -c "from dorylus_tpu_torch import bench; bench.main('cpu')"   # test scale

Headline: edges/s of the aggregation SpMM at the hidden width (F=128) on
the Reddit-shaped graph of bench.py (`build_graph(232_965, 50, 602, 41,
seed=1)`, renumbered by ascending degree): K1's static pass with the GCN
norms baked into the plan and bf16 gather tables, on
`HybSpMM(static_val=edge_norm)`. Each pass timed is the entry the engine
calls (the table's cast, the zeroed output, the launch), by CUDA events
around `iters` warm calls after one warm-up call: 10 on the card, 3 on the
CPU; the headline is the median of 3 such means. Before it is timed, each
op's output is held once against its plain version on the same inputs (f32
1e-4 x max|ref|, bf16 1e-2; the pair table and P3 bit for bit): a mismatch
raises.

The cells (extras), each with the kernel it runs:
  spmm_ms, the headline            K1, static bf16, F=128
  spmm_dynamic_vals_ms             K7 forward, `op.apply(h, val)`
  spmm_f32_ms                      K1 in f32
  spmm_degree_kernel_ms            K1 over DegreeSpMM(block=16)'s plan
  edgewise_spmm_ms                 K3 forward on EdgeSpMM, f32
  gather_bound_edges_per_s         P3 (tools/probe_prims.py `row_copy`) over
                                   the plan's live slot rows of the bf16
                                   table, laid out as P3's streams: a pure
                                   gather of the rows K1 gathers
  fraction_of_gather_bound         headline / gather bound
  cpu_scipy_edges_per_s            scipy CSR on the host (vs_baseline)
  torch_sparse_mm_edges_per_s      torch.sparse.mm, f32 CSR, on the card
  {gcn,gat}_reddit_config_epoch{,_bf16}_ms
                                   `epoch_ms_warm`: one Engine, run(3) twice,
                                   the mean of the second run's epochs; on the
                                   card the first run() captures the epoch as
                                   CUDA graphs after one eager epoch and the
                                   engine keeps them (engine/graphs.py), so the
                                   second run's epochs are three replays
                                   (`epoch_timing`)
  reuse_largev_*, reuse_row_cut, reuse_mine_s
                                   on the card only: `community_core_edges(
                                   1_600_000, 15, comm=400, core=60,
                                   p_core=0.85, seed=0)`; K2's mask pass over
                                   the plain plan against K6 + K2 over
                                   `mine_reuse(min_uses=3, passes=2)`'s
                                   rewrite; `reuse_miner` names the miner
  reuse_reddit_community_*         on the card only: GCN warm epochs, reuse
                                   "off" and "pairs", on the Reddit-size
                                   community graph; `_mine_s` is the pairs
                                   engine's ReuseSpMM build (both directions,
                                   both plans)
  platform, device                 "gpu" or "cpu"; nvidia-smi's name and
                                   power limit

`main(device=None)` runs on the card and raises without one; `main("cpu")`
runs bench.py's CPU scale (V 23,296, degree 20, 3 iterations, no reuse
cells), which only the tests use. It prints one JSON line in bench.py's
shape and writes no file. The cells are functions of a prebuilt graph, op
or engine, so chip_smoke.py times them on what it has built.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from dorylus_tpu_torch import native
from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.common.device import resolve_device
from dorylus_tpu_torch.engine.engine import Engine
from dorylus_tpu_torch.graph.graph import Graph, build_graph, community_core_edges
from dorylus_tpu_torch.graph.reorder import apply_order, degree_order
from dorylus_tpu_torch.graph.reuse import mine_reuse
from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM, degree_pass, degree_pass_plain
from dorylus_tpu_torch.ops.hyb_plan import build_hyb_plan
from dorylus_tpu_torch.ops.hyb_spmm import (HybSpMM, _upload, hyb_dynamic_pass_plain,
                                            hyb_mask_pass, hyb_mask_pass_plain,
                                            hyb_static_pass, hyb_static_pass_plain)
from dorylus_tpu_torch.ops.reuse_spmm import build_pair_table, build_pair_table_plain
from dorylus_tpu_torch.ops.spmm import EdgeSpMM, csr_spmm, csr_spmm_plain
from dorylus_tpu_torch.tools import probe_prims

# bench.py's scales: the card's (Reddit |V|, its mean degree) and the CPU's
SCALES = {"cuda": dict(v=232_965, deg=50, iters=10), "cpu": dict(v=23_296, deg=20, iters=3)}
FEAT, CLASSES, F_HID = 602, 41, 128
LAYERS = [FEAT, 128, CLASSES]  # run/reddit.config
# bench.py's pair-reuse cell past the L2 (its bf16 table is 410 MB)
LARGEV = dict(v=1_600_000, deg=15, comm=400, core=60, p_core=0.85, seed=0)
# the community-core shape of bench.py's Reddit-size reuse cell (at the card
# scale's V and degree)
COMMUNITY = dict(comm=400, core=60, p_core=0.85, seed=0)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# bench.py's keys (tests/test_torch_port_bench.py holds these against its
# AST): its printed object's extras, and those of its reuse cells (the card's)
BENCH_PY_EXTRAS = (
    "platform", "num_vertices", "num_edges", "feature_dim", "kernel", "spmm_ms",
    "spmm_dynamic_vals_ms", "spmm_f32_ms", "spmm_f32_edges_per_s", "spmm_degree_kernel_ms",
    "spmm_degree_kernel_edges_per_s", "fraction_of_gather_bound", "gather_bound_edges_per_s",
    "edgewise_spmm_ms", "edgewise_edges_per_s", "cpu_scipy_edges_per_s",
    "gcn_reddit_config_epoch_ms", "gcn_reddit_config_epoch_bf16_ms",
    "gat_reddit_config_epoch_ms", "gat_reddit_config_epoch_bf16_ms")
BENCH_PY_REUSE = (
    "reuse_largev_V", "reuse_largev_E", "reuse_largev_plain_edges_per_s",
    "reuse_largev_edges_per_s", "reuse_largev_speedup", "reuse_row_cut", "reuse_mine_s",
    "reuse_reddit_community_epoch_off_ms", "reuse_reddit_community_epoch_ms",
    "reuse_reddit_community_speedup")
EPOCH_TIMING = ("Engine.run(3) twice, the mean of the second run's 3 epochs; on the card "
                "the first run() runs one eager epoch and captures the epoch as CUDA graphs, "
                "which the engine keeps: the second run's 3 epochs are replays")


def bench_graph(v: int, deg: int, seed: int = 1) -> Graph:
    """bench.py's graph: `build_graph` renumbered by ascending degree, so
    the hyb plan's bucket layout is the identity permutation."""
    g = build_graph(v, deg, FEAT, CLASSES, seed=seed)
    return apply_order(g, degree_order(g, ascending=True))


def community_graph(v: int, deg: int, feat: int = FEAT, classes: int = CLASSES,
                    **kw) -> Graph:
    """bench.py's community-core graph (`community_core_edges`) with
    random features and block labels."""
    src, dst = community_core_edges(v, deg, **kw)
    rng = np.random.default_rng(4)
    return Graph(num_vertices=v, src=src, dst=dst,
                 features=rng.normal(0, 0.3, size=(v, feat)).astype(np.float32),
                 labels=((np.arange(v) * classes) // v).astype(np.int32),
                 num_classes=classes).finalize()


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms per call of fn over `iters` calls after one warm-up call: CUDA
    events on the card, the host's clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                dtype: torch.dtype | None) -> float:
    """Max abs error of got against ref; raises where it exceeds TOL[dtype]
    x max|ref| (dtype None: bit for bit) or got is not finite."""
    err = float((got.float() - ref.float()).abs().max()) if got.numel() else 0.0
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and (
        torch.equal(got, ref) if dtype is None else err <= TOL[dtype] * scale)
    if not ok:
        raise AssertionError(f"bench {name}: max abs err {err:.3e} against the plain "
                             f"version (max|ref| {scale:.3e})")
    return err


def checked_ms(name: str, fn, plain, dtype, iters: int, device: torch.device,
               reps: int = 1) -> float:
    """fn's output held once against plain()'s, then the median over reps of
    fn's mean ms over iters calls."""
    check_close(name, fn(), plain(), dtype)
    return sorted(time_ms(fn, iters, device) for _ in range(reps))[reps // 2]


def live_rows(plan: dict) -> torch.Tensor:
    """The source row of every live slot of a hyb plan (buckets, then the
    hub top): the rows one pass gathers, int32."""
    parts = list(plan["buckets"]) + ([plan["top"]] if plan["top"] is not None else [])
    out = []
    for p in parts:
        w = p["rows"].shape[1]
        live = torch.arange(w, device=p["rows"].device)[None, :] < p["cnt"][:, None]
        out.append(p["rows"][live])
    return torch.cat(out).int()


def gather_streams(rows: torch.Tensor, streams: int) -> torch.Tensor:
    """rows laid out as P3's (streams, n) index rows, n >= its ring's depth;
    the last row is filled up from the first rows."""
    n = max(probe_prims.DEPTH, math.ceil(rows.numel() / streams))
    wrap = torch.arange(streams * n, device=rows.device) % rows.numel()
    return rows[wrap].view(streams, n).contiguous()


def gather_bound(op: HybSpMM, h: torch.Tensor, iters: int) -> dict:
    """The pure gather of the rows K1 gathers at its table dtype (bf16: a
    256-byte row of F=128 is a (rows, 64) f32 table to P3): on the card P3
    over P3's streams of 256-byte rows (half a warp a stream), held bit for
    bit against its plain version first; on the CPU `index_select` of the
    same rows. Rows per second and ms, the table's cast included, as K1's
    pass includes it."""
    dev = h.device
    rows = live_rows(op.fwd)
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        idx = gather_streams(rows, sms * 3 * probe_prims.WARPS * 2)
        tab = h.to(torch.bfloat16).view(torch.float32)
        check_close("P3 gather", probe_prims.row_copy(tab, idx),
                    probe_prims.row_copy_plain(tab, idx), None)
        out = torch.empty((idx.shape[0], probe_prims.DEPTH, tab.shape[1]), device=dev)

        def gather():
            probe_prims._launch_row_copy(h.to(torch.bfloat16).view(torch.float32), idx, out)
    else:
        idx = rows.long()

        def gather():
            return torch.index_select(h.to(torch.bfloat16), 0, idx)
    ms = time_ms(gather, iters, dev)
    return {"ms": ms, "rows": idx.numel(), "rows_per_s": idx.numel() / (ms * 1e-3)}


def spmm_cells(g: Graph, ops: dict, iters: int, device: torch.device,
               reps: int = 3) -> dict:
    """The pass cells on bench.py's graph. ops: "bf16" (HybSpMM bf16 with
    static values and dynamic=True), "f32" (HybSpMM f32, static values),
    "degree" (DegreeSpMM(block=16), bf16, static values), "edge"
    (EdgeSpMM). Returns ms per cell, the gather bound and the library's
    ms."""
    v = g.num_vertices
    bf16 = torch.bfloat16
    h = torch.tensor(np.random.default_rng(0).normal(0, 1, size=(v, F_HID)).astype(np.float32),
                     device=device)
    val = torch.tensor(g.edge_norm, device=device)
    op, op32, dop, eop = ops["bf16"], ops["f32"], ops["degree"], ops["edge"]
    src = torch.tensor(g.src, dtype=torch.int32, device=device)
    out = {"spmm_ms": checked_ms(
        "K1 bf16", lambda: hyb_static_pass(h, op.fwd, v, bf16),
        lambda: hyb_static_pass_plain(h, op.fwd, v, bf16), bf16, iters, device, reps)}
    with torch.no_grad():
        out["spmm_dynamic_vals_ms"] = checked_ms(
            "K7 forward", lambda: op.apply(h, val),
            lambda: hyb_dynamic_pass_plain(h, op.fwd, v, val, bf16), bf16, iters, device)
    out["gather"] = gather_bound(op, h, iters)
    out["spmm_f32_ms"] = checked_ms(
        "K1 f32", lambda: hyb_static_pass(h, op32.fwd, v, None),
        lambda: hyb_static_pass_plain(h, op32.fwd, v, None), torch.float32, iters, device)
    out["spmm_degree_kernel_ms"] = checked_ms(
        "degree bf16", lambda: degree_pass(h, dop.fwd, v, bf16, "static"),
        lambda: degree_pass_plain(h, dop.fwd, v, bf16, "static"), bf16, iters, device)
    out["edgewise_spmm_ms"] = checked_ms(
        "K3 forward f32", lambda: csr_spmm(h, eop.row_ptr, src, val),
        lambda: csr_spmm_plain(h, eop.row_ptr, src, val), torch.float32, iters, device)
    # the library call of the headline's function: torch.sparse.mm of the
    # f32 CSR matrix (the norms) with h
    a = torch.sparse_csr_tensor(eop.row_ptr, src, val, size=(v, v))
    out["torch_sparse_mm_ms"] = checked_ms(
        "torch.sparse.mm f32", lambda: torch.sparse.mm(a, h),
        lambda: hyb_static_pass_plain(h, op32.fwd, v, None), torch.float32, iters, device)
    return out


def cpu_spmm_baseline(g: Graph, h: np.ndarray, iters: int = 3) -> float:
    """scipy CSR SpMM on the host: the reference CPU backend's aggregation
    (bench.py `cpu_spmm_baseline`); edges/s."""
    import scipy.sparse as sp

    a = sp.csr_matrix((g.edge_norm, (g.dst, g.src)), shape=(g.num_vertices, g.num_vertices))
    a @ h  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        a @ h
    return g.num_edges / ((time.perf_counter() - t0) / iters)


def epoch_ms_warm(eng, epochs: int = 3) -> float:
    """bench.py's `epoch_ms_warm` on a built engine: run(epochs) twice, the
    mean of the second run's epochs (see EPOCH_TIMING)."""
    eng.run(epochs)
    rep = eng.run(epochs)
    return float(np.mean([e.time_ms for e in rep.epochs[-epochs:]]))


def epoch_config(model: str, agg_dtype: str = "float32", reuse: str = "off") -> TrainConfig:
    """bench.py's epoch cells: 3 epochs without eval on hyb (what `auto`
    resolves to at Reddit scale), GAT at lr 0.005."""
    return TrainConfig(model=model, epochs=3, eval_every=0, kernel="hyb", agg_dtype=agg_dtype,
                       reuse=reuse, learning_rate=0.005 if model == "gat" else 0.01)


def epoch_cells(g: Graph, device: torch.device) -> dict:
    """The four Reddit-config epoch cells, GCN and GAT, f32 and bf16 gather."""
    out = {}
    for model in ("gcn", "gat"):
        for agg, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            eng = Engine(g, LayerConfig(LAYERS), epoch_config(model, agg), device=device)
            out[f"{model}_reddit_config_epoch{suffix}_ms"] = epoch_ms_warm(eng)
            del eng
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def community_cells(cg: Graph, device: torch.device) -> dict:
    """GCN warm epochs on the Reddit-size community graph with reuse "off"
    and "pairs" (bf16 gather), and the pairs engine's rewrite."""
    times = {}
    for reuse in ("off", "pairs"):
        eng = Engine(cg, LayerConfig(LAYERS), epoch_config("gcn", "bfloat16", reuse),
                     device=device)
        times[reuse] = epoch_ms_warm(eng)
        if reuse == "pairs":
            op = eng.model.spmm_op
            rewrite = {"row_cut": op.plan_fwd.stats["row_reduction"],
                       "build_s": op.build_seconds, "miner": op.miner}
        del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"reuse_reddit_community_epoch_off_ms": times["off"],
            "reuse_reddit_community_epoch_ms": times["pairs"],
            "reuse_reddit_community_speedup": times["off"] / times["pairs"],
            "reuse_reddit_community_row_cut": rewrite["row_cut"],
            "reuse_reddit_community_mine_s": rewrite["build_s"],
            "reuse_miner": rewrite["miner"]}


# ---- the pair-reuse cell past the L2: host work, then the card ----

_PLAN_PARTS = ("rows", "cnt", "v")


def _plan_arrays(plan: dict, prefix: str) -> dict:
    """A mask hyb plan's arrays under flat names (for an .npz)."""
    out = {f"{prefix}nb": np.int64(len(plan["buckets"]))}
    for i, b in enumerate(plan["buckets"]):
        out.update({f"{prefix}b{i}_{k}": b[k] for k in _PLAN_PARTS})
    if plan["top"] is not None:
        out.update({f"{prefix}top_{k}": plan["top"][k] for k in _PLAN_PARTS + ("rowv",)})
    if "_n_iso" in plan:
        out[f"{prefix}n_iso"] = np.int64(plan["_n_iso"])
    else:
        out[f"{prefix}inv"] = plan["inv"]
    return out


def _plan_of(arrays, prefix: str) -> dict:
    """`_plan_arrays` read back: what `_upload` reads of a mask plan."""
    plan = {"buckets": tuple({k: arrays[f"{prefix}b{i}_{k}"] for k in _PLAN_PARTS}
                             for i in range(int(arrays[f"{prefix}nb"]))),
            "top": None}
    if f"{prefix}top_rows" in arrays:
        plan["top"] = {k: arrays[f"{prefix}top_{k}"] for k in _PLAN_PARTS + ("rowv",)}
    if f"{prefix}n_iso" in arrays:
        plan["_n_iso"] = int(arrays[f"{prefix}n_iso"])
    else:
        plan["inv"] = arrays[f"{prefix}inv"]
    return plan


def largev_host(v: int, deg: int, comm: int, core: int, p_core: float, seed: int) -> dict:
    """The reuse cell's host work (bench.py:228-250): the community-core
    edges, the plain mask plan, `mine_reuse(min_uses=3, passes=2)` (timed:
    `mine_s`, as bench.py times it) and the rewrite's mask plan. Returns
    flat numpy arrays and scalars (an .npz holds them)."""
    t0 = time.perf_counter()
    src, dst = community_core_edges(v, deg, comm=comm, core=core, p_core=p_core, seed=seed)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = mine_reuse(src, dst, v, min_uses=3, passes=2)
    mine_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = {"v": np.int64(v), "e": np.int64(len(src)), "graph_s": np.float64(graph_s),
           "mine_s": np.float64(mine_s), "miner": np.str_(
               "native" if native.has_mine_pairs() else "numpy"),
           "row_cut": np.float64(plan.stats["row_reduction"]),
           "num_pairs": np.int64(plan.num_pairs), "table_size": np.int64(plan.table_size),
           "n_levels": np.int64(len(plan.levels)),
           **{f"level{i}": np.ascontiguousarray(p, np.int32)
              for i, p in enumerate(plan.levels)},
           **_plan_arrays(build_hyb_plan(src, dst, None, v), "plain_"),
           **_plan_arrays(build_hyb_plan(plan.src, plan.dst, None, v), "reuse_")}
    out["plan_s"] = np.float64(time.perf_counter() - t0)
    return out


def largev_worker(path: str) -> None:
    """`largev_host` in a process of its own (chip_smoke.py starts it early
    and reads the .npz later)."""
    np.savez(path, **largev_host(**LARGEV))


def largev_cell(host, device: torch.device, iters: int) -> dict:
    """K2's mask pass over the plain plan against K6 + K2 over the rewrite
    (bench.py:238-258) on `host` (largev_host's arrays), bf16 gather
    tables, F=128: each checked once against its plain version, then
    timed. edges/s counts the original edges (the rewrite computes the
    same operator)."""
    v, e, size = int(host["v"]), int(host["e"]), int(host["table_size"])
    bf16 = torch.bfloat16
    plain = _upload(_plan_of(host, "plain_"), v, torch.float32, device)
    rw = _upload(_plan_of(host, "reuse_"), size, torch.float32, device)
    lvls = [torch.from_numpy(host[f"level{i}"]).to(device)
            for i in range(int(host["n_levels"]))]
    rh = torch.tensor(np.random.default_rng(3).normal(0, 0.3, size=(v, F_HID))
                      .astype(np.float32), device=device)
    dt_plain = checked_ms("K2 plain pass", lambda: hyb_mask_pass(rh, plain, v, bf16),
                          lambda: hyb_mask_pass_plain(rh, plain, v, bf16), bf16, iters, device)
    tbl = build_pair_table(rh, lvls, size)
    check_close("K6 pair table", tbl, build_pair_table_plain(rh, lvls), None)
    check_close("reuse pass (K6 + K2)", hyb_mask_pass(tbl, rw, v, bf16),
                hyb_mask_pass_plain(rh, plain, v, bf16), bf16)
    del tbl
    dt_reuse = checked_ms(
        "K2 over the rewrite", lambda: hyb_mask_pass(build_pair_table(rh, lvls, size), rw, v,
                                                      bf16),
        lambda: hyb_mask_pass_plain(build_pair_table_plain(rh, lvls), rw, v, bf16), bf16,
        iters, device)
    return {"reuse_largev_V": v, "reuse_largev_E": e,
            "reuse_largev_plain_edges_per_s": e / (dt_plain * 1e-3),
            "reuse_largev_edges_per_s": e / (dt_reuse * 1e-3),
            "reuse_largev_speedup": dt_plain / dt_reuse,
            "reuse_row_cut": float(host["row_cut"]), "reuse_mine_s": float(host["mine_s"]),
            "reuse_miner": str(host["miner"])}


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def record(g: Graph, cells: dict, epochs: dict, cpu_eps: float, platform: str,
           device_name: str, extra: dict) -> dict:
    """bench.py's JSON object (its keys; numbers unrounded) from the pass
    cells, the epoch cells and the card's reuse cells, with the port's
    extras."""
    e = g.num_edges

    def eps(ms):
        return e / (ms * 1e-3)

    edges_per_s = eps(cells["spmm_ms"])
    gather_eps = cells["gather"]["rows_per_s"]
    return {
        "metric": "spmm_aggregation_edges_per_s_per_chip",
        "value": edges_per_s,
        "unit": "edges/s",
        "vs_baseline": edges_per_s / cpu_eps,
        "extras": {
            "platform": platform,
            "device": device_name,
            "num_vertices": g.num_vertices,
            "num_edges": e,
            "feature_dim": F_HID,
            "kernel": "hyb+bf16gather+staticvals+degsort",
            "spmm_ms": cells["spmm_ms"],
            "spmm_dynamic_vals_ms": cells["spmm_dynamic_vals_ms"],
            "spmm_f32_ms": cells["spmm_f32_ms"],
            "spmm_f32_edges_per_s": eps(cells["spmm_f32_ms"]),
            "spmm_degree_kernel_ms": cells["spmm_degree_kernel_ms"],
            "spmm_degree_kernel_edges_per_s": eps(cells["spmm_degree_kernel_ms"]),
            "fraction_of_gather_bound": edges_per_s / gather_eps,
            "gather_bound_edges_per_s": gather_eps,
            "edgewise_spmm_ms": cells["edgewise_spmm_ms"],
            "edgewise_edges_per_s": eps(cells["edgewise_spmm_ms"]),
            "cpu_scipy_edges_per_s": cpu_eps,
            "torch_sparse_mm_edges_per_s": eps(cells["torch_sparse_mm_ms"]),
            "epoch_timing": EPOCH_TIMING,
            **epochs,
            **extra,
        },
    }


def main(device: str | torch.device | None = None) -> dict:
    """Run every cell and print bench.py's JSON line; returns the object.
    device None means the card (raises without one); "cpu" runs bench.py's
    CPU scale without the reuse cells."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    scale = SCALES["cuda" if on_card else "cpu"]
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    g = bench_graph(scale["v"], scale["deg"])
    ops = {"bf16": HybSpMM(g.src, g.dst, g.num_vertices, g.num_vertices,
                           gather_dtype=torch.bfloat16, static_val=g.edge_norm, dynamic=True,
                           device=dev),
           "f32": HybSpMM(g.src, g.dst, g.num_vertices, g.num_vertices,
                          static_val=g.edge_norm, device=dev),
           "degree": DegreeSpMM(g.src, g.dst, g.num_vertices, g.num_vertices, block=16,
                                gather_dtype=torch.bfloat16, static_val=g.edge_norm,
                                device=dev),
           "edge": EdgeSpMM(g.src, g.dst, g.num_vertices, g.num_vertices, device=dev)}
    cells = spmm_cells(g, ops, scale["iters"], dev)
    del ops
    extra = {}
    if on_card:
        extra.update(largev_cell(largev_host(**LARGEV), dev, scale["iters"]))
        torch.cuda.empty_cache()
        extra.update(community_cells(community_graph(scale["v"], scale["deg"], **COMMUNITY),
                                     dev))
    h = np.random.default_rng(0).normal(0, 1, size=(g.num_vertices, F_HID)).astype(np.float32)
    cpu_eps = cpu_spmm_baseline(g, h)
    res = record(g, cells, epoch_cells(g, dev), cpu_eps, "gpu" if on_card else "cpu",
                 card_name() if on_card else "cpu", extra)
    print(json.dumps(res), flush=True)
    return res
