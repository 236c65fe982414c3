"""Time the slot-gather passes K1 (static), K2 (mask) and K8 (two tables) on
the card, at the shapes the main paths give them.

    python dorylus_tpu_torch/tools/gather_bench.py [--tree DIR] [--label NAME]
        [--iters 20] [--out FILE]

`--tree` names the checkout whose `dorylus_tpu_torch` is measured (default:
the one that holds this file), so one call can hold two checkouts against
each other in turns. Every case builds its op through the public
constructors and times the public pass entries, which exist in every
version of the port since the sharded slice.

Cases (the Reddit-shaped graph of chip_smoke.py: `build_graph(232_965, 50,
602, 41, seed=1)`, degree-ascending; rank 0's shard of its 4-way range
partition), each at bf16 F=128, bf16 F=41 and f32 F=128:
  * `hyb static` / `hyb mask`: the single-device hyb plan, forward, K1 / K2;
  * `degree static`: the single-device degree plan (one part), K1;
  * `shard0 {combined, interior, boundary} static`: rank 0's three degree
    plans, K1;
  * `shard0 fused {static, mask}`: rank 0's fused-overlap plan, K8 (and, in
    checkouts before the one-launch pass, K1/K2 on its pure buckets);
  * `gcn step` / `gat step`: the Reddit-config train step (602-128-41, hyb,
    bf16 gather tables), `step_ms` by CUDA events, `kernel_ms` the gather
    kernels' device time in it and `device_ms` all kernels', per step.

For each case: `pass_ms` (CUDA events around `iters` calls of the pass
entry: the cast of the table, the zero-filled output and the kernel
launches), `kernel_ms` (torch.profiler's device time of the gather kernels
over the same calls, by kernel name, per call) and `other_ms` (the rest of
the device time: cast and fill), `launches` per call, `bound_ms` (the
table rows the plan reads once, every live slot's index and value once, the
f32 output once, over 3.35 TB/s), `library_ms` (`torch.sparse.mm` of the
same matrix with the table pre-cast to the gather dtype), and the max error
against the plain version, relative to max|plain|.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
REDDIT = dict(v=232_965, deg=50, feat=602, classes=41)
CONFIGS = (("bfloat16", 128), ("bfloat16", 41), ("float32", 128))
# The gather kernels' names in every version of the port's sources.
KERNEL_NAMES = re.compile(r"hyb_part_kernel|fused_part_kernel|gather_pass_kernel")


def _ms(torch, fn, iters: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(torch, fn, iters: int) -> tuple[float, float]:
    """(gather kernels' device ms, every other kernel's device ms) per call
    of fn, from torch.profiler over `iters` calls after one warm-up. The
    `torch` module is passed in, so that this file imports nothing of the
    checkout it measures before --tree is on the path."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    gather = other = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", 0.0)
        if KERNEL_NAMES.search(e.key):
            gather += t
        else:
            other += t
    return gather / 1e3 / iters, other / 1e3 / iters


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the rows here (JSON)")
    ap.add_argument("--only", default="", help="time only the cases whose "
                    "'case dtype F' matches this regular expression")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gather_bench: torch.cuda.is_available() is False: no GPU to measure",
              file=sys.stderr)
        return 1
    from dorylus_tpu_torch.graph.graph import build_graph
    from dorylus_tpu_torch.graph.partition import partition_graph, shard_edges
    from dorylus_tpu_torch.graph.reorder import apply_order, degree_order
    from dorylus_tpu_torch.ops import cuda_build, degree_spmm, hyb_sharded, hyb_spmm
    from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
    from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
    from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"gather_bench [{args.label}] tree {args.tree}: {card}", flush=True)
    info = cuda_build.compile_sources([hyb_spmm._CSRC, hyb_sharded._CSRC])
    for src, inf in info.items():
        for line in inf["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {src.name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    g = build_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"], seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    sg = partition_graph(g, 4)
    shard0 = sg.shards[0]
    print(f"graphs: {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def counts():
        return (hyb_spmm.KERNEL_LAUNCHES + hyb_spmm.MASK_LAUNCHES
                + hyb_sharded.FUSED_LAUNCHES)

    rows = []

    def measure(case, dtype, f, fn, plain, live, table_rows, out_rows, slot_bytes, csr):
        if not re.search(args.only, f"{case} {dtype} {f}"):
            return
        out = fn()
        ref = plain()
        err = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        del out, ref
        before = counts()
        fn()
        torch.cuda.synchronize()
        launches = counts() - before
        pass_ms = _ms(torch, fn, args.iters)
        kernel_ms, other_ms = device_split(torch, fn, args.iters)
        elt = 2 if dtype == "bfloat16" else 4
        nbytes = table_rows * f * elt + live * slot_bytes + out_rows * f * 4
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        a = torch.sparse_csr_tensor(csr["row_ptr"], csr["col"], csr["val"].to(dt),
                                    size=csr["shape"])
        x = torch.randn(csr["shape"][1], f, generator=gen, device="cuda").to(dt)
        try:
            library_ms = _ms(torch, lambda: torch.sparse.mm(a, x), 10)
        except (RuntimeError, NotImplementedError):
            library_ms = None
        del a, x
        row = {"label": args.label, "case": case, "dtype": dtype, "F": f,
               "pass_ms": pass_ms, "kernel_ms": kernel_ms, "other_ms": other_ms,
               "launches": launches, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "library_ms": library_ms, "rel_err": err, "live_slots": live}
        rows.append(row)
        print("bench " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()

    def csr_of(src, dst, val, num_out, num_in):
        dst_t = torch.as_tensor(np.asarray(dst), device="cuda").long()
        ptr = torch.zeros(num_out + 1, dtype=torch.int64, device="cuda")
        ptr[1:] = torch.cumsum(torch.bincount(dst_t, minlength=num_out), 0)
        return {"row_ptr": ptr.int(), "col": torch.as_tensor(np.asarray(src), device="cuda").int(),
                "val": torch.as_tensor(np.asarray(val, np.float32), device="cuda"),
                "shape": (num_out, num_in)}

    def live_of(parts):
        return sum(int(p["cnt"].sum()) for p in parts)

    # the single-device hyb and degree plans
    csr_norm = csr_of(g.src, g.dst, g.edge_norm, v, v)
    csr_ones = dict(csr_norm, val=torch.ones_like(csr_norm["val"]))
    src_rows = int(np.unique(g.src).size)
    for gd_name in ("bfloat16", "float32"):
        gd = torch.bfloat16 if gd_name == "bfloat16" else None
        op = HybSpMM(g.src, g.dst, v, v, gather_dtype=gd, static_val=g.edge_norm, device="cuda")
        parts = list(op.fwd["buckets"]) + ([op.fwd["top"]] if op.fwd["top"] is not None else [])
        print(f"hyb plan ({gd_name}): {len(parts)} parts, widths "
              f"{[int(p['rows'].shape[1]) for p in parts]}, top {op.fwd['top'] is not None}",
              flush=True)
        live = live_of(parts)
        for dtype, f in CONFIGS:
            if dtype != gd_name:
                continue
            h = torch.randn(v, f, generator=gen, device="cuda")
            for mode, entry, plain, slot, csr in (
                    ("static", hyb_spmm.hyb_static_pass, hyb_spmm.hyb_static_pass_plain,
                     4 + (2 if gd else 4), csr_norm),
                    ("mask", hyb_spmm.hyb_mask_pass, hyb_spmm.hyb_mask_pass_plain, 4, csr_ones)):
                measure(f"hyb {mode}", dtype, f, lambda: entry(h, op.fwd, v, gd),
                        lambda: plain(h, op.fwd, v, gd), live, src_rows, v, slot, csr)
            del h
        del op
        dop = DegreeSpMM(g.src, g.dst, v, v, gather_dtype=gd, static_val=g.edge_norm,
                         device="cuda")
        live = live_of([dop.fwd["part"]])
        for dtype, f in CONFIGS:
            if dtype != gd_name:
                continue
            h = torch.randn(v, f, generator=gen, device="cuda")
            measure("degree static", dtype, f,
                    lambda: degree_spmm.degree_pass(h, dop.fwd, v, gd, "static"),
                    lambda: degree_spmm.degree_pass_plain(h, dop.fwd, v, gd, "static"),
                    live, src_rows, v, 4 + (2 if gd else 4), csr_norm)
            del h
        del dop
        torch.cuda.empty_cache()
    del csr_norm, csr_ones

    # rank 0's degree plans and fused plan
    vp = sg.vp
    for edges in ("combined", "interior", "boundary"):
        es, ed, ev = shard_edges(shard0, edges)
        csr = csr_of(es, ed, ev, vp, {"combined": vp + 4 * sg.max_h, "interior": vp,
                                      "boundary": 4 * sg.max_h}[edges])
        rows_read = int(np.unique(es).size)
        for gd_name in ("bfloat16", "float32"):
            gd = torch.bfloat16 if gd_name == "bfloat16" else None
            dop = ShardedDegreeSpMM(shard0, 4, edges=edges, static_vals=True, gather_dtype=gd,
                                    device="cuda")
            live = live_of([dop.fwd["part"]])
            for dtype, f in CONFIGS:
                if dtype != gd_name:
                    continue
                h = torch.randn(dop.num_in, f, generator=gen, device="cuda")
                measure(f"shard0 {edges} static", dtype, f,
                        lambda: degree_spmm.degree_pass(h, dop.fwd, vp, gd, "static"),
                        lambda: degree_spmm.degree_pass_plain(h, dop.fwd, vp, gd, "static"),
                        live, rows_read, vp, 4 + (2 if gd else 4), csr)
                del h
            del dop
        del csr
    ne = shard0.num_edges
    table = vp + 4 * sg.max_h
    csr_norm = csr_of(shard0.src[:ne], shard0.dst[:ne], shard0.edge_val[:ne], vp, table)
    csr_ones = dict(csr_norm, val=torch.ones_like(csr_norm["val"]))
    rows_read = int(np.unique(shard0.src[:ne]).size)
    for gd_name in ("bfloat16", "float32"):
        gd = torch.bfloat16 if gd_name == "bfloat16" else None
        for static in (True, False):
            fop = ShardedHybSpMM(shard0, 4, edges="fused", static_vals=static, gather_dtype=gd,
                                 device="cuda")
            parts = list(fop.fwd["buckets"]) + (
                [fop.fwd["top"]] if fop.fwd["top"] is not None else [])
            live = live_of(parts)
            mode = "static" if static else "mask"
            for dtype, f in CONFIGS:
                if dtype != gd_name:
                    continue
                h = torch.randn(vp, f, generator=gen, device="cuda")
                gh = torch.randn(table - vp, f, generator=gen, device="cuda")
                measure(f"shard0 fused {mode}", dtype, f,
                        lambda: hyb_sharded.fused_pass(h, gh, fop.fwd, fop.n_pure, gd, mode),
                        lambda: hyb_sharded.fused_pass_plain(h, gh, fop.fwd, fop.n_pure, gd,
                                                             mode),
                        live, rows_read, vp, 4 + ((2 if gd else 4) if static else 0),
                        csr_norm if static else csr_ones)
                del h, gh
            del fop
    # the Reddit-config train steps (602-128-41, bf16 gather tables) that
    # run these passes: the step by CUDA events, its device time and the
    # gather kernels' share of it by torch.profiler, launches a step
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.engine.engine import Engine

    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        if not re.search(args.only, f"{model} step bfloat16 128"):
            continue
        cfg = TrainConfig(epochs=1, eval_every=1, model=model, kernel="hyb",
                          agg_dtype="bfloat16", learning_rate=lr, reuse="off")
        eng = Engine(g, LayerConfig([REDDIT["feat"], 128, REDDIT["classes"]]), cfg,
                     device="cuda")

        def step():
            eng._train_epoch(lr)

        step()
        before = counts()
        step()
        torch.cuda.synchronize()
        launches = counts() - before
        step_ms = _ms(torch, step, args.iters)
        kernel_ms, other_ms = device_split(torch, step, 5)
        row = {"label": args.label, "case": f"{model} step", "dtype": "bfloat16", "F": 128,
               "step_ms": step_ms, "kernel_ms": kernel_ms, "device_ms": kernel_ms + other_ms,
               "launches": launches}
        rows.append(row)
        print("bench " + json.dumps(row), flush=True)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"gather_bench": rows, "card": card}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
