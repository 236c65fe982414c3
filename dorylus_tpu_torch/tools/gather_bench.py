"""Time the slot-gather passes K1 (static), K2 (mask), K7 (dynamic values)
and K8 (two tables) and the edgewise CSR passes K3 and K4 on the card, at
the shapes the main paths give them.

    python dorylus_tpu_torch/tools/gather_bench.py [--tree DIR] [--label NAME]
        [--iters 20] [--out FILE] [--only REGEX]

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
    kernels' device time in it and `device_ms` all kernels', per step;
  * `edge fwd` / `edge dh` / `edge dh+dval` / `edge dval`, at f32 F=128,
    f32 F=41 and bf16 F=128: K3 over the Reddit graph's dst CSR, K3 over
    its src CSR through the permutation, the backward of GAT's edgewise
    aggregation (dh and the value gradient: one fused launch where the
    checkout has `csr_spmm_dval`, else K3's dh and K4 one after the other)
    and K4 alone; `library_ms` is `torch.sparse.mm` of the CSR (of the
    transposed CSR for dh), `torch.sparse.sampled_addmm` for dval, and the
    two summed for dh+dval (f32 only);
  * `gcn xla step` / `gat xla step`: the Reddit-config train step on
    kernel="xla" (f32), as the GCN and GAT steps above, its kernel time that
    of K3 and K4;
  * `{hyb, degree} dyn {fwd, dh, dh+dval}`, at bf16 F=128, bf16 F=41 and f32
    F=128: K7 over the Reddit graph's dynamic hyb plan and its degree plan,
    random per-edge values: the forward, dh alone over the transposed plan
    and dh with the value gradient (what `apply`'s backward runs when val
    needs a gradient; the pass includes the gather into edge order);
    `library_ms` is `torch.sparse.mm` with the call's values (of the
    transposed CSR for dh), and that plus `torch.sparse.sampled_addmm` for
    dh+dval (f32 only);
  * `gcn {static-op, dyn, degree dyn} step`: the Reddit-config GCN train
    step (bf16 gather tables) through the model and the reference Adam on a
    static-value hyb op, a dynamic hyb op and a degree op without static
    values (the model's `apply(h, edge_val)` branch: K7's forward and dh
    alone), as chip_smoke.py's phase 4f runs it.

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
KERNEL_NAMES = re.compile(r"hyb_part_kernel|fused_part_kernel|gather_pass_kernel|"
                          r"csr_spmm_kernel|sddmm_kernel|csr_pass_kernel|"
                          r"dyn_part_kernel|dyn_pass_kernel")
EDGE_CONFIGS = (("float32", 128), ("float32", 41), ("bfloat16", 128))
# The edgewise launch counters of every version of ops/spmm.py (K5 apart).
EDGE_COUNTERS = ("SPMM_LAUNCHES", "SPMM_T_LAUNCHES", "SPMM_DVAL_LAUNCHES", "SDDMM_LAUNCHES")
# K7's launch counters of every version of ops/hyb_spmm.py.
DYN_COUNTERS = ("DYN_LAUNCHES", "DYN_T_LAUNCHES", "DYN_DVAL_LAUNCHES")


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


def edge_cases(args, rows: list, g, gen, counts) -> None:
    """The edgewise rows (see the module's docstring) on the graph g."""
    import numpy as np
    import torch

    from dorylus_tpu_torch.ops import spmm

    v, e = g.num_vertices, g.num_edges
    op = spmm.EdgeSpMM(g.src, g.dst, v, v, device="cuda")
    src = torch.tensor(g.src, device="cuda")
    val = torch.tensor(g.edge_norm, device="cuda")
    rp, trp, tc, order = op.row_ptr, op.t_row_ptr, op.t_col, op.order
    fused = hasattr(spmm, "csr_spmm_dval")
    # the rows each pass reads once: K3 forward and K4 gather h[src], dh gout[dst]
    src_rows, dst_rows = int(np.unique(g.src).size), int(np.unique(g.dst).size)
    a_fwd = torch.sparse_csr_tensor(rp, src, val, size=(v, v))
    a_bwd = torch.sparse_csr_tensor(trp, tc, val[order.long()], size=(v, v))
    pattern = torch.sparse_csr_tensor(rp, src, torch.ones_like(val), size=(v, v))
    idx_bytes = (v + 1) * 4 + e * 4  # row_ptr and col
    for dtype, f in EDGE_CONFIGS:
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        elt = 2 if dt == torch.bfloat16 else 4
        h = torch.randn(v, f, generator=gen, device="cuda").to(dt)
        gout = torch.randn(v, f, generator=gen, device="cuda").to(dt)

        def dh_dval():
            if fused:
                return spmm.csr_spmm_dval(gout, h, trp, tc, val, order, op.inv_order)
            return (spmm.csr_spmm(gout, trp, tc, val, order), spmm.sddmm(h, gout, rp, src))

        def dh_dval_plain():
            return (spmm.csr_spmm_plain(gout, trp, tc, val, order),
                    spmm.sddmm_plain(h, gout, rp, src))

        def lib_mm(a, x):
            return lambda: torch.sparse.mm(a.to(x.dtype), x)

        def lib_dval():
            return torch.sparse.sampled_addmm(pattern, gout, h.t(), beta=0.0)

        cases = (
            ("fwd", lambda: spmm.csr_spmm(h, rp, src, val),
             lambda: spmm.csr_spmm_plain(h, rp, src, val),
             src_rows * f * elt + idx_bytes + e * 4 + v * f * 4, [lib_mm(a_fwd, h)]),
            ("dh", lambda: spmm.csr_spmm(gout, trp, tc, val, order),
             lambda: spmm.csr_spmm_plain(gout, trp, tc, val, order),
             dst_rows * f * elt + idx_bytes + 2 * e * 4 + v * f * 4, [lib_mm(a_bwd, gout)]),
            ("dh+dval", dh_dval, dh_dval_plain,
             (dst_rows + src_rows) * f * elt + idx_bytes + 3 * e * 4 + v * f * 4,
             [lib_mm(a_bwd, gout), lib_dval]),
            ("dval", lambda: spmm.sddmm(h, gout, rp, src),
             lambda: spmm.sddmm_plain(h, gout, rp, src),
             (src_rows + dst_rows) * f * elt + idx_bytes + e * 4, [lib_dval]),
        )
        for name, fn, plain, nbytes, libs in cases:
            case = f"edge {name}"
            if not re.search(args.only, f"{case} {dtype} {f}"):
                continue
            got, ref = fn(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                      for a, b in zip(got, ref))
            del got, ref
            before = counts()
            fn()
            torch.cuda.synchronize()
            launches = counts() - before
            pass_ms = _ms(torch, fn, args.iters)
            kernel_ms, other_ms = device_split(torch, fn, args.iters)
            library_ms = None
            if dt == torch.float32:
                try:
                    library_ms = sum(_ms(torch, lib, 10) for lib in libs)
                except (RuntimeError, NotImplementedError):
                    library_ms = None
            row = {"label": args.label, "case": case, "dtype": dtype, "F": f,
                   "pass_ms": pass_ms, "kernel_ms": kernel_ms, "other_ms": other_ms,
                   "launches": launches, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                   "library_ms": library_ms, "rel_err": err, "edges": e}
            rows.append(row)
            print("bench " + json.dumps(row), flush=True)
        del h, gout
        torch.cuda.empty_cache()


def _row_err(got, ref) -> float:
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


def dyn_cases(args, rows: list, g, gen, counts) -> None:
    """K7's rows (see the module's docstring) on the graph g."""
    import numpy as np
    import torch

    from dorylus_tpu_torch.ops import degree_spmm, hyb_spmm
    from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM

    v, e = g.num_vertices, g.num_edges
    src_rows, dst_rows = int(np.unique(g.src).size), int(np.unique(g.dst).size)
    order = np.argsort(g.src, kind="stable")
    rp = torch.zeros(v + 1, dtype=torch.int64, device="cuda")
    rp[1:] = torch.cumsum(torch.bincount(torch.as_tensor(g.dst, device="cuda").long(),
                                         minlength=v), 0)
    trp = torch.zeros(v + 1, dtype=torch.int64, device="cuda")
    trp[1:] = torch.cumsum(torch.bincount(torch.as_tensor(g.src, device="cuda").long(),
                                          minlength=v), 0)
    col = torch.as_tensor(g.src, device="cuda").int()
    tcol = torch.as_tensor(g.dst[order], device="cuda").int()
    order_t = torch.as_tensor(order, device="cuda")
    val = torch.randn(e, generator=gen, device="cuda")
    pattern = torch.sparse_csr_tensor(rp.int(), col, torch.ones_like(val), size=(v, v))
    a_fwd = torch.sparse_csr_tensor(rp.int(), col, val, size=(v, v))
    a_bwd = torch.sparse_csr_tensor(trp.int(), tcol, val[order_t], size=(v, v))
    for kind in ("hyb", "degree"):
        for gd_name in ("bfloat16", "float32"):
            if not any(re.search(args.only, f"{kind} dyn {c} {d} {f}")
                       for c in ("fwd", "dh", "dh+dval") for d, f in CONFIGS if d == gd_name):
                continue
            gd = torch.bfloat16 if gd_name == "bfloat16" else None
            if kind == "hyb":
                op = HybSpMM(g.src, g.dst, v, v, gather_dtype=gd, dynamic=True, device="cuda")

                def run(table, plan, other=None):
                    return hyb_spmm.hyb_dynamic_pass(table, plan, v, val, gd, other)

                def plain(table, plan, other=None):
                    return hyb_spmm.hyb_dynamic_pass_plain(table, plan, v, val, gd, other)

                live = sum(int(p["cnt"].sum()) for p in list(op.fwd["buckets"]) + (
                    [op.fwd["top"]] if op.fwd["top"] is not None else []))
            else:
                op = DegreeSpMM(g.src, g.dst, v, v, gather_dtype=gd, device="cuda")

                def run(table, plan, other=None):
                    return degree_spmm.degree_pass(table, plan, v, gd, "dynamic", val, other)

                def plain(table, plan, other=None):
                    return degree_spmm.degree_pass_plain(table, plan, v, gd, "dynamic", val,
                                                         other)

                live = int(op.fwd["part"]["cnt"].sum())
            for dtype, f in CONFIGS:
                if dtype != gd_name:
                    continue
                dt = torch.bfloat16 if gd else torch.float32
                elt = 2 if gd else 4
                h = torch.randn(v, f, generator=gen, device="cuda")
                gout = torch.randn(v, f, generator=gen, device="cuda")
                # a row index per live slot and each value once; the
                # backward plan's slots also name their edge (a permutation)
                out_bytes, fwd_slot_bytes = v * f * 4, live * 4 + e * 4
                slot_bytes = fwd_slot_bytes + live * 4
                cases = (
                    ("fwd", lambda: run(h, op.fwd), lambda: plain(h, op.fwd),
                     src_rows * f * elt + fwd_slot_bytes + out_bytes, [(a_fwd, h)]),
                    ("dh", lambda: run(gout, op.bwd), lambda: plain(gout, op.bwd),
                     dst_rows * f * elt + slot_bytes + out_bytes, [(a_bwd, gout)]),
                    ("dh+dval", lambda: run(gout, op.bwd, h), lambda: plain(gout, op.bwd, h),
                     (dst_rows + src_rows) * f * elt + slot_bytes + e * 4 + out_bytes,
                     [(a_bwd, gout), "sddmm"]),
                )
                for name, fn, ref_fn, nbytes, libs in cases:
                    case = f"{kind} dyn {name}"
                    if not re.search(args.only, f"{case} {dtype} {f}"):
                        continue
                    err = _row_err(fn(), ref_fn())
                    before = counts()
                    fn()
                    torch.cuda.synchronize()
                    launches = counts() - before
                    pass_ms = _ms(torch, fn, args.iters)
                    kernel_ms, other_ms = device_split(torch, fn, args.iters)
                    library_ms = None
                    try:
                        if name != "dh+dval" or dt == torch.float32:
                            library_ms = 0.0
                            for lib in libs:
                                if lib == "sddmm":
                                    ht = h.t()
                                    library_ms += _ms(torch, lambda: torch.sparse.sampled_addmm(
                                        pattern, gout, ht, beta=0.0), 10)
                                else:
                                    a, x = lib[0].to(dt), lib[1].to(dt)
                                    library_ms += _ms(torch, lambda: torch.sparse.mm(a, x), 10)
                                    del a, x
                    except (RuntimeError, NotImplementedError):
                        library_ms = None
                    row = {"label": args.label, "case": case, "dtype": dtype, "F": f,
                           "pass_ms": pass_ms, "kernel_ms": kernel_ms, "other_ms": other_ms,
                           "launches": launches, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                           "library_ms": library_ms, "rel_err": err, "live_slots": live}
                    rows.append(row)
                    print("bench " + json.dumps(row), flush=True)
                del h, gout
                torch.cuda.empty_cache()
            del op
            torch.cuda.empty_cache()


def model_steps(args, rows: list, g, counts) -> None:
    """The Reddit-config GCN train step through the model and the reference
    Adam (chip_smoke.py's phase 4f) on a static-value hyb op and on the two
    ops without static values, bf16 gather tables."""
    import torch

    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.engine.batch import build_batch
    from dorylus_tpu_torch.models.gcn import GCN
    from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
    from dorylus_tpu_torch.optim.adam import adam_init, adam_update

    v, bf16 = g.num_vertices, torch.bfloat16
    batch = None
    for case, make in (
            ("gcn static-op step", lambda: HybSpMM(g.src, g.dst, v, v, gather_dtype=bf16,
                                                   static_val=g.edge_norm, device="cuda")),
            ("gcn dyn step", lambda: HybSpMM(g.src, g.dst, v, v, gather_dtype=bf16,
                                             dynamic=True, device="cuda")),
            ("gcn degree dyn step", lambda: DegreeSpMM(g.src, g.dst, v, v, gather_dtype=bf16,
                                                       device="cuda"))):
        if not re.search(args.only, f"{case} bfloat16 128"):
            continue
        batch = batch or build_batch(g, "cuda")
        model = GCN(LayerConfig([REDDIT["feat"], 128, REDDIT["classes"]]), spmm_op=make())
        state = {"params": model.init_params(seed=TrainConfig().seed)}
        state["adam"] = adam_init(state["params"])

        def step():
            params = state["params"]
            loss = model.loss(batch)
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
            state["params"], state["adam"] = adam_update(params, grads, state["adam"], lr=0.01)

        step()
        before = counts()
        step()
        torch.cuda.synchronize()
        launches = counts() - before
        step_ms = _ms(torch, step, args.iters)
        kernel_ms, other_ms = device_split(torch, step, 5)
        row = {"label": args.label, "case": case, "dtype": "bfloat16", "F": 128,
               "step_ms": step_ms, "kernel_ms": kernel_ms, "device_ms": kernel_ms + other_ms,
               "launches": launches}
        rows.append(row)
        print("bench " + json.dumps(row), flush=True)
        del model, state
        torch.cuda.empty_cache()


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
    from dorylus_tpu_torch.ops import cuda_build, degree_spmm, hyb_sharded, hyb_spmm, spmm
    from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
    from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
    from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"gather_bench [{args.label}] tree {args.tree}: {card}", flush=True)
    def wants(*cases):
        """Whether --only keeps any of these cases at any configuration (a
        section whose cases it keeps none of builds nothing)."""
        return any(re.search(args.only, f"{c} {d} {f}") for c in cases
                   for d, f in CONFIGS + EDGE_CONFIGS)

    slot_cases = ["hyb static", "hyb mask", "degree static", "gcn step", "gat step"]
    slot_cases += [f"shard0 {e} static" for e in ("combined", "interior", "boundary")]
    slot_cases += ["shard0 fused static", "shard0 fused mask"]
    edge_names = [f"edge {c}" for c in ("fwd", "dh", "dh+dval", "dval")]
    dyn_names = [f"{k} dyn {c}" for k in ("hyb", "degree") for c in ("fwd", "dh", "dh+dval")]
    step_names = ["gcn static-op step", "gcn dyn step", "gcn degree dyn step"]
    sources = ([hyb_spmm._CSRC, hyb_sharded._CSRC] if wants(*slot_cases) else []) + (
        [spmm._CSRC] if wants(*edge_names, "gcn xla step", "gat xla step") else []) + (
        [hyb_spmm._CSRC, hyb_spmm._DYN_CSRC] if wants(*dyn_names, *step_names) else [])
    info = cuda_build.compile_sources(list(dict.fromkeys(sources)))
    for src, inf in info.items():
        for line in inf["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {src.name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    g = build_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"], seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    sg = partition_graph(g, 4) if wants(*slot_cases[5:]) else None
    print(f"graphs: {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def counts():
        return (hyb_spmm.KERNEL_LAUNCHES + hyb_spmm.MASK_LAUNCHES
                + hyb_sharded.FUSED_LAUNCHES + sum(getattr(spmm, k, 0) for k in EDGE_COUNTERS)
                + sum(getattr(hyb_spmm, k, 0) for k in DYN_COUNTERS))

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

    # the edgewise CSR passes (K3, K4) on the Reddit graph
    if wants(*edge_names):
        edge_cases(args, rows, g, gen, counts)
        torch.cuda.empty_cache()
    # K7 on the Reddit graph's dynamic plans, and the steps that run it
    if wants(*dyn_names):
        dyn_cases(args, rows, g, gen, counts)
        torch.cuda.empty_cache()
    if wants(*step_names):
        model_steps(args, rows, g, counts)
        torch.cuda.empty_cache()

    # the single-device hyb and degree plans
    csr_norm = csr_of(g.src, g.dst, g.edge_norm, v, v)
    csr_ones = dict(csr_norm, val=torch.ones_like(csr_norm["val"]))
    src_rows = int(np.unique(g.src).size)
    single = wants("hyb static", "hyb mask", "degree static")
    for gd_name in ("bfloat16", "float32") if single else ():
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
    if sg is not None:
        shard0 = sg.shards[0]
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

    steps = [(m, lr, "hyb", "bfloat16") for m, lr in (("gcn", 0.01), ("gat", 0.005))]
    steps += [(m, lr, "xla", "float32") for m, lr in (("gcn", 0.01), ("gat", 0.005))]
    for model, lr, kernel, dtype in steps:
        case = f"{model} step" if kernel == "hyb" else f"{model} xla step"
        if not re.search(args.only, f"{case} {dtype} 128"):
            continue
        cfg = TrainConfig(epochs=1, eval_every=1, model=model, kernel=kernel,
                          agg_dtype=dtype, learning_rate=lr, reuse="off")
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
        row = {"label": args.label, "case": case, "dtype": dtype, "F": 128,
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
