"""Time the slot-gather passes K1 (static), K2 (mask), K7 (dynamic values)
and K8 (two tables), the edgewise CSR passes K3 and K4, the halo passes K9
and K10 and the segment-sum K5 on the card, at the shapes the main paths
give them.

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

  * `halo pack` (both wires), `halo place` (the exact wire; the padded
    wire places nothing) and `halo segsum`, at f32 and bf16, F=128 and 41:
    K9 and K10 on rank 0's HaloPlan of the 4-way partition; `library_ms` is
    `index_select` of the live packed rows (pack) and `index_add_` of the
    live returned rows (segsum); `bitwise` says whether K9 equals its plain
    version bit for bit;
  * `edge segsum (E,)`, `(E,) view` (g one element past a 16-byte
    boundary) and `(E,F)` (f32 F=128 and 41, bf16 F=128): K5 over the
    Reddit graph's dst CSR; `library_ms` is `index_add_` by dst;
  * `sharded gcn step`: 4 ranks on the one card over gloo, the
    Reddit-config GCN (hyb, bf16 gather tables, the fused plan: K8-K10),
    each rank's step ms by the host clock; `step_ms` the slowest rank's.
The small passes' rows also carry `host_us`, the host's microseconds to
enqueue one pass (`time.perf_counter` around 1,000 calls, no synchronise
inside a batch of 100).

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
# The gather kernels' names in every version of the port's sources, and
# K9's, K10's and K5's.
KERNEL_NAMES = re.compile(r"hyb_part_kernel|fused_part_kernel|gather_pass_kernel|"
                          r"csr_spmm_kernel|sddmm_kernel|csr_pass_kernel|"
                          r"dyn_part_kernel|dyn_pass_kernel|"
                          r"row_gather_kernel|row_gather_units|"
                          r"segsum_gather_kernel|segment_sum_vec_kernel|segment_sum_kernel|"
                          r"segment_sum_team_kernel")
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


def device_split(torch, fn, iters: int, names: re.Pattern = KERNEL_NAMES
                 ) -> tuple[float, float]:
    """(the device ms of the kernels `names` matches (by default the gather
    kernels), every other kernel's device ms) per call of fn, from
    torch.profiler over `iters` calls after one warm-up. The `torch` module
    is passed in, so that this file imports nothing of the checkout it
    measures before --tree is on the path."""
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
        if names.search(e.key):
            gather += t
        else:
            other += t
    return gather / 1e3 / iters, other / 1e3 / iters


def enqueue_us(torch, fn, calls: int = 1000, batch: int = 100) -> float:
    """Host microseconds to enqueue one call of fn: time.perf_counter
    around `calls` calls without a synchronise, in batches of `batch`
    with a synchronise (not timed) between them, so that the launch queue
    never fills and the host never waits for the device."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / (calls // batch * batch)


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


def small_passes(args, rows: list, pending: list, counts) -> None:
    """Time the small passes of `halo_cases` and `segsum_cases`: first,
    for every case, its pass ms, the host's µs per enqueue, its launches
    and the library call's ms; then every case's kernel-only ms. A
    torch.profiler session leaves every later launch of the process slower
    on the host (on an H100: K9's enqueue 11.3 -> 14-19 µs,
    `index_select`'s 9.3 -> 16-19), so none runs before the host is timed.
    pending: (row fields, fn, bytes the pass must move, library call or
    None)."""
    import torch

    done = []
    for fields, fn, nbytes, lib in pending:
        before = counts()
        fn()
        torch.cuda.synchronize()
        launches = counts() - before
        row = {"label": args.label, **fields, "pass_ms": _ms(torch, fn, args.iters),
               "host_us": enqueue_us(torch, fn), "launches": launches,
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
               "library_ms": None if lib is None else _ms(torch, lib, args.iters)}
        if lib is not None:
            row["library_host_us"] = enqueue_us(torch, lib)
        done.append(row)
    for row, (_, fn, _, _) in zip(done, pending):
        row["kernel_ms"], row["other_ms"] = device_split(torch, fn, args.iters)
        rows.append(row)
        print("bench " + json.dumps(row), flush=True)


def _halo_passes(halo, torch, plan, h, back, recv) -> list:
    """(case, fn, plain, bytes, library) of one plan and one width: K9's
    pack, K10, and on the exact wire K9's placement."""
    vp, f, row_b = plan.vp, h.shape[1], h.shape[1] * h.element_size()
    live = plan.pack >= 0
    live_l = plan.pack[live].long()
    n_live, uniq = int(live_l.numel()), int(torch.unique(live_l).numel())
    s_rows = int(plan.pack.shape[0])
    back_live = back[live].float()
    cases = [("halo pack", lambda: halo.row_gather(h, plan.pack),
              lambda: halo.row_gather_plain(h, plan.pack),
              uniq * row_b + 4 * s_rows + s_rows * row_b, lambda: h.index_select(0, live_l)),
             ("halo segsum", lambda: halo.segsum_gather(back, plan.order, plan.rows,
                                                       plan.row_ptr, vp),
              lambda: halo.segsum_gather_plain(back, plan.order, plan.rows, vp),
              n_live * row_b + 4 * n_live + 4 * (vp + 1) + vp * f * 4,
              lambda: torch.zeros((vp, f), device="cuda").index_add_(0, live_l, back_live))]
    if plan.place is not None:
        slots = int(plan.place.shape[0])
        cases.append(("halo place", lambda: halo.row_gather(recv, plan.place),
                      lambda: halo.row_gather_plain(recv, plan.place),
                      recv.shape[0] * row_b + 4 * slots + slots * row_b, None))
    return cases


def halo_cases(args, sg, gen) -> list:
    """K9's pack (both wires) and placement (the exact wire; the padded
    wire places nothing) and K10, on rank 0's HaloPlan of the 4-way
    partition, for `small_passes`; `library_ms` is `index_select` of the
    live packed rows (K9 pack) and `index_add_` of the live returned rows
    (K10)."""
    import numpy as np
    import torch

    from dorylus_tpu_torch.parallel import halo

    pending = []
    n, vp = 4, sg.vp
    cnt = np.stack([halo.ghost_counts(s, n, vp, sg.max_h) for s in sg.shards], axis=1)
    for wire in ("ragged", "padded"):
        plan = halo.HaloPlan(sg.shards[0], n, wire, "cuda", counts=(cnt[0], cnt[:, 0]))
        for dtype, f in (("float32", 128), ("float32", 41), ("bfloat16", 128),
                         ("bfloat16", 41)):
            dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            h = torch.randn(vp, f, generator=gen, device="cuda").to(dt)
            back = torch.randn(int(plan.pack.shape[0]), f, generator=gen, device="cuda").to(dt)
            recv = torch.randn(int(plan.recv_cnt.sum()), f, generator=gen, device="cuda").to(dt)
            for case, fn, plain, nbytes, lib in _halo_passes(halo, torch, plan, h, back, recv):
                if not re.search(args.only, f"{case} {wire} {dtype} {f}"):
                    continue
                got, ref = fn(), plain()
                exact = torch.equal(got, ref)
                err = float((got.float() - ref.float()).abs().max()) / max(
                    float(ref.float().abs().max()), 1e-30)
                del got, ref
                pending.append(({"case": case, "wire": wire, "dtype": dtype, "F": f,
                                 "rel_err": err, "bitwise": exact}, fn, nbytes, lib))
    return pending


def segsum_cases(args, g, gen) -> list:
    """K5 over the Reddit graph's dst CSR, for `small_passes`: the (E,)
    cotangent (GAT's attention), also as a view one element past a
    16-byte boundary, and (E, F) at f32 F=128, f32 F=41, bf16 F=128;
    `library_ms` is `index_add_` of the same cotangent (in f32) by dst."""
    import torch

    from dorylus_tpu_torch.ops import spmm

    pending = []
    v, e = g.num_vertices, g.num_edges
    op = spmm.EdgeSpMM(g.src, g.dst, v, v, device="cuda")
    rp = op.row_ptr
    dst_l = torch.as_tensor(g.dst, device="cuda").long()
    for name, dtype, f in (("(E,)", "float32", 1), ("(E,) view", "float32", 1),
                           ("(E,F)", "float32", 128), ("(E,F)", "float32", 41),
                           ("(E,F)", "bfloat16", 128)):
        case = f"edge segsum {name}"
        if not re.search(args.only, f"{case} {dtype} {f}"):
            continue
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        shape = (e,) if f == 1 else (e, f)
        if name.endswith("view"):
            gco = torch.randn(e + 1, generator=gen, device="cuda")[1:]
        else:
            gco = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        g32 = gco.float()
        out_shape = (v,) + shape[1:]
        got, ref = spmm.segment_sum(gco, rp), spmm.segment_sum_plain(gco, rp)
        err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        del got, ref
        elt = 2 if dt == torch.bfloat16 else 4
        pending.append(({"case": case, "dtype": dtype, "F": f, "rel_err": err},
                        lambda gco=gco: spmm.segment_sum(gco, rp),
                        e * f * elt + 4 * (v + 1) + 4 * v * f,
                        lambda g32=g32, out_shape=out_shape: torch.zeros(
                            out_shape, device="cuda").index_add_(0, dst_l, g32)))
    return pending


def _sharded_step_rank(rank: int, world: int, device, shard_dir: str, steps: int) -> dict:
    """One rank of `sharded gcn step` (started by multihost.spawn_local):
    the Reddit-config GCN on this rank's shard, hyb with bf16 gather
    tables (the fused plan, K8-K10), its train step timed over `steps`
    steps after two."""
    import torch

    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel import halo
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    shard, meta = load_shard(f"{shard_dir}/reddit_{rank}.npz")
    cfg = TrainConfig(epochs=1, eval_every=1, kernel="hyb", reuse="off", agg_dtype="bfloat16")
    eng = ShardedEngine((shard, meta), LayerConfig([REDDIT["feat"], 128, REDDIT["classes"]]),
                        cfg, device=device)
    lr = cfg.learning_rate

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    for _ in range(2):
        eng._train_epoch(lr)
    sync()
    k9, k10 = halo.PACK_LAUNCHES, halo.HALO_BWD_LAUNCHES
    t0 = time.perf_counter()
    for _ in range(steps):
        eng._train_epoch(lr)
    sync()
    return {"rank": rank, "step_ms": 1e3 * (time.perf_counter() - t0) / steps,
            "K9_per_step": (halo.PACK_LAUNCHES - k9) / steps,
            "K10_per_step": (halo.HALO_BWD_LAUNCHES - k10) / steps}


def sharded_step(args, rows: list, sg) -> None:
    """`sharded gcn step`: 4 ranks on the one card over gloo (what phase 6
    of chip_smoke.py runs), each rank's step ms by the host clock around
    synchronised steps."""
    import shutil
    import tempfile

    from dorylus_tpu_torch.graph.partition import ShardMeta, save_shard
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    shard_dir = tempfile.mkdtemp(prefix="gather_bench_shards_")
    try:
        for s in sg.shards:
            save_shard(f"{shard_dir}/reddit_{s.shard_id}.npz", s, ShardMeta.of(sg))
        res = spawn_local(4, _sharded_step_rank, (shard_dir, 5), backend="gloo",
                          device="cuda:0", timeout_s=900)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    row = {"label": args.label, "case": "sharded gcn step", "dtype": "bfloat16", "F": 128,
           "step_ms": max(r["step_ms"] for r in res), "rank_step_ms": [r["step_ms"] for r in res],
           "K9_per_step": res[0]["K9_per_step"], "K10_per_step": res[0]["K10_per_step"]}
    rows.append(row)
    print("bench " + json.dumps(row), flush=True)


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
                    "'case dtype F' (for the halo cases 'case wire dtype F') matches this "
                    "regular expression")
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
    from dorylus_tpu_torch.parallel import halo

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
    halo_names = [f"halo {c} {w}" for c in ("pack", "place", "segsum")
                  for w in ("ragged", "padded")]
    segsum_names = ["edge segsum (E,)", "edge segsum (E,) view", "edge segsum (E,F)"]
    sharded = wants("sharded gcn step")
    sources = ([hyb_spmm._CSRC, hyb_sharded._CSRC] if wants(*slot_cases) or sharded else []) + (
        [spmm._CSRC] if wants(*edge_names, *segsum_names, "gcn xla step", "gat xla step")
        else []) + (
        [hyb_spmm._CSRC, hyb_spmm._DYN_CSRC] if wants(*dyn_names, *step_names) else []) + (
        [halo._CSRC] if wants(*halo_names) or sharded else [])
    info = cuda_build.compile_sources(list(dict.fromkeys(sources)))
    for src, inf in info.items():
        for line in inf["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {src.name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    g = build_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"], seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    sg = partition_graph(g, 4) if wants(*slot_cases[5:], *halo_names) or sharded else None
    print(f"graphs: {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def counts():
        return (hyb_spmm.KERNEL_LAUNCHES + hyb_spmm.MASK_LAUNCHES
                + hyb_sharded.FUSED_LAUNCHES + sum(getattr(spmm, k, 0) for k in EDGE_COUNTERS)
                + sum(getattr(hyb_spmm, k, 0) for k in DYN_COUNTERS) + spmm.SEGSUM_LAUNCHES
                + halo.PACK_LAUNCHES + halo.HALO_BWD_LAUNCHES)

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

    # K9 and K10 on rank 0's plan, K5 on the Reddit graph's CSR: first, as
    # no profiler may run before their host side is timed
    pending = (halo_cases(args, sg, gen) if wants(*halo_names) else []) + (
        segsum_cases(args, g, gen) if wants(*segsum_names) else [])
    if pending:
        small_passes(args, rows, pending, counts)
        del pending
        torch.cuda.empty_cache()
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
    if sharded:
        sharded_step(args, rows, sg)

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
    if sg is not None and wants(*slot_cases[5:]):
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
