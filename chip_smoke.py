"""Drive the PyTorch port (dorylus_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: torch.cuda must see one; print nvidia-smi's name and power
     limit;
  2. build the six CUDA libraries from ops/csrc/ with nvcc, one process
     each, started together; report which pair miner the host has;
  3. K1 (hybrid-ELL static mode) vs its plain PyTorch version on the card,
     forward and dh, at the Reddit shape (V=232,965, avg in-degree 50,
     degree-ascending renumbering: graph.build_graph, then reorder) for F=128 and
     F=41 in f32 and bf16, then on a small power-law graph with hub chunk
     rows and the `inv` output layout; times of both at the Reddit shape;
  3b. K2 (mask mode) the same way: apply_unit and apply_dst forward, dh and
     d_dst;
  3c. K3 (CSR SpMM), K4 (SDDMM) and K5 (sorted segment-sum) vs their plain
     versions at the Reddit shape (F=128 and 41, f32 and bf16 tables, times
     of both) and on a power-law graph with rows of 0 and > 1,000 edges;
     then every kernel refuses float16 and float64 and counts no launch;
  3d. K7 (dynamic values, fused SDDMM) vs its plain version at the Reddit
     shape (F=128 and 41, f32 and bf16: forward, dh and dval, times of
     both), then on the power-law hub graph;
  3e. the degree pass on degree plans (K1 static, K2 unit/dst, K7 dynamic)
     vs the plain degree pass at the Reddit shape (times of both), then on
     a power-law graph with isolated rows and rows of > 1,000 edges;
  3f. K6 (the pair-table build) vs plain, exactly, on the mined
     Reddit-scale community graph (COMMUNITY below): the passes=2
     levels and the engine's passes=1 forward and backward levels (its pair
     budget), F=128 and 41, f32 and bf16; then the mask pass over the
     rewritten plans (forward and dh, F=128 and 41, bf16 and f32) against
     the plain pass and against the pass over the original graph;
  3g. (run first of the phase-3 group, while the partition is at hand) the
     sharded engine's kernels on rank 0's shard of the 4-way range
     partition of the Reddit-shaped graph: K8 (the two-table pass through
     the fused entries: forward, dh, dghosts, d_dst; static and mask,
     F=128 and 41, f32 and bf16) vs plain, and on a power-law graph whose
     hubs sit near the cut; K9 (row gather) bit for bit and K10 (gathered
     sorted segment-sum) vs plain at that shard's send lists on both
     wires; times of kernel, plain and the one PyTorch call. One process,
     no collective;
  4. main path, GCN: Engine.run() of the Reddit-config GCN (602-128-41,
     kernel="hyb", bf16 gather tables) for 3 epochs; losses finite and
     falling, K1 launches > 0; then a torch.profiler table of 10 train
     steps (device time by kernel, the device's idle share), as for 4b;
  4b. main path, GAT: the Reddit-config GAT (kernel="hyb", bf16 gather,
     lr 0.005) for 3 epochs; losses finite and falling, K2 launches > 0,
     predict() finite (V, 41);
  4c. the edgewise path at full size: GCN and GAT with kernel="xla" for 3
     epochs in f32, each against the same model on kernel="hyb" with f32
     aggregation (the same sums in another order: loss rtol 1e-4); K3
     launches > 0, and K4 and K5 for GAT;
  4d. main path, kernel="degree": the Reddit-config GCN and GAT with bf16
     gather tables for 3 epochs; losses finite and GCN's falling, degree
     launches > 0; then both in f32 against 4c's hyb f32 runs (loss rtol
     1e-4);
  4e. main path, reuse="pairs": the Reddit-scale community graph, GCN and
     GAT on hyb with reuse="pairs" and with reuse="off", bf16, 3 epochs;
     the miner, mining seconds, pairs, row cut, warm epoch and train step
     times; K6 and K2 launches > 0; reuse vs off losses within rtol 1e-2
     (bf16 pair rows round once, not twice);
  4f. main path, dynamic values: the Reddit-config GCN on ops without
     static values (a dynamic HybSpMM, then a DegreeSpMM), bf16, 3 Adam
     steps through the model's `apply(h, edge_val)` branch; K7 launches
     > 0, losses finite and falling, and equal to the static-value path's
     to rtol 1e-4 (both round each weight and product to bf16);
  5. a planted 2,000-vertex graph, GCN on hyb, 10 epochs on the card and on
     the CPU (f32 aggregation): loss trajectories agree to atol 1e-3;
  5b. the same graph for GAT on hyb and for the default config (kernel
     "auto" -> xla) of GCN and GAT: relative agreement, rtol 1e-5 (GAT's
     losses are O(100) at init);
  5c. card vs CPU for GCN and GAT on kernel="degree" (the planted graph,
     10 epochs) and on reuse="pairs" (the 4,000-vertex community graph,
     passes=2, 3 epochs): relative agreement, rtol 1e-5;
  6. the sharded engine at full width: 4 ranks on the card over gloo (one
     process per shard, rank = shard id; the parent partitions once and
     hands each rank its shard file), Reddit-config GCN then GAT on
     kernel="hyb" with the fused-overlap plan, the exact wire and bf16
     gather tables, 3 epochs each: losses finite, GCN's falling, K8, K9,
     K10 and K1/K2 launches > 0 on every rank; per-rank edges, ghosts,
     max_h, wire bytes per exchange, warm epoch, train step and exchange
     ms, kernel time and idle share. Then both in f32 against 4c's
     single-device hyb f32 losses (rtol 1e-4), and GCN with overlap off
     (the combined plan) against the fused plan (rtol 1e-5);
  6b. the planted 2,000-vertex graph, 4 ranks on the card against 4 ranks
     on the CPU, GCN (10 epochs) and GAT (3): rtol 1e-5; predict() in
     global order against the single-device engine's;
  6c. only where torch.cuda.device_count() >= 2: phase 6's GCN over NCCL,
     one rank per card; else one line says the NCCL path was not run.
Each main path runs with every launch count set to 0 just before it and
read just after (in each rank, for the sharded engine). Then one JSON line
with the kernels' numbers (K1-K10, and the degree pass and the reuse pass,
the TPU kernels that run on K1/K2 and K6 + K2): beside each kernel's time
its plain version's, its bound (the bytes it must move over 3.35 TB/s, or
its operations over 67 TFLOP/s of f32, whichever is larger, from this
run's inputs) and, where one PyTorch call computes the same function, that
call's time (a yardstick only: the port never calls it). Last, the
contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Tolerances (max abs error over max |plain|): f32 1e-4; bf16 1e-2 (the
kernels round each bf16 product as the plain versions do, so only the
summation order differs); K6 and K9 bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
REDDIT = dict(v=232_965, deg=50, feat=602, classes=41)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The largest max abs error each kernel showed in any comparison.
MAX_ERR = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
                            "degree", "reuse")}
# The community graph the JAX package's bench measures pair reuse on.
COMMUNITY = dict(comm=400, core=60, p_core=0.85, seed=0)
# The card's published peaks (H100 SXM): device memory rate, and f32 outside
# the tensor cores (the gather kernels multiply and add in f32 registers).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RANKS = 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call of fn over `iters` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the f32 rate, whichever is larger."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(nbytes), "bound_flops": int(flops)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def live_slots(plan: dict) -> int:
    """Live slots of a hyb plan (buckets and hub top) or of a degree plan:
    the rows one pass gathers."""
    parts = [plan["part"]] if "part" in plan else list(plan["buckets"])
    if plan.get("top") is not None:
        parts.append(plan["top"])
    return sum(int(p["cnt"].sum()) for p in parts)


def pass_bound(table_rows: int, f: int, elt: int, live: int, out_rows: int,
               slot_bytes: int, extra_bytes: int = 0) -> dict:
    """Bound of one slot pass: the table once, every live slot's index (and
    value), the f32 output once; two operations per gathered element."""
    return bound(table_rows * f * elt + live * slot_bytes + out_rows * f * 4 + extra_bytes,
                 2.0 * live * f)


def library_ms(fn, label: str):
    """Time of one PyTorch call that computes a kernel's function, or None
    with the reason printed where this PyTorch build refuses the call."""
    try:
        return cuda_ms(fn, 10)
    except (RuntimeError, NotImplementedError) as e:
        print(f"library call {label}: not available here "
              f"({str(e).splitlines()[0][:120]})", flush=True)
        return None


def randn(gen: torch.Generator, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


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


def close(res: dict, kernel: str, key: str, got: torch.Tensor, ref: torch.Tensor,
          dtype: str) -> None:
    """Record and check max abs error against TOL[dtype] * max|ref|; the
    kernel's MAX_ERR entry takes it unless kernel is None (a comparison of
    two kernel results, not of a kernel with its plain version)."""
    check(bool(torch.isfinite(got).all()), f"{res['case']} {key}: non-finite output")
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    res[f"{key}_max_abs_err"] = err
    res[f"{key}_rel_err"] = err / scale if scale else err
    if kernel is not None:
        MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    check(err <= TOL[dtype] * scale,
          f"{res['case']} F={res['F']} {dtype} {key}: max abs err {err:.3e} > "
          f"{TOL[dtype]:.0e} * max|ref| {scale:.3e}")


def csr_pattern(src, dst, num_out: int) -> dict:
    """Row offsets and columns (int32, on the card) of dst-sorted edges."""
    dst_t = torch.as_tensor(np.asarray(dst), device="cuda").long()
    row_ptr = torch.zeros(num_out + 1, dtype=torch.int64, device="cuda")
    row_ptr[1:] = torch.cumsum(torch.bincount(dst_t, minlength=num_out), 0)
    return {"row_ptr": row_ptr.int(), "col": torch.as_tensor(np.asarray(src),
                                                             device="cuda").int()}


def spmm_library(res: dict, csr: dict, values: torch.Tensor, shape, h: torch.Tensor,
                 dt: torch.dtype) -> None:
    """The yardstick of the SpMM kernels: `torch.sparse.mm` of the CSR
    matrix (these values) with h, in the kernel's table dtype
    (`library_ms`) and, where that is bf16, in f32 too (`library_f32_ms`)."""
    for key, d in (("library_ms", dt), ("library_f32_ms", torch.float32)):
        if key == "library_f32_ms" and dt == torch.float32:
            break
        a = torch.sparse_csr_tensor(csr["row_ptr"], csr["col"], values.to(d), size=shape)
        x = h.to(d)
        res[key] = library_ms(lambda: torch.sparse.mm(a, x), f"torch.sparse.mm {d}")
        del a, x


def compare(name: str, op, f: int, seed: int, timed: bool, csr: dict | None = None) -> dict:
    """K1 (op.apply_static and its backward) vs hyb_static_pass_plain on the
    same CUDA tensors; gout is random (data-dependent)."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_static_pass, hyb_static_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, op.num_in, f)
    gout = randn(gen, op.num_out, f)
    hk = h.clone().requires_grad_(True)
    out_k = op.apply_static(hk)
    out_k.backward(gout)
    gd = op.gather_dtype
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": "K1", "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    close(res, "K1", "fwd", out_k.detach(), hyb_static_pass_plain(h, op.fwd, op.num_out, gd),
          dtype)
    close(res, "K1", "bwd", hk.grad,
          hyb_static_pass_plain(gout, op.bwd, op.num_in, gd)[: h.shape[0]], dtype)
    if timed:
        res["fwd_ms"] = cuda_ms(lambda: hyb_static_pass(h, op.fwd, op.num_out, gd), 20)
        res["fwd_plain_ms"] = cuda_ms(
            lambda: hyb_static_pass_plain(h, op.fwd, op.num_out, gd), 5)
        res["bwd_ms"] = cuda_ms(lambda: hyb_static_pass(gout, op.bwd, op.num_in, gd), 20)
        res["bwd_plain_ms"] = cuda_ms(
            lambda: hyb_static_pass_plain(gout, op.bwd, op.num_in, gd), 5)
        elt = 2 if gd is torch.bfloat16 else 4
        res.update(pass_bound(op.num_in, f, elt, live_slots(op.fwd), op.num_out, 4 + elt))
        spmm_library(res, csr, csr["norm"], (op.num_out, op.num_in), h, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_mask(name: str, op, f: int, seed: int, timed: bool,
                 csr: dict | None = None) -> dict:
    """K2: apply_unit (forward, dh) and apply_dst (forward, dh, d_dst) vs
    hyb_mask_pass_plain and the torch row scale / row-dot around it."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_mask_pass, hyb_mask_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, op.num_in, f)
    gout = randn(gen, op.num_out, f)
    dst_val = randn(gen, op.num_out)
    gd = op.gather_dtype
    hu = h.clone().requires_grad_(True)
    out_u = op.apply_unit(hu)
    out_u.backward(gout)
    hd = h.clone().requires_grad_(True)
    dd = dst_val.clone().requires_grad_(True)
    out_d = op.apply_dst(hd, dd)
    out_d.backward(gout)
    u = hyb_mask_pass_plain(h, op.fwd, op.num_out, gd)
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": "K2", "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    n = h.shape[0]
    close(res, "K2", "unit_fwd", out_u.detach(), u, dtype)
    close(res, "K2", "unit_bwd", hu.grad,
          hyb_mask_pass_plain(gout, op.bwd, op.num_in, gd)[:n], dtype)
    close(res, "K2", "dst_fwd", out_d.detach(), u * dst_val[:, None], dtype)
    close(res, "K2", "dst_bwd", hd.grad,
          hyb_mask_pass_plain(gout * dst_val[:, None], op.bwd, op.num_in, gd)[:n], dtype)
    close(res, "K2", "d_dst", dd.grad, (u * gout).sum(-1), dtype)
    if timed:
        res["fwd_ms"] = cuda_ms(lambda: hyb_mask_pass(h, op.fwd, op.num_out, gd), 20)
        res["fwd_plain_ms"] = cuda_ms(
            lambda: hyb_mask_pass_plain(h, op.fwd, op.num_out, gd), 5)
        res["bwd_ms"] = cuda_ms(lambda: hyb_mask_pass(gout, op.bwd, op.num_in, gd), 20)
        res["bwd_plain_ms"] = cuda_ms(
            lambda: hyb_mask_pass_plain(gout, op.bwd, op.num_in, gd), 5)
        elt = 2 if gd is torch.bfloat16 else 4
        res.update(pass_bound(op.num_in, f, elt, live_slots(op.fwd), op.num_out, 4))
        spmm_library(res, csr, csr["ones"], (op.num_out, op.num_in), h, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_edge(name: str, eop, src, dst, val, f: int, dtype: str, seed: int,
                 timed: bool) -> dict:
    """K3 (forward and dh through spmm_edgewise), K4 (dval) and K5 ((E,) and
    (E, F) cotangents) vs their plain versions on the same CUDA tensors."""
    from dorylus_tpu_torch.ops import spmm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = DTYPES[dtype]
    h = randn(gen, eop.num_in, f, dtype=dt)
    gout = randn(gen, eop.num_out, f, dtype=dt)
    # Through autograd (K3 forward and dh, K4 dval); the K3 sums are then
    # held against the plain version in f32, before the cast to h's dtype.
    hk = h.clone().requires_grad_(True)
    vk = val.clone().requires_grad_(True)
    out = spmm.spmm_edgewise(hk, src, dst, vk, eop.num_out, op=eop)
    out.backward(gout)
    res = {"case": name, "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    check(bool(torch.isfinite(out).all() and torch.isfinite(hk.grad).all()),
          f"{name} F={f} {dtype}: non-finite edgewise output or dh")
    del out, hk
    close(res, "K3", "K3_fwd", spmm.csr_spmm(h, eop.row_ptr, src, val),
          spmm.csr_spmm_plain(h, eop.row_ptr, src, val), dtype)
    close(res, "K3", "K3_bwd", spmm.csr_spmm(gout, eop.t_row_ptr, eop.t_col, val, eop.order),
          spmm.csr_spmm_plain(gout, eop.t_row_ptr, eop.t_col, val, eop.order), dtype)
    close(res, "K4", "K4", vk.grad, spmm.sddmm_plain(h, gout, eop.row_ptr, src), dtype)
    g_vec = randn(gen, eop.num_edges)
    close(res, "K5", "K5_vec", spmm.segment_sum(g_vec, eop.row_ptr),
          spmm.segment_sum_plain(g_vec, eop.row_ptr), "float32")
    g_mat = randn(gen, eop.num_edges, f, dtype=dt)
    close(res, "K5", "K5_mat", spmm.segment_sum(g_mat, eop.row_ptr),
          spmm.segment_sum_plain(g_mat, eop.row_ptr), dtype)
    if timed:
        for key, kern, plain, iters in (
            ("K3_fwd", lambda: spmm.csr_spmm(h, eop.row_ptr, src, val),
             lambda: spmm.csr_spmm_plain(h, eop.row_ptr, src, val), 20),
            ("K3_bwd", lambda: spmm.csr_spmm(gout, eop.t_row_ptr, eop.t_col, val, eop.order),
             lambda: spmm.csr_spmm_plain(gout, eop.t_row_ptr, eop.t_col, val, eop.order), 20),
            ("K4", lambda: spmm.sddmm(h, gout, eop.row_ptr, src),
             lambda: spmm.sddmm_plain(h, gout, eop.row_ptr, src), 20),
            ("K5_vec", lambda: spmm.segment_sum(g_vec, eop.row_ptr),
             lambda: spmm.segment_sum_plain(g_vec, eop.row_ptr), 20),
            ("K5_mat", lambda: spmm.segment_sum(g_mat, eop.row_ptr),
             lambda: spmm.segment_sum_plain(g_mat, eop.row_ptr), 20),
        ):
            res[f"{key}_ms"] = cuda_ms(kern, iters)
            res[f"{key}_plain_ms"] = cuda_ms(plain, 3)
        e, elt = eop.num_edges, h.element_size()
        out = spmm.csr_spmm(h, eop.row_ptr, src, val)
        res["K3"] = bound(nbytes(h, eop.row_ptr, src, val, out), 2.0 * e * f)
        res["K4"] = bound(nbytes(h, gout, eop.row_ptr, src) + 4 * e, 2.0 * e * f)
        res["K5"] = bound(nbytes(g_vec, eop.row_ptr) + 4 * eop.num_out, e)
        del out
        csr = {"row_ptr": eop.row_ptr, "col": src}
        shape = (eop.num_out, eop.num_in)
        lib = {}
        spmm_library(lib, csr, val, shape, h, dt)
        res["K3"].update(lib)
        if dt == torch.float32:
            pattern = torch.sparse_csr_tensor(eop.row_ptr, src, torch.ones_like(val), size=shape)
            ht = h.t()
            res["K4"]["library_ms"] = library_ms(
                lambda: torch.sparse.sampled_addmm(pattern, gout, ht, beta=0.0),
                "torch.sparse.sampled_addmm float32")
            del pattern
        dst_l = dst.long()
        res["K5"]["library_ms"] = library_ms(
            lambda: torch.zeros(eop.num_out, device="cuda").index_add_(0, dst_l, g_vec),
            "index_add_")
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_dyn(name: str, op, f: int, seed: int, timed: bool,
                csr: dict | None = None) -> dict:
    """K7: op.apply (forward, dh, dval through its backward) vs
    hyb_dynamic_pass_plain on the same CUDA tensors; val is random per
    edge."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_dynamic_pass, hyb_dynamic_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, op.num_in, f)
    gout = randn(gen, op.num_out, f)
    val = randn(gen, op.fwd["n_edges"])
    gd = op.gather_dtype
    hk = h.clone().requires_grad_(True)
    vk = val.clone().requires_grad_(True)
    out = op.apply(hk, vk)
    out.backward(gout)
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": "K7", "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    close(res, "K7", "fwd", out.detach(),
          hyb_dynamic_pass_plain(h, op.fwd, op.num_out, val, gd), dtype)
    del out
    ref_dh, ref_dval = hyb_dynamic_pass_plain(gout, op.bwd, op.num_in, val, gd, other=h)
    close(res, "K7", "dh", hk.grad, ref_dh[: h.shape[0]], dtype)
    close(res, "K7", "dval", vk.grad, ref_dval, dtype)
    del ref_dh, ref_dval, hk, vk
    if timed:
        res["fwd_ms"] = cuda_ms(lambda: hyb_dynamic_pass(h, op.fwd, op.num_out, val, gd), 20)
        res["fwd_plain_ms"] = cuda_ms(
            lambda: hyb_dynamic_pass_plain(h, op.fwd, op.num_out, val, gd), 3)
        res["bwd_ms"] = cuda_ms(
            lambda: hyb_dynamic_pass(gout, op.bwd, op.num_in, val, gd, other=h), 20)
        res["bwd_plain_ms"] = cuda_ms(
            lambda: hyb_dynamic_pass_plain(gout, op.bwd, op.num_in, val, gd, other=h), 3)
        # forward: a row index and an edge id per live slot, each value once
        elt = 2 if gd is torch.bfloat16 else 4
        res.update(pass_bound(op.num_in, f, elt, live_slots(op.fwd), op.num_out, 8,
                              extra_bytes=nbytes(val)))
        spmm_library(res, csr, val, (op.num_out, op.num_in), h, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def compare_degree(name: str, op, f: int, seed: int, timed: bool,
                   csr: dict | None = None) -> dict:
    """The degree pass on degree plans: K1 (apply_static), K2 (apply_dst:
    forward, dh, d_dst) and K7 (apply: forward, dh, dval) vs
    degree_pass_plain and the torch row scale / row-dot around it."""
    from dorylus_tpu_torch.ops.degree_spmm import degree_pass, degree_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, op.num_in, f)
    gout = randn(gen, op.num_out, f)
    val = randn(gen, op.fwd["n_edges"])
    dst_val = randn(gen, op.num_out)
    gd = op.gather_dtype
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": "degree", "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    n = h.shape[0]

    def plain(table, plan, num, mode, other=None):
        return degree_pass_plain(table, plan, num, gd, mode, val, other)

    hs = h.clone().requires_grad_(True)
    out = op.apply_static(hs)
    out.backward(gout)
    close(res, "degree", "static_fwd", out.detach(), plain(h, op.fwd, op.num_out, "static"),
          dtype)
    close(res, "degree", "static_bwd", hs.grad,
          plain(gout, op.bwd, op.num_in, "static")[:n], dtype)
    del out, hs
    hd = h.clone().requires_grad_(True)
    dd = dst_val.clone().requires_grad_(True)
    out = op.apply_dst(hd, dd)
    out.backward(gout)
    u = plain(h, op.fwd, op.num_out, "mask")
    close(res, "degree", "dst_fwd", out.detach(), u * dst_val[:, None], dtype)
    close(res, "degree", "dst_bwd", hd.grad,
          plain(gout * dst_val[:, None], op.bwd, op.num_in, "mask")[:n], dtype)
    close(res, "degree", "d_dst", dd.grad, (u * gout).sum(-1), dtype)
    del out, hd, dd, u
    hy = h.clone().requires_grad_(True)
    vy = val.clone().requires_grad_(True)
    out = op.apply(hy, vy)
    out.backward(gout)
    close(res, "degree", "dyn_fwd", out.detach(), plain(h, op.fwd, op.num_out, "dynamic"),
          dtype)
    del out
    ref_dh, ref_dval = plain(gout, op.bwd, op.num_in, "dynamic", other=h)
    close(res, "degree", "dyn_dh", hy.grad, ref_dh[:n], dtype)
    close(res, "degree", "dyn_dval", vy.grad, ref_dval, dtype)
    del ref_dh, ref_dval, hy, vy
    if timed:
        for key, mode, iters in (("static", "static", 20), ("mask", "mask", 20),
                                 ("dyn", "dynamic", 20)):
            res[f"{key}_fwd_ms"] = cuda_ms(
                lambda: degree_pass(h, op.fwd, op.num_out, gd, mode, val), iters)
            res[f"{key}_fwd_plain_ms"] = cuda_ms(
                lambda: plain(h, op.fwd, op.num_out, mode), 3)
        res["static_bwd_ms"] = cuda_ms(
            lambda: degree_pass(gout, op.bwd, op.num_in, gd, "static"), 20)
        res["static_bwd_plain_ms"] = cuda_ms(
            lambda: plain(gout, op.bwd, op.num_in, "static"), 3)
        res["dyn_bwd_ms"] = cuda_ms(
            lambda: degree_pass(gout, op.bwd, op.num_in, gd, "dynamic", val, h), 20)
        res["dyn_bwd_plain_ms"] = cuda_ms(
            lambda: plain(gout, op.bwd, op.num_in, "dynamic", h), 3)
        elt = 2 if gd is torch.bfloat16 else 4
        res.update(pass_bound(op.num_in, f, elt, live_slots(op.fwd), op.num_out, 4 + elt))
        spmm_library(res, csr, csr["norm"], (op.num_out, op.num_in), h, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def compare_pairs(name: str, levels, table_size: int, v: int, f: int, dtype: str,
                  seed: int) -> dict:
    """K6: the pair table built by the kernel equals the plain build bit
    for bit (each pair row is one f32 add rounded once to the table's
    dtype in both); times of both, and per level."""
    from dorylus_tpu_torch.ops.reuse_spmm import build_pair_table, build_pair_table_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, v, f, dtype=DTYPES[dtype])
    tbl = build_pair_table(h, levels, table_size)
    ref = build_pair_table_plain(h, levels)
    err = float((tbl.float() - ref.float()).abs().max())
    MAX_ERR["K6"] = max(MAX_ERR["K6"], err)
    check(tbl.shape == (table_size, f) and torch.equal(tbl, ref),
          f"{name} {dtype}: K6 table differs from the plain build (max abs err {err:.3e})")
    res = {"case": name, "kernel": "K6", "F": f, "dtype": dtype, "levels": len(levels),
           "pairs": [int(p.shape[0]) for p in levels], "max_abs_err": err,
           "ms": cuda_ms(lambda: build_pair_table(h, levels, table_size), 20),
           "plain_ms": cuda_ms(lambda: build_pair_table_plain(h, levels), 5)}
    from dorylus_tpu_torch.ops import reuse_spmm

    base = v
    level_ms = []
    for p in levels:
        level_ms.append(cuda_ms(lambda: reuse_spmm._launch_level(tbl, p, base), 20))
        base += p.shape[0]
    res["level_ms"] = level_ms
    # every pair row reads two table rows and writes one; h is copied once
    pairs = sum(int(p.shape[0]) for p in levels)
    res.update(bound(2 * nbytes(h) + nbytes(*levels) + 3 * pairs * f * h.element_size(),
                     pairs * f))
    a, b = levels[0][:, 0].long(), levels[0][:, 1].long()
    res["library_ms"] = library_ms(lambda: h.index_select(0, a) + h.index_select(0, b),
                                   "index_select + add (first level)")
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_reuse(rop, hop, v: int, f: int, gd, seed: int) -> dict:
    """The reuse pass: K2 over the K6-built table of the rewritten plan,
    forward and dh, vs the plain mask pass on the same tables, and vs K2
    over the original graph (the same sums; a bf16 pair row rounds once, not
    twice); times of both and of the unrewritten pass."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_mask_pass, hyb_mask_pass_plain
    from dorylus_tpu_torch.ops.reuse_spmm import build_pair_table

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, v, f)
    gout = randn(gen, v, f)
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": "community", "kernel": "reuse", "F": f, "dtype": dtype,
           "tol_rel": TOL[dtype]}
    tbl = build_pair_table(h, rop.lvl_fwd, rop.fwd_table_size)
    out = hyb_mask_pass(tbl, rop.fwd, v, gd)
    close(res, "reuse", "vs_plain", out, hyb_mask_pass_plain(tbl, rop.fwd, v, gd), dtype)
    close(res, None, "vs_unrewritten", out, hyb_mask_pass(h, hop.fwd, v, gd), dtype)
    gtbl = build_pair_table(gout, rop.lvl_bwd, rop.bwd_table_size)
    dh = hyb_mask_pass(gtbl, rop.bwd, v, gd)
    close(res, "reuse", "bwd_vs_plain", dh, hyb_mask_pass_plain(gtbl, rop.bwd, v, gd), dtype)
    close(res, None, "bwd_vs_unrewritten", dh, hyb_mask_pass(gout, hop.bwd, v, gd), dtype)
    del out, dh, gtbl
    res["fwd_ms"] = cuda_ms(lambda: hyb_mask_pass(tbl, rop.fwd, v, gd), 20)
    res["fwd_plain_ms"] = cuda_ms(lambda: hyb_mask_pass_plain(tbl, rop.fwd, v, gd), 3)
    res["unrewritten_fwd_ms"] = cuda_ms(lambda: hyb_mask_pass(h, hop.fwd, v, gd), 20)
    if gd is rop.gather_dtype:
        res["unit_fwd_ms"] = cuda_ms(lambda: rop.apply_unit(h), 20)  # K6 + K2
    elt = 2 if gd is torch.bfloat16 else 4
    res.update(pass_bound(rop.fwd_table_size, f, elt, live_slots(rop.fwd), v, 4))
    csr = csr_pattern(rop.plan_fwd.src, rop.plan_fwd.dst, v)
    spmm_library(res, csr, torch.ones(csr["col"].shape[0], device="cuda"),
                 (v, rop.fwd_table_size), tbl, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    return res


def gcn_steps(layers, op, batch, steps: int, lr: float = 0.01) -> tuple[list, float, dict, dict]:
    """Train steps of the port's GCN on `op` through the model's loss,
    autograd and the reference Adam (what Engine._train_epoch runs): the
    losses before each update, then the ms of one more step by CUDA events
    (mean of 5, after the counted steps), the launch counts so far and one
    step's launches."""
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.models.gcn import GCN
    from dorylus_tpu_torch.optim.adam import adam_init, adam_update

    model = GCN(layers, spmm_op=op)
    params = model.init_params(seed=TrainConfig().seed)
    state = adam_init(params)
    losses = []

    def step():
        nonlocal params, state
        loss = model.loss(batch)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        params, state = adam_update(params, grads, state, lr=lr)
        return loss

    for _ in range(steps):
        losses.append(float(step()))
    ms = cuda_ms(step, 5)
    counts = launch_counts()  # of the run so far, before the one-step count
    return losses, ms, counts, step_launches(step)


def refuses_bad_input(op, eop, rop, fop) -> None:
    """Every kernel launcher raises on a float16 or float64 table and counts
    no launch; none falls back to its plain version. op: a dynamic
    HybSpMM with static values; rop: a ReuseSpMM with at least one level;
    fop: a fused ShardedHybSpMM with static values and a mixed bucket."""
    from dorylus_tpu_torch.ops import hyb_sharded, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    part = op.fwd["buckets"][0]
    out = torch.zeros((op.num_out, 8), device="cuda")
    e = eop.num_edges
    col = eop.t_col
    val = torch.ones(e, device="cuda")
    fpart = fop.fwd["buckets"][fop.n_pure]
    fout = torch.zeros((fop.vp, 8), device="cuda")
    idx = torch.zeros(4, dtype=torch.int32, device="cuda")
    before = launch_counts()
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((op.num_in, 8), dtype=bad, device="cuda")
        calls = {
            "K1": lambda: hyb_spmm._launch_part(tb, part, out),
            "K2": lambda: hyb_spmm._launch_part(tb, part, out, unit=True),
            "K3": lambda: spmm._launch_csr_spmm(tb, eop.row_ptr, col, val, None, out),
            "K4": lambda: spmm._launch_sddmm(tb, tb, eop.row_ptr, col,
                                             torch.zeros(e, device="cuda")),
            "K5": lambda: spmm._launch_segment_sum(val.to(bad), eop.row_ptr,
                                                   torch.zeros(eop.num_out, device="cuda")),
            "K6": lambda: reuse_spmm._launch_level(
                torch.zeros((rop.fwd_table_size, 8), dtype=bad, device="cuda"),
                rop.lvl_fwd[0], rop.num_in),
            "K7": lambda: hyb_spmm._launch_dyn_part(
                tb, part, torch.ones(op.fwd["n_edges"], device="cuda"), out),
            "K8": lambda: hyb_sharded._launch_fused_part(
                torch.zeros((fop.vp, 8), dtype=bad, device="cuda"),
                torch.zeros((fop.table - fop.vp, 8), dtype=bad, device="cuda"),
                fpart, fout, unit=False),
            "K9": lambda: halo._launch_row_gather(
                tb, idx, torch.zeros((4, 8), dtype=bad, device="cuda")),
            "K10": lambda: halo._launch_segsum(
                tb, idx, torch.zeros(op.num_out + 1, dtype=torch.int32, device="cuda"), out),
        }
        for kernel, call in calls.items():
            try:
                call()
            except ValueError as err:
                print(f"{kernel} refused {bad}: {err}", flush=True)
            else:
                fail(f"{kernel} launcher accepted a {bad} table")
    check(launch_counts() == before, "a refused call counted a launch")


def launch_counts() -> dict:
    from dorylus_tpu_torch.ops import degree_spmm, hyb_sharded, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    return {"K1": hyb_spmm.KERNEL_LAUNCHES, "K2": hyb_spmm.MASK_LAUNCHES,
            "K3": spmm.SPMM_LAUNCHES, "K4": spmm.SDDMM_LAUNCHES,
            "K5": spmm.SEGSUM_LAUNCHES, "K6": reuse_spmm.PAIR_LAUNCHES,
            "K7": hyb_spmm.DYN_LAUNCHES, "K8": hyb_sharded.FUSED_LAUNCHES,
            "K9": halo.PACK_LAUNCHES, "K10": halo.HALO_BWD_LAUNCHES,
            "degree": degree_spmm.DEGREE_LAUNCHES}


def reset_counts() -> None:
    from dorylus_tpu_torch.ops import degree_spmm, hyb_sharded, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    hyb_spmm.KERNEL_LAUNCHES = hyb_spmm.MASK_LAUNCHES = hyb_spmm.DYN_LAUNCHES = 0
    spmm.SPMM_LAUNCHES = spmm.SDDMM_LAUNCHES = spmm.SEGSUM_LAUNCHES = 0
    reuse_spmm.PAIR_LAUNCHES = degree_spmm.DEGREE_LAUNCHES = 0
    hyb_sharded.FUSED_LAUNCHES = halo.PACK_LAUNCHES = halo.HALO_BWD_LAUNCHES = 0


def step_launches(step) -> dict:
    """Kernel launches of one call of `step` (a train step: loss, backward,
    Adam), the non-zero counts only."""
    reset_counts()
    step()
    torch.cuda.synchronize()
    return {k: n for k, n in launch_counts().items() if n}


def train(g, layers, cfg, label: str):
    """Engine.run() on the card with every launch count set to 0 just
    before; returns (engine, report, launch counts read just after)."""
    from dorylus_tpu_torch.engine.engine import Engine

    reset_counts()
    t0 = time.perf_counter()
    eng = Engine(g, layers, cfg, device="cuda")
    print(f"{label}: engine built in {time.perf_counter() - t0:.2f} s", flush=True)
    rep = eng.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [e.loss for e in rep.epochs]
    print(f"{label}: losses {json.dumps(losses)} epoch ms "
          f"{json.dumps([e.time_ms for e in rep.epochs])} val acc "
          f"{rep.final_accuracy} launches {json.dumps(counts)}", flush=True)
    check(all(np.isfinite(losses)), f"{label}: non-finite training loss")
    return eng, rep, counts


def main_path(g, layers, cfg, label: str, kernel: str) -> tuple[dict, dict]:
    """A Reddit-config run: falling finite losses, its kernel
    launched, finite (V, C) predictions; warm epoch and train step ms."""
    eng, rep, counts = train(g, layers, cfg, label)
    losses = [e.loss for e in rep.epochs]
    check(losses[-1] < losses[0], f"{label}: training loss did not fall")
    check(counts[kernel] > 0, f"{label}: the main path launched no {kernel}")
    logits = eng.predict()
    check(logits.shape == (g.num_vertices, layers.dims[-1])
          and bool(np.isfinite(logits).all()),
          f"{label}: predict gave {logits.shape} or non-finite values")
    warm_epoch_ms = float(np.mean([e.time_ms for e in rep.epochs][1:]))
    # train step alone (loss, backward, Adam; no eval), for comparison with
    # bench.py's eval_every=0 epochs
    step_ms = cuda_ms(lambda: eng._train_epoch(cfg.learning_rate), 5)
    per_step = step_launches(lambda: eng._train_epoch(cfg.learning_rate))
    print(f"{label} warm epoch (with eval) {warm_epoch_ms:.3f} ms, train step "
          f"{step_ms:.3f} ms, launches per train step {json.dumps(per_step)}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_steps(eng, cfg, label)
    del eng
    torch.cuda.empty_cache()
    return counts, {"warm_epoch_ms": warm_epoch_ms, "step_ms": step_ms,
                    "launches_per_step": per_step}


def profile_steps(eng, cfg, label: str, steps: int = 10) -> None:
    """torch.profiler over `steps` train steps: device time by kernel, and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    eng._train_epoch(cfg.learning_rate)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._train_epoch(cfg.learning_rate)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Kernel rows only: an op's row repeats its kernels' device time.
    kernels = [(getattr(e, "self_device_time_total", 0.0), e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(t for t, _ in kernels) / 1e3
    print(f"profile {label}: {steps} steps, wall {wall_ms / steps:.3f} ms/step, "
          f"kernel time {busy_ms / steps:.3f} ms/step, device idle share "
          f"{1 - busy_ms / wall_ms:.3f}", flush=True)
    for t, key in sorted(kernels, reverse=True)[:12]:
        print(f"  {t / 1e3 / steps:9.3f} ms/step  {key[:100]}", flush=True)


def planted_pair(gp, layers, cfg, label: str) -> float:
    """Losses of the same config on the card and on the CPU: max relative
    gap."""
    from dorylus_tpu_torch.engine.engine import Engine

    gpu_l = np.array([e.loss for e in Engine(gp, layers, cfg, device="cuda").run().epochs])
    cpu_l = np.array([e.loss for e in Engine(gp, layers, cfg, device="cpu").run().epochs])
    gap = float(np.max(np.abs(gpu_l - cpu_l) / np.abs(cpu_l)))
    print(f"card vs CPU, {label}: max relative loss gap {gap:.3e} over "
          f"{len(cpu_l)} epochs (gpu {gpu_l[0]:.5f} -> {gpu_l[-1]:.5f})", flush=True)
    return gap


def community_graph(v: int, deg: int, feat: int, classes: int, **kw):
    """A community-core graph (graph.community_core_edges) with random
    features and block labels, as the JAX package's bench builds it."""
    from dorylus_tpu_torch.graph.graph import Graph, community_core_edges

    src, dst = community_core_edges(v, deg, **kw)
    rng = np.random.default_rng(4)
    return Graph(num_vertices=v, src=src, dst=dst,
                 features=rng.normal(0, 0.3, size=(v, feat)).astype(np.float32),
                 labels=((np.arange(v) * classes) // v).astype(np.int32),
                 num_classes=classes).finalize()


def compare_fused(name: str, op, f: int, seed: int, timed: bool,
                  csr: dict | None = None) -> dict:
    """K8 through the fused entries of a ShardedHybSpMM (edges="fused"):
    forward, dh and dghosts (and d_dst in mask mode, through
    apply_dst_fused) vs the plain two-table pass and the plain pass over
    the transpose plan, on the same CUDA tensors. csr (where timed): the
    shard's edges as a (vp, table) CSR pattern with its `norm` and `ones`
    values and `src_rows`, the distinct table rows its edges read."""
    from dorylus_tpu_torch.ops import hyb_sharded
    from dorylus_tpu_torch.ops.hyb_spmm import _hyb_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    vp, ng = op.vp, op.table - op.vp
    h, gh, gout = randn(gen, vp, f), randn(gen, ng, f), randn(gen, vp, f)
    dst_val = randn(gen, vp)
    gd = op.gather_dtype
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    mode = "static" if op.has_static_vals else "mask"
    res = {"case": name, "kernel": "K8", "mode": mode, "F": f, "dtype": dtype,
           "tol_rel": TOL[dtype], "n_pure": op.n_pure,
           "pure_edges": op.pure_edges, "mixed_edges": op.mixed_edges}
    hk, gk, dk = (t.clone().requires_grad_(True) for t in (h, gh, dst_val))
    before = hyb_sharded.FUSED_LAUNCHES
    out = op.apply_static_fused(hk, gk) if mode == "static" else op.apply_dst_fused(hk, gk, dk)
    out.backward(gout)
    check(hyb_sharded.FUSED_LAUNCHES > before, f"{name}: the fused entry launched no K8")
    u = hyb_sharded.fused_pass_plain(h, gh, op.fwd, op.n_pure, gd, mode)
    scale = 1.0 if mode == "static" else dst_val[:, None]
    close(res, "K8", "fwd", out.detach(), u * scale, dtype)
    dfull = _hyb_pass_plain(gout * scale, op.bwd, op.table, gd, mode)
    close(res, "K8", "dh", hk.grad, dfull[:vp], dtype)
    close(res, "K8", "dghosts", gk.grad, dfull[vp:], dtype)
    if mode == "mask":
        close(res, "K8", "d_dst", dk.grad, (u * gout).sum(-1), dtype)
    del out, hk, gk, dk, dfull, u
    if timed:
        res["fwd_ms"] = cuda_ms(
            lambda: hyb_sharded.fused_pass(h, gh, op.fwd, op.n_pure, gd, mode), 20)
        res["fwd_plain_ms"] = cuda_ms(
            lambda: hyb_sharded.fused_pass_plain(h, gh, op.fwd, op.n_pure, gd, mode), 3)
        # the backward is K1/K2 over the transpose plan into one buffer
        res["bwd_ms"] = cuda_ms(lambda: op._pass(gout, op.bwd, op.table, mode), 20)
        elt = 2 if gd is torch.bfloat16 else 4
        # the pass reads the rows its edges address, not the whole padded
        # ghost layout (the rank's own block and the slots past each pair's
        # exact count are never read)
        res["table_rows_read"] = csr["src_rows"]
        res.update(pass_bound(csr["src_rows"], f, elt, live_slots(op.fwd), vp,
                              4 + (elt if mode == "static" else 0)))
        # the same function in one call: the shard's (vp, table) matrix
        # times the concatenated table (joined outside the timed call)
        spmm_library(res, csr, csr["norm" if mode == "static" else "ones"], (vp, op.table),
                     torch.cat([h, gh]), DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def compare_halo(name: str, plan, f: int, dtype: str, seed: int, timed: bool) -> dict:
    """K9 (the pack, and on the exact wire the placement) against the plain
    gather, bit for bit; K10 against the plain segment-sum; at one rank's
    HaloPlan. No collective runs: the received and returned rows are
    random."""
    from dorylus_tpu_torch.parallel import halo

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = DTYPES[dtype]
    h = randn(gen, plan.vp, f, dtype=dt)
    res = {"case": name, "wire": plan.wire, "F": f, "dtype": dtype,
           "pack_rows": int(plan.pack.shape[0])}
    buf = halo.row_gather(h, plan.pack)
    ref = halo.row_gather_plain(h, plan.pack)
    check(torch.equal(buf, ref), f"{name} {plan.wire} F={f} {dtype}: K9 pack differs from plain")
    MAX_ERR["K9"] = max(MAX_ERR["K9"], float((buf.float() - ref.float()).abs().max()))
    recv = None
    if plan.place is not None:
        recv = randn(gen, int(plan.recv_cnt.sum()), f, dtype=dt)
        placed = halo.row_gather(recv, plan.place)
        check(torch.equal(placed, halo.row_gather_plain(recv, plan.place))
              and not bool(placed[plan.place < 0].any()),
              f"{name} F={f} {dtype}: K9 placement differs from plain or fills a dead slot")
        del placed
    back = randn(gen, int(plan.pack.shape[0]), f, dtype=dt)
    dh = halo.segsum_gather(back, plan.order, plan.rows, plan.row_ptr, plan.vp)
    close(res, "K10", "K10", dh, halo.segsum_gather_plain(back, plan.order, plan.rows, plan.vp),
          "float32")
    del buf, ref, dh
    if timed:
        res["K9_ms"] = cuda_ms(lambda: halo.row_gather(h, plan.pack), 20)
        res["K9_plain_ms"] = cuda_ms(lambda: halo.row_gather_plain(h, plan.pack), 5)
        if recv is not None:
            res["K9_place_ms"] = cuda_ms(lambda: halo.row_gather(recv, plan.place), 20)
        res["K10_ms"] = cuda_ms(
            lambda: halo.segsum_gather(back, plan.order, plan.rows, plan.row_ptr, plan.vp),
            20)
        res["K10_plain_ms"] = cuda_ms(
            lambda: halo.segsum_gather_plain(back, plan.order, plan.rows, plan.vp), 5)
        s_rows, row_b = int(plan.pack.shape[0]), f * h.element_size()
        # the padded wire's pad slots (-1) read nothing and return nothing
        live = plan.pack >= 0
        live_l = plan.pack[live].long()
        n_live, uniq = int(live_l.numel()), int(torch.unique(live_l).numel())
        res["live_rows"] = n_live
        # K9 reads each distinct row once and writes every packed row; K10
        # reads every live returned row once and writes every local row in f32.
        res["K9"] = bound(uniq * row_b + 4 * s_rows + s_rows * row_b, 0)
        res["K10"] = bound(n_live * row_b + 4 * n_live + 4 * (plan.vp + 1) + plan.vp * f * 4,
                           n_live * f)
        back_live = back[live]
        res["K9"]["library_ms"] = library_ms(lambda: h.index_select(0, live_l), "index_select")
        res["K10"]["library_ms"] = library_ms(
            lambda: torch.zeros((plan.vp, f), device="cuda").index_add_(0, live_l,
                                                                        back_live.float()),
            "index_add_")
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def sharded_rank(rank: int, world: int, device, shard_dir: str, runs: list) -> list:
    """One rank of the sharded phases (started by multihost.spawn_local):
    for each run, a ShardedEngine on this rank's shard file, trained with
    this process's launch counts set to 0 just before and read just after;
    where the run is timed, also the train step's ms and launches, the
    halo exchange's ms at each layer width, and a profile of the step."""
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel import multihost
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    on_card = torch.device(device).type == "cuda"
    if not on_card:
        torch.set_num_threads(2)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = []
    for run in runs:
        shard, meta = load_shard(f"{shard_dir}/{run['shards']}_{rank}.npz")
        cfg = TrainConfig(**run["cfg"])
        reset_counts()
        t0 = time.perf_counter()
        eng = ShardedEngine((shard, meta), LayerConfig(run["dims"]), cfg, device=device)
        build_s = time.perf_counter() - t0
        rep = eng.run()
        sync()
        row = {"label": run["label"], "rank": rank, "backend": multihost.backend_name(),
               "device": str(eng.device), "launches": launch_counts(),
               "losses": [e.loss for e in rep.epochs],
               "epoch_ms": [e.time_ms for e in rep.epochs], "val_acc": rep.final_accuracy,
               "build_s": build_s, "kernel": eng.kernel_selected,
               "overlap": bool(eng.cfg.overlap), "wire": eng.halo_plan.wire,
               "local_vertices": shard.num_local, "edges": shard.num_edges,
               "ghosts": int(eng.halo_plan.recv_cnt.sum()), "max_h": meta.max_h,
               "wire_rows": eng.halo_plan.wire_rows(rank)}
        op = eng.model.spmm_split
        if op is not None:
            row.update(n_pure=op.n_pure, pure_edges=op.pure_edges, mixed_edges=op.mixed_edges)
        lr = cfg.learning_rate
        if run.get("timed"):
            row["launches_per_step"] = step_launches(lambda: eng._train_epoch(lr))
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                eng._train_epoch(lr)
            sync()
            row["step_ms"] = 1e3 * (time.perf_counter() - t0) / 3
            row["exchange_ms"] = {}
            elt = torch.empty((), dtype=eng.compute_dtype).element_size()
            for f in run["dims"][1:]:
                h = torch.zeros((meta.vp, f), dtype=eng.compute_dtype, device=device)
                eng.halo(h)
                sync()
                t0 = time.perf_counter()
                for _ in range(3):
                    eng.halo(h)
                sync()
                row["exchange_ms"][str(f)] = 1e3 * (time.perf_counter() - t0) / 3
                row.setdefault("wire_bytes", {})[str(f)] = row["wire_rows"] * f * elt
            row["profile"] = profile_rank(eng, lr)
        if run.get("predict"):
            row["predict"] = eng.predict()
        del eng
        if on_card:
            torch.cuda.empty_cache()
        out.append(row)
    return out


def profile_rank(eng, lr: float, steps: int = 3) -> dict:
    """torch.profiler over `steps` train steps of this rank: its kernels'
    device time per step, its staging copies' apart, and the share of the
    wall time in which neither ran on its behalf (the collective on the
    host and the waits on peers count as idle)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._train_epoch(lr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(getattr(e, "self_device_time_total", 0.0), e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # The staging copies of the exchanges (device <-> pinned host) are
    # device rows too: kept apart from the kernels.
    copy_ms = sum(t for t, key in rows if key.startswith(("Memcpy", "Memset"))) / 1e3
    busy_ms = sum(t for t, _ in rows) / 1e3
    return {"wall_ms_per_step": wall_ms / steps,
            "kernel_ms_per_step": (busy_ms - copy_ms) / steps,
            "copy_ms_per_step": copy_ms / steps, "idle_share": 1 - busy_ms / wall_ms,
            "top": [[round(t / 1e3 / steps, 4), key[:60]]
                    for t, key in sorted(rows, reverse=True)[:6]]}


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def sharded_phases(sg, layers, hyb_f32_losses, kernel_sources) -> dict:
    """Phases 6, 6b and 6c. sg: the Reddit-shaped graph's 4-way partition;
    hyb_f32_losses: {model: 3 single-device hyb f32 losses} from
    phase 4c. Returns what the kernels line needs."""
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.graph.graph import synthetic_graph
    from dorylus_tpu_torch.graph.partition import ShardMeta, partition_graph, save_shard
    from dorylus_tpu_torch.ops import cuda_build
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    # The ranks load the libraries the parent built: nothing compiles there.
    cuda_build.compile_sources(kernel_sources)
    shard_dir = tempfile.mkdtemp(prefix="dorylus_smoke_shards_")
    try:
        t0 = time.perf_counter()
        meta = ShardMeta.of(sg)
        for s in sg.shards:
            save_shard(f"{shard_dir}/reddit_{s.shard_id}.npz", s, meta)
        gp = synthetic_graph(2000, 8, REDDIT["feat"], REDDIT["classes"], seed=8888)
        sgp = partition_graph(gp, RANKS)
        for s in sgp.shards:
            save_shard(f"{shard_dir}/planted_{s.shard_id}.npz", s, ShardMeta.of(sgp))
        print(f"shard files: {time.perf_counter() - t0:.1f} s", flush=True)
        dims = list(layers.dims)

        def run(label, shards, timed=False, predict=False, **cfg):
            cfg = dict(dict(epochs=3, eval_every=1, kernel="hyb", reuse="off"), **cfg)
            return {"label": label, "shards": shards, "dims": dims, "cfg": cfg,
                    "timed": timed, "predict": predict}

        gat = dict(model="gat", learning_rate=0.005)
        # 6. the Reddit config on 4 ranks of the one card. (Both models read
        # the same shard files: a GAT partition differs only in edge values
        # of 1, which the hyb path never reads.)
        runs = [run("gcn bf16 fused", "reddit", timed=True, agg_dtype="bfloat16"),
                run("gat bf16 fused", "reddit", timed=True, agg_dtype="bfloat16", **gat),
                run("gcn f32 fused", "reddit"),
                run("gat f32 fused", "reddit", **gat),
                run("gcn f32 combined", "reddit", overlap=False)]
        t0 = time.perf_counter()
        res = spawn_local(RANKS, sharded_rank, (shard_dir, runs), backend="gloo",
                          device="cuda:0", timeout_s=600)
        print(f"phase 6: {RANKS} ranks on cuda:0 over gloo, {len(runs)} runs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        by_label = {r["label"]: [res[k][i] for k in range(RANKS)] for i, r in enumerate(runs)}
        launches = {}
        timings = {}
        for label, rows in by_label.items():
            for r in rows:
                print(f"sharded {label} rank {r['rank']}: " + json.dumps(
                    {k: v for k, v in r.items() if k not in ("label", "rank")}), flush=True)
                check(all(np.isfinite(r["losses"])), f"{label} rank {r['rank']}: non-finite loss")
                check(r["losses"] == rows[0]["losses"],
                      f"{label}: rank {r['rank']} reports other losses than rank 0")
                check((r["kernel"], r["wire"]) == ("hyb", "ragged"),
                      f"{label}: ran kernel {r['kernel']} on the {r['wire']} wire")
                want = ["K9", "K10", "K2" if "gat" in label else "K1"]
                want += ["K8"] if r["overlap"] else []
                for k in want:
                    check(r["launches"][k] > 0, f"{label} rank {r['rank']}: no {k} launch")
                check(r["overlap"] == ("combined" not in label), f"{label}: overlap {r['overlap']}")
            if "gcn" in label:
                check(rows[0]["losses"][-1] < rows[0]["losses"][0], f"{label}: loss did not fall")
            if "bf16" in label:
                model = label.split()[0]
                for k in ("K1", "K2", "K8", "K9", "K10"):
                    launches[k] = launches.get(k, 0) + sum(r["launches"][k] for r in rows)
                timings[model] = {
                    "warm_epoch_ms": float(np.mean(rows[0]["epoch_ms"][1:])),
                    "step_ms": [r["step_ms"] for r in rows],
                    "launches_per_step": [r["launches_per_step"] for r in rows],
                    "exchange_ms": [r["exchange_ms"] for r in rows],
                    "wire_bytes": [r["wire_bytes"] for r in rows],
                    "kernel_ms_per_step": [r["profile"]["kernel_ms_per_step"] for r in rows],
                    "copy_ms_per_step": [r["profile"]["copy_ms_per_step"] for r in rows],
                    "idle_share": [r["profile"]["idle_share"] for r in rows]}
        for model in ("gcn", "gat"):
            gap = rel_gap(by_label[f"{model} f32 fused"][0]["losses"], hyb_f32_losses[model])
            print(f"sharded {model} f32 vs the single-device engine: max relative loss "
                  f"gap {gap:.3e}", flush=True)
            check(gap <= 1e-4, f"{model}: 4 ranks and one device differ by {gap:.3e} > 1e-4")
        gap = rel_gap(by_label["gcn f32 combined"][0]["losses"],
                      by_label["gcn f32 fused"][0]["losses"])
        print(f"sharded gcn f32, combined vs fused plan: max relative loss gap {gap:.3e}",
              flush=True)
        check(gap <= 1e-5, f"combined and fused plans differ by {gap:.3e} > 1e-5")

        # 6b. card vs CPU on the planted graph, and predict() in global order
        runs = [run("planted gcn", "planted", predict=True, epochs=10),
                run("planted gat", "planted", predict=True, **gat)]
        on_card = spawn_local(RANKS, sharded_rank, (shard_dir, runs), backend="gloo",
                              device="cuda:0", timeout_s=300)
        on_cpu = spawn_local(RANKS, sharded_rank, (shard_dir, runs), backend="gloo",
                             device="cpu", timeout_s=300)
        for i, r in enumerate(runs):
            gap = rel_gap(on_card[0][i]["losses"], on_cpu[0][i]["losses"])
            print(f"4 ranks on the card vs 4 on the CPU, {r['label']}: max relative loss gap "
                  f"{gap:.3e} over {len(on_cpu[0][i]['losses'])} epochs", flush=True)
            check(gap <= 1e-5, f"{r['label']}: card and CPU ranks differ by {gap:.3e} > 1e-5")
            single = Engine(gp, layers, TrainConfig(**r["cfg"]), device="cuda")
            single.run()
            want = single.predict()
            for k in range(RANKS):
                got = on_card[k][i]["predict"]
                err = float(np.abs(got - want).max()) / float(np.abs(want).max())
                check(got.shape == want.shape and err <= 1e-3,
                      f"{r['label']}: rank {k}'s predict() is {err:.3e} off the single-device "
                      "engine's")
            print(f"  predict() in global order vs the single-device engine: rel err {err:.3e}",
                  flush=True)

        # 6c. one rank per card over NCCL, where there are cards
        if torch.cuda.device_count() >= 2:
            n = min(RANKS, torch.cuda.device_count())
            check(n == RANKS, f"the NCCL phase needs {RANKS} cards, found {n}")
            runs = [run("gcn bf16 fused nccl", "reddit", timed=True, agg_dtype="bfloat16")]
            nres = spawn_local(RANKS, sharded_rank, (shard_dir, runs), backend="nccl",
                               device="cuda:{rank}", timeout_s=600)
            for k in range(RANKS):
                r = nres[k][0]
                print(f"sharded {r['label']} rank {k}: " + json.dumps(
                    {a: b for a, b in r.items() if a not in ("label", "rank")}), flush=True)
                check(r["backend"] == "nccl" and all(np.isfinite(r["losses"])),
                      f"nccl rank {k}: backend {r['backend']} or non-finite loss")
            gap = rel_gap(nres[0][0]["losses"], by_label["gcn bf16 fused"][0]["losses"])
            check(gap <= 1e-5, f"nccl and gloo runs differ by {gap:.3e} > 1e-5")
        else:
            print(f"nccl path not run: {torch.cuda.device_count()} card", flush=True)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    return {"launches": launches, "timings": timings}


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU to run on")
    try:
        from dorylus_tpu_torch import native
        from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
        from dorylus_tpu_torch.engine.batch import build_batch
        from dorylus_tpu_torch.engine.engine import (Engine, _max_agg_width,
                                                     resolve_reuse_budget)
        from dorylus_tpu_torch.graph.graph import Graph, build_graph, synthetic_graph
        from dorylus_tpu_torch.graph.partition import partition_graph
        from dorylus_tpu_torch.graph.reorder import apply_order, degree_order
        from dorylus_tpu_torch.graph.reuse import mine_reuse
        from dorylus_tpu_torch.ops import (cuda_build, degree_spmm, hyb_sharded, hyb_spmm,
                                           reuse_spmm, spmm)
        from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
        from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
        from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
        from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
        from dorylus_tpu_torch.ops.spmm import EdgeSpMM
        from dorylus_tpu_torch.parallel import halo
    except ImportError as e:
        fail(f"run from the root of a checkout that holds dorylus_tpu_torch ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)

    # 2. build the six libraries at once; the host's pair miner
    t0 = time.perf_counter()
    sources = [hyb_spmm._CSRC, spmm._CSRC, hyb_spmm._DYN_CSRC, reuse_spmm._CSRC,
               hyb_sharded._CSRC, halo._CSRC]
    try:
        info = cuda_build.compile_sources(sources)
        hyb_spmm.build_kernel()
        hyb_spmm.build_dyn_kernel()
        spmm.build_kernel()
        reuse_spmm.build_kernel()
        hyb_sharded.build_kernel()
        halo.build_kernel()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"kernel builds: {time.perf_counter() - t0:.2f} s wall", flush=True)
    for src, inf in info.items():
        print(f"  {src.name}: {inf['seconds']:.2f} s nvcc -> {inf['path']}", flush=True)
        for line in inf["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("    ptxas: " + line.strip(), flush=True)
    t0 = time.perf_counter()
    miner = "native" if native.has_mine_pairs() else "numpy"
    print(f"pair miner: {miner} ({time.perf_counter() - t0:.2f} s to load or build)",
          flush=True)

    # 3, 3b, 3d. K1, K2 and K7 vs plain
    t0 = time.perf_counter()
    g = build_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"], seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    print(f"reddit-shaped graph: V={v} E={g.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    layers = LayerConfig([REDDIT["feat"], 128, REDDIT["classes"]])

    # 3g. K8, K9, K10 vs plain on rank 0's shard of the 4-way partition
    t0 = time.perf_counter()
    sg = partition_graph(g, RANKS)
    print(f"{RANKS}-way range partition: vp {sg.vp}, max_h {sg.max_h}, edges per shard "
          f"{[s.num_edges for s in sg.shards]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    shard0 = sg.shards[0]
    ne0 = shard0.num_edges
    csr0 = csr_pattern(shard0.src[:ne0], shard0.dst[:ne0], sg.vp)
    csr0["norm"] = torch.tensor(shard0.edge_val[:ne0], device="cuda")
    csr0["ones"] = torch.ones_like(csr0["norm"])
    csr0["src_rows"] = int(np.unique(shard0.src[:ne0]).size)
    fused_results = []
    for gd in (torch.bfloat16, None):
        for static in (True, False):
            fop = ShardedHybSpMM(shard0, RANKS, edges="fused", static_vals=static,
                                 gather_dtype=gd, device="cuda")
            for f in (128, 41):
                fused_results.append(compare_fused(
                    "reddit_shard0", fop, f, seed=f + 20,
                    timed=gd is torch.bfloat16 or f == 128, csr=csr0))
            del fop
            torch.cuda.empty_cache()
    # hubs near the cut: a power-law graph, hash-partitioned, narrow buckets
    hsrc, hdst, _ = powerlaw_edges(20_000, seed=7)
    rng = np.random.default_rng(7)
    hub_sg = partition_graph(
        Graph(num_vertices=20_000, src=hsrc, dst=hdst,
              features=rng.normal(size=(20_000, 8)).astype(np.float32),
              labels=(np.arange(20_000) % 3).astype(np.int32), num_classes=3).finalize(),
        RANKS, method="hash")
    hub_fop = None
    for gd in (torch.bfloat16, None):
        for static in (True, False):
            fop = ShardedHybSpMM(hub_sg.shards[1], RANKS, edges="fused", static_vals=static,
                                 gather_dtype=gd, max_width=8, device="cuda")
            check(fop.n_pure > 0 and fop.fwd["top"] is not None
                  and len(fop.fwd["buckets"]) > fop.n_pure,
                  "the hub shard's fused plan lacks pure buckets, mixed buckets or a hub top")
            for f in (128, 41):
                fused_results.append(compare_fused("powerlaw_hub_shard", fop, f, seed=f + 21,
                                                   timed=False))
            if static and gd is None:
                hub_fop = fop
    del csr0
    # cnt[owner, receiver]: the exact ghost rows of each pair
    cnt = np.stack([halo.ghost_counts(s, RANKS, sg.vp, sg.max_h) for s in sg.shards], axis=1)
    counts0 = (cnt[0], cnt[:, 0])
    halo_results = []
    for wire in ("ragged", "padded"):
        plan0 = halo.HaloPlan(shard0, RANKS, wire, "cuda", counts=counts0)
        for dtype in ("float32", "bfloat16"):
            for f in (128, 41):
                halo_results.append(compare_halo("reddit_shard0", plan0, f, dtype, seed=f + 22,
                                                 timed=True))
        del plan0
    torch.cuda.empty_cache()

    csr = csr_pattern(g.src, g.dst, v)
    csr["norm"] = torch.tensor(g.edge_norm, device="cuda")
    csr["ones"] = torch.ones_like(csr["norm"])
    results = []
    for gd in (torch.bfloat16, None):
        t0 = time.perf_counter()
        # Static plans with the slot->edge maps: K1 reads their values, K2
        # only their live counts, K7 the per-edge values through s2e.
        op = HybSpMM(g.src, g.dst, v, v, gather_dtype=gd, static_val=g.edge_norm,
                     dynamic=True, device="cuda")
        print(f"plans ({gd}): fwd {len(op.fwd['buckets'])} buckets, top "
              f"{op.fwd['top'] is not None}, layout "
              f"{'n_iso' if 'n_iso' in op.fwd else 'inv'}; bwd layout "
              f"{'n_iso' if 'n_iso' in op.bwd else 'inv'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for f in (128, 41):
            # timed at the main path's shapes (bf16, both widths) and one f32
            timed = gd is torch.bfloat16 or f == 128
            results.append(compare("reddit", op, f, seed=f, timed=timed, csr=csr))
            results.append(compare_mask("reddit", op, f, seed=f + 2, timed=timed, csr=csr))
            results.append(compare_dyn("reddit", op, f, seed=f + 4, timed=timed, csr=csr))
        del op
        torch.cuda.empty_cache()
    src, dst, val = powerlaw_edges(20_000, seed=7)
    for gd in (torch.bfloat16, None):
        op = HybSpMM(src, dst, 20_000, 20_000, max_width=8, gather_dtype=gd,
                     static_val=val, dynamic=True, device="cuda")
        check(op.fwd["top"] is not None and "inv" in op.fwd and "inv" in op.bwd,
              "power-law plan lacks hub rows or the inv layout")
        for f in (128, 41):
            results.append(compare("powerlaw_hubs", op, f, seed=f + 1, timed=False))
            results.append(compare_mask("powerlaw_hubs", op, f, seed=f + 3, timed=False))
            results.append(compare_dyn("powerlaw_hubs", op, f, seed=f + 5, timed=False))
        del op
    torch.cuda.empty_cache()

    # 3c. K3, K4, K5 vs plain
    t0 = time.perf_counter()
    eop = EdgeSpMM(g.src, g.dst, v, v, device="cuda")
    print(f"edge CSR op: {time.perf_counter() - t0:.1f} s", flush=True)
    s_t = torch.tensor(g.src, device="cuda")
    d_t = torch.tensor(g.dst, device="cuda")
    v_t = torch.tensor(g.edge_norm, device="cuda")
    edge_results = []
    for dtype in ("float32", "bfloat16"):
        for f in (128, 41):
            edge_results.append(compare_edge("reddit", eop, s_t, d_t, v_t, f, dtype,
                                             seed=f + 5,
                                             timed=dtype == "float32" or f == 128))
            torch.cuda.empty_cache()
    del eop, s_t, d_t, v_t
    psrc, pdst, pval = powerlaw_edges(20_000, seed=9, empty=0.1)
    deg = np.bincount(pdst, minlength=20_000)
    check(deg.min() == 0 and deg.max() > 1000,
          f"power-law graph degrees {deg.min()}..{deg.max()}: want 0 and > 1,000")
    peop = EdgeSpMM(psrc, pdst, 20_000, 20_000, device="cuda")
    for dtype in ("float32", "bfloat16"):
        for f in (128, 41):
            compare_edge("powerlaw_rows", peop, torch.tensor(psrc, device="cuda"),
                         torch.tensor(pdst, device="cuda"),
                         torch.tensor(pval, device="cuda"), f, dtype, seed=f + 6,
                         timed=False)
    torch.cuda.empty_cache()

    # 3e. the degree pass on K1 / K2 / K7 vs the plain degree pass
    degree_results = []
    for gd in (torch.bfloat16, None):
        t0 = time.perf_counter()
        dop = DegreeSpMM(g.src, g.dst, v, v, gather_dtype=gd, static_val=g.edge_norm,
                         device="cuda")
        print(f"degree plans ({gd}): fwd {dop.fwd['part']['rows'].shape[0]} block rows "
              f"for {dop.fwd['part']['v'].shape[0]} vertices, live slots "
              f"{int(dop.fwd['part']['cnt'].sum())} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        for f in (128, 41):
            degree_results.append(compare_degree(
                "reddit", dop, f, seed=f + 7, timed=gd is torch.bfloat16 or f == 128, csr=csr))
        del dop
        torch.cuda.empty_cache()
    for gd in (torch.bfloat16, None):
        dop = DegreeSpMM(psrc, pdst, 20_000, 20_000, gather_dtype=gd, static_val=pval,
                         device="cuda")
        for f in (128, 41):
            degree_results.append(compare_degree("powerlaw_rows", dop, f, seed=f + 8,
                                                 timed=False))
        del dop

    # 3f. K6 on the mined Reddit-scale community levels; the reuse pass
    t0 = time.perf_counter()
    cg = community_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"],
                         **COMMUNITY)
    print(f"community graph: V={cg.num_vertices} E={cg.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cv = cg.num_vertices
    cap2, _ = resolve_reuse_budget(TrainConfig(agg_dtype="bfloat16", reuse="pairs",
                                               reuse_passes=2), cv, 128)
    t0 = time.perf_counter()
    plan2 = mine_reuse(cg.src, cg.dst, cv, min_uses=3, passes=2, max_pairs=cap2)
    print(f"mined passes=2 (cap {cap2}/pass, {miner}): levels "
          f"{[len(p) for p in plan2.levels]}, row cut "
          f"{plan2.stats['row_reduction']:.4f} ({time.perf_counter() - t0:.2f} s)", flush=True)
    check(len(plan2.levels) == 2, "passes=2 mined fewer than two levels")
    levels2 = [torch.tensor(p, device="cuda") for p in plan2.levels]
    reuse_cfg = TrainConfig(agg_dtype="bfloat16", reuse="pairs")
    cap1, _ = resolve_reuse_budget(reuse_cfg, cv, _max_agg_width(layers, reuse_cfg, cv))
    rop = ReuseSpMM(cg.src, cg.dst, cv, cv, gather_dtype=torch.bfloat16, max_pairs=cap1,
                    device="cuda")
    hop = HybSpMM(cg.src, cg.dst, cv, cv, gather_dtype=torch.bfloat16, device="cuda")
    st = rop.plan_fwd.stats
    print(f"reuse op (passes=1, cap {cap1}): {rop.plan_fwd.num_pairs} fwd pairs, rows "
          f"{st['rows_before']} -> {st['rows_after']} (cut {st['row_reduction']:.4f}), "
          f"mining {rop.mine_seconds[0]:.2f} + {rop.mine_seconds[1]:.2f} s", flush=True)
    # K6 at both widths the engines aggregate at (GCN and GAT: 128, then
    # 41) and in both dtypes (the engines build f32 tables: h, then
    # gout.float()), on the passes=2 levels and on the engine's passes=1
    # forward and backward levels.
    pair_results = []
    for case, lv, size in (("community_passes2", levels2, plan2.table_size),
                           ("community_passes1_fwd", list(rop.lvl_fwd), rop.fwd_table_size),
                           ("community_passes1_bwd", list(rop.lvl_bwd), rop.bwd_table_size)):
        for dtype in ("float32", "bfloat16"):
            for f in (128, 41):
                pair_results.append(compare_pairs(case, lv, size, cv, f, dtype, seed=11 + f))
    reuse_results = [compare_reuse(rop, hop, cv, f, gd, seed=13 + f)
                     for gd in (torch.bfloat16, None) for f in (128, 41)]
    ref_op = HybSpMM(psrc, pdst, 20_000, 20_000, max_width=8, static_val=pval,
                     dynamic=True, device="cuda")
    refuses_bad_input(ref_op, peop, rop, hub_fop)
    del rop, hop, ref_op, peop, levels2, hub_fop, csr
    torch.cuda.empty_cache()

    # 4. main path, GCN
    gcn_counts, gcn_times = main_path(
        g, layers, TrainConfig(epochs=3, eval_every=1, kernel="hyb",
                               agg_dtype="bfloat16", reuse="off"),
        "reddit-config GCN", "K1")
    # 4b. main path, GAT
    gat_counts, gat_times = main_path(
        g, layers, TrainConfig(epochs=3, eval_every=1, model="gat", kernel="hyb",
                               agg_dtype="bfloat16", learning_rate=0.005,
                               reuse="off"),
        "reddit-config GAT", "K2")

    # 4c. the edgewise path at full size, against hyb with f32 aggregation
    edge_counts = {}
    edge_times = {}
    edge_steps = {}
    hyb_f32_losses = {}
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        cfg = TrainConfig(epochs=3, eval_every=1, model=model, kernel="xla",
                          learning_rate=lr, reuse="off")
        eng, rep_x, counts = train(g, layers, cfg, f"reddit-config {model} xla")
        edge_times[model] = float(np.mean([e.time_ms for e in rep_x.epochs][1:]))
        edge_steps[model] = step_launches(lambda: eng._train_epoch(lr))
        del eng
        torch.cuda.empty_cache()
        for k in ("K3",) + (("K4", "K5") if model == "gat" else ()):
            check(counts[k] > 0, f"{model} xla: no {k} launch")
            edge_counts[k] = edge_counts.get(k, 0) + counts[k]
        eng, rep_h, _ = train(g, layers, dataclasses.replace(cfg, kernel="hyb"),
                              f"reddit-config {model} hyb f32")
        del eng
        torch.cuda.empty_cache()
        lx = np.array([e.loss for e in rep_x.epochs])
        lh = hyb_f32_losses[model] = np.array([e.loss for e in rep_h.epochs])
        gap = float(np.max(np.abs(lx - lh) / np.abs(lh)))
        print(f"reddit-config {model}: xla vs hyb max relative loss gap {gap:.3e}",
              flush=True)
        check(gap <= 1e-4, f"{model}: xla and hyb losses differ by {gap:.3e} > 1e-4")

    # 4d. main path, kernel="degree"
    degree_counts = 0
    degree_times = {}
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        cfg = TrainConfig(epochs=3, eval_every=1, model=model, kernel="degree",
                          agg_dtype="bfloat16", learning_rate=lr, reuse="off")
        label = f"reddit-config {model} degree bf16"
        eng, rep, counts = train(g, layers, cfg, label)
        check(counts["degree"] > 0, f"{label}: the main path launched no degree pass")
        check(counts["K1" if model == "gcn" else "K2"] > 0, f"{label}: no K1/K2 launch")
        losses = [e.loss for e in rep.epochs]
        check(model == "gat" or losses[-1] < losses[0], f"{label}: loss did not fall")
        degree_counts += counts["degree"]
        degree_times[model] = {
            "warm_epoch_ms": float(np.mean([e.time_ms for e in rep.epochs][1:])),
            "step_ms": cuda_ms(lambda: eng._train_epoch(lr), 5),
            "launches_per_step": step_launches(lambda: eng._train_epoch(lr))}
        print(f"{label}: {json.dumps(degree_times[model])}", flush=True)
        del eng
        torch.cuda.empty_cache()
        eng, rep32, _ = train(g, layers, dataclasses.replace(cfg, agg_dtype="float32"),
                              f"reddit-config {model} degree f32")
        del eng
        torch.cuda.empty_cache()
        ld = np.array([e.loss for e in rep32.epochs])
        gap = float(np.max(np.abs(ld - hyb_f32_losses[model]) / np.abs(hyb_f32_losses[model])))
        print(f"reddit-config {model}: degree vs hyb f32 max relative loss gap {gap:.3e}",
              flush=True)
        check(gap <= 1e-4, f"{model}: degree and hyb losses differ by {gap:.3e} > 1e-4")

    # 4e. main path, reuse="pairs" on the Reddit-scale community graph
    reuse_counts = {"K6": 0, "K2": 0}
    reuse_times = {}
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        runs = {}
        for reuse in ("pairs", "off"):
            cfg = TrainConfig(epochs=3, eval_every=1, model=model, kernel="hyb",
                              agg_dtype="bfloat16", learning_rate=lr, reuse=reuse)
            label = f"community {model} reuse={reuse}"
            eng, rep, counts = train(cg, layers, cfg, label)
            row = {"warm_epoch_ms": float(np.mean([e.time_ms for e in rep.epochs][1:])),
                   "step_ms": cuda_ms(lambda: eng._train_epoch(lr), 5),
                   "launches_per_step": step_launches(lambda: eng._train_epoch(lr))}
            if reuse == "pairs":
                op = eng.model.spmm_op
                check(isinstance(op, ReuseSpMM), f"{label}: the engine built no reuse op")
                check(counts["K6"] > 0 and counts["K2"] > 0,
                      f"{label}: K6 {counts['K6']} / K2 {counts['K2']} launches")
                reuse_counts["K6"] += counts["K6"]
                reuse_counts["K2"] += counts["K2"]
                st = op.plan_fwd.stats
                row.update(miner=op.miner, mine_s=list(op.mine_seconds),
                           fwd_pairs=op.plan_fwd.num_pairs, bwd_pairs=op.plan_bwd.num_pairs,
                           row_cut=st["row_reduction"])
            runs[reuse] = ([e.loss for e in rep.epochs], row)
            print(f"{label}: {json.dumps(row)}", flush=True)
            del eng
            torch.cuda.empty_cache()
        lp, lo = np.array(runs["pairs"][0]), np.array(runs["off"][0])
        gap = float(np.max(np.abs(lp - lo) / np.abs(lo)))
        print(f"community {model}: reuse vs off max relative loss gap {gap:.3e}", flush=True)
        check(gap <= 1e-2, f"community {model}: reuse and off differ by {gap:.3e} > 1e-2")
        reuse_times[model] = {k: r for k, (_, r) in runs.items()}

    # 4f. main path, dynamic values: GCN on ops without static values
    batch = build_batch(g, "cuda")  # with the COO arrays: apply reads edge_val
    dyn_counts = 0
    dyn_times = {}
    static_l = None
    for kind_, make in (("hyb-static", lambda: HybSpMM(g.src, g.dst, v, v,
                                                        gather_dtype=torch.bfloat16,
                                                        static_val=g.edge_norm,
                                                        device="cuda")),
                        ("hyb-dynamic", lambda: HybSpMM(g.src, g.dst, v, v,
                                                         gather_dtype=torch.bfloat16,
                                                         dynamic=True, device="cuda")),
                        ("degree-dynamic", lambda: DegreeSpMM(g.src, g.dst, v, v,
                                                              gather_dtype=torch.bfloat16,
                                                              device="cuda"))):
        op = make()
        reset_counts()
        losses, step_ms, counts, per_step = gcn_steps(layers, op, batch, steps=3)
        print(f"reddit-config GCN, {kind_} op: losses {json.dumps(losses)} train step "
              f"{step_ms:.3f} ms, launches per train step {json.dumps(per_step)}", flush=True)
        dyn_times[kind_] = {"step_ms": step_ms, "launches_per_step": per_step}
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{kind_}: losses {losses} not finite and falling")
        if kind_ == "hyb-static":
            static_l = np.array(losses)
        else:
            check(counts["K7"] > 0, f"{kind_}: the main path launched no K7")
            dyn_counts += counts["K7"]
            gap = float(np.max(np.abs(np.array(losses) - static_l) / np.abs(static_l)))
            print(f"  {kind_} vs hyb-static max relative loss gap {gap:.3e}", flush=True)
            check(gap <= 1e-4, f"{kind_}: losses differ from the static path by {gap:.3e}")
        del op
        torch.cuda.empty_cache()
    del batch

    # 5, 5b, 5c. card vs CPU on small graphs
    gp = synthetic_graph(2000, 8, REDDIT["feat"], REDDIT["classes"], seed=8888)
    cfg = TrainConfig(epochs=10, eval_every=1, kernel="hyb", reuse="off")
    gpu_l = [e.loss for e in Engine(gp, layers, cfg, device="cuda").run().epochs]
    cpu_l = [e.loss for e in Engine(gp, layers, cfg, device="cpu").run().epochs]
    gap = float(np.max(np.abs(np.array(gpu_l) - np.array(cpu_l))))
    print(f"planted graph card vs CPU: max loss gap {gap:.3e} over 10 epochs "
          f"(gpu {gpu_l[0]:.5f} -> {gpu_l[-1]:.5f})", flush=True)
    check(gap <= 1e-3, f"card and CPU trajectories differ by {gap:.3e} > 1e-3")
    gs = community_graph(4000, 20, REDDIT["feat"], REDDIT["classes"], comm=40, core=30,
                         p_core=0.85, seed=0)
    for graph, model, kernel, reuse in ((gp, "gat", "hyb", "off"), (gp, "gcn", "auto", "off"),
                                        (gp, "gat", "auto", "off"),
                                        (gp, "gcn", "degree", "off"),
                                        (gp, "gat", "degree", "off"),
                                        (gs, "gcn", "hyb", "pairs"),
                                        (gs, "gat", "hyb", "pairs")):
        # 3 epochs on the community graph: GAT's trajectory there splits
        # into two modes by epoch 7 (losses 2.131 and 2.144), and gradient
        # errors 100x below f32 rounding decide which a run takes. The card,
        # the JAX package on the CPU and a float64 run take one, the port on
        # the CPU the other, with reuse and without it (PERF.md §7).
        cfg = TrainConfig(epochs=3 if graph is gs else 10, eval_every=1, model=model,
                          kernel=kernel, reuse=reuse, reuse_passes=2,
                          learning_rate=0.005 if model == "gat" else 0.01)
        rgap = planted_pair(graph, layers, cfg, f"{model} {kernel} reuse={reuse}")
        check(rgap <= 1e-5, f"{model} {kernel} reuse={reuse}: card and CPU differ by "
                            f"{rgap:.3e} relative > 1e-5")

    # 6, 6b, 6c. the sharded engine: 4 ranks on the card
    torch.cuda.empty_cache()
    sharded = sharded_phases(sg, layers, hyb_f32_losses, sources)

    def pick(rows, **kw):
        return next(r for r in rows if all(r.get(k) == x for k, x in kw.items()))

    k1 = pick(results, kernel="K1", case="reddit", dtype="bfloat16", F=128)
    k2 = pick(results, kernel="K2", case="reddit", dtype="bfloat16", F=128)
    k7 = pick(results, kernel="K7", case="reddit", dtype="bfloat16", F=128)
    kd = pick(degree_results, case="reddit", dtype="bfloat16", F=128)
    # K6 as the reuse engines run it: f32 tables over the passes=1 levels.
    k6 = pick(pair_results, case="community_passes1_fwd", dtype="float32", F=128)
    kr = pick(reuse_results, dtype="bfloat16", F=128)
    # The edgewise main path (4c) runs f32 tables at F = 128 (layer 0).
    ke = pick(edge_results, dtype="float32", F=128)
    # The sharded main path (6): GCN's static pass, bf16 tables, F = 128;
    # the exchange on the exact wire in the compute dtype (f32).
    k8 = pick(fused_results, case="reddit_shard0", mode="static", dtype="bfloat16", F=128)
    kh = pick(halo_results, wire="ragged", dtype="float32", F=128)

    def lib(r):
        ms = r.get("library_ms")
        return ms if ms is not None else r.get("library_f32_ms")

    # name, source, TPU kernel, launches on the main path, ms, plain ms, and
    # the row that holds the bound and the library call's time
    src_dir = "dorylus_tpu_torch/ops/csrc/"
    entry = {
        "K1": ("hyb_static_pass", "hyb_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:392",
               gcn_counts["K1"], k1["fwd_ms"], k1["fwd_plain_ms"], k1),
        "K2": ("hyb_mask_pass", "hyb_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:508",
               gat_counts["K2"], k2["fwd_ms"], k2["fwd_plain_ms"], k2),
        "K3": ("csr_spmm", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:21",
               edge_counts["K3"], ke["K3_fwd_ms"], ke["K3_fwd_plain_ms"], ke["K3"]),
        "K4": ("sddmm", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:74",
               edge_counts["K4"], ke["K4_ms"], ke["K4_plain_ms"], ke["K4"]),
        "K5": ("segment_sum", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:185",
               edge_counts["K5"], ke["K5_vec_ms"], ke["K5_vec_plain_ms"], ke["K5"]),
        "K6": ("pair_build", "pair_build.cu", "dorylus_tpu/ops/reuse_spmm.py:37",
               reuse_counts["K6"], k6["ms"], k6["plain_ms"], k6),
        "K7": ("hyb_dynamic_pass", "dyn_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:476",
               dyn_counts, k7["fwd_ms"], k7["fwd_plain_ms"], k7),
        "K8": ("fused_pass", "fused_spmm.cu", "dorylus_tpu/ops/hyb_sharded.py:501",
               sharded["launches"]["K8"], k8["fwd_ms"], k8["fwd_plain_ms"], k8),
        "K9": ("halo_row_gather", "halo.cu", "dorylus_tpu/parallel/halo.py:118",
               sharded["launches"]["K9"], kh["K9_ms"], kh["K9_plain_ms"], kh["K9"]),
        "K10": ("halo_segsum", "halo.cu", "dorylus_tpu/parallel/halo.py:132",
                sharded["launches"]["K10"], kh["K10_ms"], kh["K10_plain_ms"], kh["K10"]),
        "degree": ("degree_pass", "hyb_spmm.cu", "dorylus_tpu/ops/degree_spmm.py:132",
                   degree_counts, kd["static_fwd_ms"], kd["static_fwd_plain_ms"], kd),
        "reuse": ("reuse_unit_pass", "hyb_spmm.cu", "dorylus_tpu/ops/reuse_spmm.py:47",
                  reuse_counts["K2"], kr["fwd_ms"], kr["fwd_plain_ms"], kr),
    }
    kernels = [{"name": name, "route": "cuda", "source": src_dir + source,
                "replaces": replaces, "launches": launches, "max_abs_err": MAX_ERR[k],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": lib(row)}
               for k, (name, source, replaces, launches, ms, plain_ms, row) in entry.items()]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its main path")
    print("timings " + json.dumps({"gcn_hyb_bf16": gcn_times, "gat_hyb_bf16": gat_times,
                                   "xla_f32_warm_epoch_ms": edge_times,
                                   "xla_f32_launches_per_step": edge_steps,
                                   "degree_bf16": degree_times,
                                   "community_bf16": reuse_times,
                                   "gcn_value_ops_bf16": dyn_times,
                                   "sharded_4_ranks_bf16": sharded["timings"]}), flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:]:
        fail(f"usage: python3 chip_smoke.py (got {sys.argv[1:]})")
    main()
