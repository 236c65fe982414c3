"""Drive the PyTorch port (dorylus_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: torch.cuda must see one; print nvidia-smi's name and power
     limit;
  2. build the four CUDA libraries from ops/csrc/ with nvcc, one process
     each, started together; report which pair miner the host has;
  3. K1 (hybrid-ELL static mode) vs its plain PyTorch version on the card,
     forward and dh, at the Reddit shape (V=232,965, avg in-degree 50,
     degree-ascending renumbering, as bench.py builds it) for F=128 and
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
     Reddit-scale community graph (`bench.py:274-283`): the passes=2
     levels and the engine's passes=1 forward and backward levels (its pair
     budget), F=128 and 41, f32 and bf16; then the mask pass over the
     rewritten plans (forward and dh, F=128 and 41, bf16 and f32) against
     the plain pass and against the pass over the original graph;
  4. main path, GCN: Engine.run() of the Reddit-config GCN (602-128-41,
     kernel="hyb", bf16 gather tables) for 5 epochs; losses finite and
     falling, K1 launches > 0; then a torch.profiler table of 10 train
     steps (device time by kernel, the device's idle share), as for 4b;
  4b. main path, GAT: the Reddit-config GAT (kernel="hyb", bf16 gather,
     lr 0.005) for 5 epochs; losses finite and falling, K2 launches > 0,
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
     passes=2, 3 epochs): relative agreement, rtol 1e-5.
Each main path runs with every launch count set to 0 just before it and
read just after. Then one JSON line with the kernels' numbers (K1-K7, and
the degree pass and the reuse pass, the TPU kernels that run on K1/K2 and
K6 + K2) and, last, the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Tolerances (max abs error over max |plain|): f32 1e-4; bf16 1e-2 (the
kernels round each bf16 product as the plain versions do, so only the
summation order differs).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
REDDIT = dict(v=232_965, deg=50, feat=602, classes=41)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The largest max abs error each kernel showed in any comparison.
MAX_ERR = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "degree", "reuse")}
COMMUNITY = dict(comm=400, core=60, p_core=0.85, seed=0)  # bench.py:274-283


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


def compare(name: str, op, f: int, seed: int, timed: bool) -> dict:
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
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_mask(name: str, op, f: int, seed: int, timed: bool) -> dict:
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
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_dyn(name: str, op, f: int, seed: int, timed: bool) -> dict:
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
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def compare_degree(name: str, op, f: int, seed: int, timed: bool) -> dict:
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
    print("compare " + json.dumps(res), flush=True)
    return res


def gcn_steps(layers, op, batch, steps: int, lr: float = 0.01) -> tuple[list, float]:
    """Train steps of the port's GCN on `op` through the model's loss,
    autograd and the reference Adam (what Engine._train_epoch runs): the
    losses before each update, then the ms of one more step by CUDA events
    (mean of 5, after the counted steps)."""
    from dorylus_tpu.common.config import TrainConfig
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
    return losses, cuda_ms(step, 5)


def refuses_bad_input(op, eop, rop) -> None:
    """Every kernel launcher raises on a float16 or float64 table and counts
    no launch; none falls back to its plain version. op: a dynamic
    HybSpMM with static values; rop: a ReuseSpMM with at least one level."""
    from dorylus_tpu_torch.ops import hyb_spmm, reuse_spmm, spmm

    part = op.fwd["buckets"][0]
    out = torch.zeros((op.num_out, 8), device="cuda")
    e = eop.num_edges
    col = eop.t_col
    val = torch.ones(e, device="cuda")
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
    from dorylus_tpu_torch.ops import degree_spmm, hyb_spmm, reuse_spmm, spmm

    return {"K1": hyb_spmm.KERNEL_LAUNCHES, "K2": hyb_spmm.MASK_LAUNCHES,
            "K3": spmm.SPMM_LAUNCHES, "K4": spmm.SDDMM_LAUNCHES,
            "K5": spmm.SEGSUM_LAUNCHES, "K6": reuse_spmm.PAIR_LAUNCHES,
            "K7": hyb_spmm.DYN_LAUNCHES, "degree": degree_spmm.DEGREE_LAUNCHES}


def reset_counts() -> None:
    from dorylus_tpu_torch.ops import degree_spmm, hyb_spmm, reuse_spmm, spmm

    hyb_spmm.KERNEL_LAUNCHES = hyb_spmm.MASK_LAUNCHES = hyb_spmm.DYN_LAUNCHES = 0
    spmm.SPMM_LAUNCHES = spmm.SDDMM_LAUNCHES = spmm.SEGSUM_LAUNCHES = 0
    reuse_spmm.PAIR_LAUNCHES = degree_spmm.DEGREE_LAUNCHES = 0


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
    """A 5-epoch Reddit-config run: falling finite losses, its kernel
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
    print(f"{label} warm epoch (with eval) {warm_epoch_ms:.3f} ms, train step "
          f"{step_ms:.3f} ms, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_steps(eng, cfg, label)
    del eng
    torch.cuda.empty_cache()
    return counts, {"warm_epoch_ms": warm_epoch_ms, "step_ms": step_ms}


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
    features and the bench's labels, as bench.py:274-286 builds it."""
    from dorylus_tpu.graph.graph import Graph, community_core_edges

    src, dst = community_core_edges(v, deg, **kw)
    rng = np.random.default_rng(4)
    return Graph(num_vertices=v, src=src, dst=dst,
                 features=rng.normal(0, 0.3, size=(v, feat)).astype(np.float32),
                 labels=((np.arange(v) * classes) // v).astype(np.int32),
                 num_classes=classes).finalize()


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU to run on")
    try:
        import bench
        from dorylus_tpu import native
        from dorylus_tpu.common.config import LayerConfig, TrainConfig
        from dorylus_tpu.graph.graph import synthetic_graph
        from dorylus_tpu.graph.reorder import apply_order, degree_order
        from dorylus_tpu.graph.reuse import mine_reuse
        from dorylus_tpu_torch.engine.batch import build_batch
        from dorylus_tpu_torch.engine.engine import (Engine, _max_agg_width,
                                                     resolve_reuse_budget)
        from dorylus_tpu_torch.ops import (cuda_build, degree_spmm, hyb_spmm,
                                           reuse_spmm, spmm)
        from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
        from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
        from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
        from dorylus_tpu_torch.ops.spmm import EdgeSpMM
    except ImportError as e:
        fail(f"run from the root of a dorylus_tpu checkout ({e})")
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

    # 2. build the four libraries at once; the host's pair miner
    t0 = time.perf_counter()
    try:
        info = cuda_build.compile_sources([hyb_spmm._CSRC, spmm._CSRC,
                                           hyb_spmm._DYN_CSRC, reuse_spmm._CSRC])
        hyb_spmm.build_kernel()
        hyb_spmm.build_dyn_kernel()
        spmm.build_kernel()
        reuse_spmm.build_kernel()
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
    g = bench.build_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"],
                          seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    print(f"reddit-shaped graph: V={v} E={g.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
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
            results.append(compare("reddit", op, f, seed=f, timed=True))
            results.append(compare_mask("reddit", op, f, seed=f + 2, timed=True))
            results.append(compare_dyn("reddit", op, f, seed=f + 4, timed=True))
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
                                             seed=f + 5, timed=True))
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
            degree_results.append(compare_degree("reddit", dop, f, seed=f + 7, timed=True))
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
    layers = LayerConfig([REDDIT["feat"], 128, REDDIT["classes"]])
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
    refuses_bad_input(ref_op, peop, rop)
    del rop, hop, ref_op, peop, levels2
    torch.cuda.empty_cache()

    # 4. main path, GCN
    gcn_counts, gcn_times = main_path(
        g, layers, TrainConfig(epochs=5, eval_every=1, kernel="hyb",
                               agg_dtype="bfloat16", reuse="off"),
        "reddit-config GCN", "K1")
    # 4b. main path, GAT
    gat_counts, gat_times = main_path(
        g, layers, TrainConfig(epochs=5, eval_every=1, model="gat", kernel="hyb",
                               agg_dtype="bfloat16", learning_rate=0.005,
                               reuse="off"),
        "reddit-config GAT", "K2")

    # 4c. the edgewise path at full size, against hyb with f32 aggregation
    edge_counts = {}
    edge_times = {}
    hyb_f32_losses = {}
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        cfg = TrainConfig(epochs=3, eval_every=1, model=model, kernel="xla",
                          learning_rate=lr, reuse="off")
        eng, rep_x, counts = train(g, layers, cfg, f"reddit-config {model} xla")
        edge_times[model] = float(np.mean([e.time_ms for e in rep_x.epochs][1:]))
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
            "step_ms": cuda_ms(lambda: eng._train_epoch(lr), 5)}
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
                   "step_ms": cuda_ms(lambda: eng._train_epoch(lr), 5)}
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
        losses, step_ms = gcn_steps(layers, op, batch, steps=3)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"reddit-config GCN, {kind_} op: losses {json.dumps(losses)} train step "
              f"{step_ms:.3f} ms, launches {json.dumps(counts)}", flush=True)
        dyn_times[kind_] = step_ms
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
    entry = {
        "K1": ("hyb_static_pass", "dorylus_tpu_torch/ops/csrc/hyb_spmm.cu",
               "dorylus_tpu/ops/hyb_spmm.py:392", gcn_counts["K1"],
               k1["fwd_ms"], k1["fwd_plain_ms"]),
        "K2": ("hyb_mask_pass", "dorylus_tpu_torch/ops/csrc/hyb_spmm.cu",
               "dorylus_tpu/ops/hyb_spmm.py:508", gat_counts["K2"],
               k2["fwd_ms"], k2["fwd_plain_ms"]),
        "K3": ("csr_spmm", "dorylus_tpu_torch/ops/csrc/edge_spmm.cu",
               "dorylus_tpu/ops/spmm.py:21", edge_counts["K3"],
               ke["K3_fwd_ms"], ke["K3_fwd_plain_ms"]),
        "K4": ("sddmm", "dorylus_tpu_torch/ops/csrc/edge_spmm.cu",
               "dorylus_tpu/ops/spmm.py:74", edge_counts["K4"],
               ke["K4_ms"], ke["K4_plain_ms"]),
        "K5": ("segment_sum", "dorylus_tpu_torch/ops/csrc/edge_spmm.cu",
               "dorylus_tpu/ops/spmm.py:185", edge_counts["K5"],
               ke["K5_vec_ms"], ke["K5_vec_plain_ms"]),
        "K6": ("pair_build", "dorylus_tpu_torch/ops/csrc/pair_build.cu",
               "dorylus_tpu/ops/reuse_spmm.py:37", reuse_counts["K6"],
               k6["ms"], k6["plain_ms"]),
        "K7": ("hyb_dynamic_pass", "dorylus_tpu_torch/ops/csrc/dyn_spmm.cu",
               "dorylus_tpu/ops/hyb_spmm.py:476", dyn_counts,
               k7["fwd_ms"], k7["fwd_plain_ms"]),
        "degree": ("degree_pass", "dorylus_tpu_torch/ops/csrc/hyb_spmm.cu",
                   "dorylus_tpu/ops/degree_spmm.py:132", degree_counts,
                   kd["static_fwd_ms"], kd["static_fwd_plain_ms"]),
        "reuse": ("reuse_unit_pass", "dorylus_tpu_torch/ops/csrc/hyb_spmm.cu",
                  "dorylus_tpu/ops/reuse_spmm.py:47", reuse_counts["K2"],
                  kr["fwd_ms"], kr["fwd_plain_ms"]),
    }
    kernels = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": MAX_ERR[k], "ms": ms,
                "plain_ms": plain_ms}
               for k, (name, source, replaces, launches, ms, plain_ms) in entry.items()]
    print("timings " + json.dumps({"gcn_hyb_bf16": gcn_times, "gat_hyb_bf16": gat_times,
                                   "xla_f32_warm_epoch_ms": edge_times,
                                   "degree_bf16": degree_times,
                                   "community_bf16": reuse_times,
                                   "gcn_value_ops_bf16_step_ms": dyn_times}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
