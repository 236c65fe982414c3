"""Drive the PyTorch port (dorylus_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: torch.cuda must see one; print nvidia-smi's name and power
     limit;
  2. build the hybrid-ELL CUDA kernel from ops/csrc/ with nvcc;
  3. kernel vs its plain PyTorch version on the card, forward and dh, at
     the Reddit shape (V=232,965, avg in-degree 50, degree-ascending
     renumbering, as bench.py builds it) for F=128 and F=41 in f32 and
     bf16, then on a small power-law graph with hub chunk rows and the
     `inv` output layout; times of both at the Reddit shape;
  4. the main path: Engine.run() of the Reddit-config GCN (602-128-41,
     kernel="hyb", bf16 gather tables) for 5 epochs; losses finite and
     falling, kernel launch count > 0;
  5. a planted 2,000-vertex graph trained 10 epochs on the card and on the
     CPU (f32 aggregation): the loss trajectories agree.
Then one JSON line with the kernel's numbers and, last, the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Tolerances (max abs error over max |plain|): f32 1e-4; bf16 1e-2 (the
kernel rounds each bf16 product as the plain version does, so only the
summation order differs). Card vs CPU trajectory: atol 1e-3.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = {"float32": 1e-4, "bfloat16": 1e-2}


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


def powerlaw_edges(v: int, seed: int):
    """dst-sorted edges with Zipf in-degrees (many above max_width=8) and
    uniform sources; vertex ids are not degree-sorted (inv layout)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, v), 2000)
    dst = np.repeat(rng.permutation(v).astype(np.int32), deg)
    dst = np.sort(dst)
    src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    val = rng.uniform(0.05, 1.0, size=len(dst)).astype(np.float32)
    return src, dst, val


def compare(name: str, op, f: int, seed: int, timed: bool) -> dict:
    """Kernel (op.apply_static and its backward) vs hyb_static_pass_plain
    on the same CUDA tensors; gout is random (data-dependent)."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_static_pass, hyb_static_pass_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.normal(size=(op.num_in, f)).astype(np.float32), device=dev)
    gout = torch.tensor(rng.normal(size=(op.num_out, f)).astype(np.float32),
                        device=dev)
    hk = h.clone().requires_grad_(True)
    out_k = op.apply_static(hk)
    out_k.backward(gout)
    gd = op.gather_dtype
    out_p = hyb_static_pass_plain(h, op.fwd, op.num_out, gd)
    dh_p = hyb_static_pass_plain(gout, op.bwd, op.num_in, gd)[: h.shape[0]]
    torch.cuda.synchronize()
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    for key, got, ref in (("fwd", out_k.detach(), out_p), ("bwd", hk.grad, dh_p)):
        check(bool(torch.isfinite(got).all()), f"{name} {key}: non-finite output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        res[f"{key}_max_abs_err"] = err
        res[f"{key}_rel_err"] = err / scale if scale else err
        check(err <= TOL[dtype] * scale,
              f"{name} F={f} {dtype} {key}: max abs err {err:.3e} > "
              f"{TOL[dtype]:.0e} * max|ref| {scale:.3e}")
    if timed:
        res["fwd_ms"] = cuda_ms(lambda: hyb_static_pass(h, op.fwd, op.num_out, gd), 20)
        res["fwd_plain_ms"] = cuda_ms(
            lambda: hyb_static_pass_plain(h, op.fwd, op.num_out, gd), 5)
        res["bwd_ms"] = cuda_ms(lambda: hyb_static_pass(gout, op.bwd, op.num_in, gd), 20)
        res["bwd_plain_ms"] = cuda_ms(
            lambda: hyb_static_pass_plain(gout, op.bwd, op.num_in, gd), 5)
    print("compare " + json.dumps(res), flush=True)
    return res


def refuses_bad_input(op) -> None:
    """A kernel launch with a table it does not take raises; it never falls
    back to the plain version."""
    from dorylus_tpu_torch.ops import hyb_spmm

    part = op.fwd["buckets"][0]
    out = torch.zeros((op.num_out, 8), device="cuda")
    before = hyb_spmm.KERNEL_LAUNCHES
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((op.num_in, 8), dtype=bad, device="cuda")
        try:
            hyb_spmm._launch_part(tb, part, out)
        except ValueError as e:
            print(f"refused {bad}: {e}", flush=True)
        else:
            fail(f"kernel launcher accepted a {bad} table")
    check(hyb_spmm.KERNEL_LAUNCHES == before, "a refused call counted a launch")


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU to run on")
    try:
        import bench
        from dorylus_tpu.common.config import LayerConfig, TrainConfig
        from dorylus_tpu.graph.graph import synthetic_graph
        from dorylus_tpu.graph.reorder import apply_order, degree_order
        from dorylus_tpu_torch.engine.engine import Engine
        from dorylus_tpu_torch.ops import hyb_spmm
        from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
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

    # 2. build
    t0 = time.perf_counter()
    hyb_spmm.build_kernel()
    info = hyb_spmm.BUILD_INFO
    print(f"kernel build: {info['seconds']:.2f} s nvcc, "
          f"{time.perf_counter() - t0:.2f} s total -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)

    # 3. kernel vs plain
    t0 = time.perf_counter()
    g = bench.build_graph(232_965, 50, 602, 41, seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    print(f"reddit-shaped graph: V={v} E={g.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    results = []
    for gd in (torch.bfloat16, None):
        t0 = time.perf_counter()
        op = HybSpMM(g.src, g.dst, v, v, gather_dtype=gd, static_val=g.edge_norm,
                     device="cuda")
        print(f"plans ({gd}): fwd {len(op.fwd['buckets'])} buckets, top "
              f"{op.fwd['top'] is not None}, layout "
              f"{'n_iso' if 'n_iso' in op.fwd else 'inv'}; bwd layout "
              f"{'n_iso' if 'n_iso' in op.bwd else 'inv'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for f in (128, 41):
            results.append(compare("reddit", op, f, seed=f, timed=True))
        if gd is None:
            refuses_bad_input(op)
        del op
    src, dst, val = powerlaw_edges(20_000, seed=7)
    for gd in (torch.bfloat16, None):
        op = HybSpMM(src, dst, 20_000, 20_000, max_width=8, gather_dtype=gd,
                     static_val=val, device="cuda")
        check(op.fwd["top"] is not None and "inv" in op.fwd and "inv" in op.bwd,
              "power-law plan lacks hub rows or the inv layout")
        for f in (128, 41):
            results.append(compare("powerlaw_hubs", op, f, seed=f + 1, timed=False))
        del op
    torch.cuda.empty_cache()

    # 4. the main path
    hyb_spmm.KERNEL_LAUNCHES = 0
    eng = Engine(g, LayerConfig([602, 128, 41]),
                 TrainConfig(epochs=5, eval_every=1, kernel="hyb",
                             agg_dtype="bfloat16", reuse="off"), device="cuda")
    rep = eng.run()
    torch.cuda.synchronize()
    launches = hyb_spmm.KERNEL_LAUNCHES
    losses = [e.loss for e in rep.epochs]
    epoch_ms = [e.time_ms for e in rep.epochs]
    print("reddit-config GCN: losses " + json.dumps(losses) + " epoch ms "
          + json.dumps(epoch_ms) + f" val acc {rep.final_accuracy} "
          f"kernel launches {launches}", flush=True)
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "training loss did not fall")
    check(launches > 0, "the main path launched no kernel")
    logits = eng.predict()
    check(logits.shape == (v, 41) and bool(np.isfinite(logits).all()),
          f"predict gave {logits.shape} or non-finite values")
    warm_epoch_ms = float(np.mean(epoch_ms[1:]))
    # train step alone (loss, backward, Adam; no eval), for comparison with
    # bench.py's eval_every=0 epochs
    step_ms = cuda_ms(lambda: eng._train_epoch(0.01), 5)
    print(f"reddit-config warm epoch (with eval) {warm_epoch_ms:.3f} ms, "
          f"train step {step_ms:.3f} ms, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del eng

    # 5. card vs CPU on a planted graph
    gp = synthetic_graph(2000, 8, 602, 41, seed=8888)
    cfg = TrainConfig(epochs=10, eval_every=1, kernel="hyb", reuse="off")
    layers = LayerConfig([602, 128, 41])
    gpu_l = [e.loss for e in Engine(gp, layers, cfg, device="cuda").run().epochs]
    cpu_l = [e.loss for e in Engine(gp, layers, cfg, device="cpu").run().epochs]
    gap = float(np.max(np.abs(np.array(gpu_l) - np.array(cpu_l))))
    print(f"planted graph card vs CPU: max loss gap {gap:.3e} over 10 epochs "
          f"(gpu {gpu_l[0]:.5f} -> {gpu_l[-1]:.5f})", flush=True)
    check(gap <= 1e-3, f"card and CPU trajectories differ by {gap:.3e} > 1e-3")

    main_case = next(r for r in results if r["case"] == "reddit"
                     and r["dtype"] == "bfloat16" and r["F"] == 128)
    kernels = [{
        "name": "hyb_static_pass",
        "route": "cuda",
        "source": "dorylus_tpu_torch/ops/csrc/hyb_spmm.cu",
        "replaces": "dorylus_tpu/ops/hyb_spmm.py:392",
        "launches": launches,
        "max_abs_err": max(max(r["fwd_max_abs_err"], r["bwd_max_abs_err"])
                           for r in results),
        "ms": main_case["fwd_ms"],
        "plain_ms": main_case["fwd_plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
