"""Drive the PyTorch port (dorylus_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:
  1. the card: torch.cuda must see one; print nvidia-smi's name and power
     limit, and its maximum SM clock (the probes' bounds read it);
  2. build the seven CUDA libraries from ops/csrc/ with nvcc, one process
     each, started together; report which pair miner the host has;
  3. K1 (hybrid-ELL static mode) vs its plain PyTorch version on the card,
     forward and dh, at the Reddit shape (V=232,965, avg in-degree 50,
     degree-ascending renumbering: graph.build_graph, then reorder) for F=128,
     F=41 and F=64 (tensor parallelism's width, phase 9) in f32 and bf16,
     then on a small power-law graph with hub chunk rows and the `inv` output
     layout; times of both at the Reddit shape;
  3b. K2 (mask mode) the same way: apply_unit and apply_dst forward, dh and
     d_dst;
  3c. the edgewise kernels vs their plain versions at the Reddit shape
     (F=128 and 41, f32 and bf16 tables, times of both) and on a power-law
     graph with rows of 0 and > 1,000 edges: K3 (CSR SpMM: the forward over
     the dst CSR, dh over the src CSR), K3's dh pass with K4's value
     gradient fused in (what GAT's backward runs, checked through autograd
     too: one forward and one fused launch), K4 (SDDMM) alone and K5 (sorted
     segment-sum; the (E,) form also on a view one element past a 16-byte
     boundary); each with its pass ms and, apart, its kernel's device ms,
     K5 also with the host's µs to enqueue a pass and a bound for its (E, F)
     form; then every kernel refuses float16 and float64 and counts no
     launch;
  3d. K7 (dynamic values; the gather core's dynamic team, one launch a
     pass) vs its plain version at the Reddit shape (F=128 and 41, f32 and
     bf16): the forward and the fused dh + dval through autograd, and dh
     alone, one launch each; times of the three passes and their plain
     versions, the kernel-only ms apart from the pass ms, bounds, and the
     PyTorch calls of the same functions (`sparse.mm` with the call's values,
     of the transposed CSR for dh, plus `sampled_addmm` for the fused pass);
     then on the power-law hub graph;
  3e. the degree pass on degree plans (K1 static, K2 unit/dst, K7 dynamic:
     forward, dh + dval and dh alone) vs the plain degree pass at the Reddit
     shape (times of both, K7's kernel-only ms apart), then on a power-law
     graph with isolated rows and rows of > 1,000 edges;
  3f. K6 (the pair-table build) vs plain, exactly, on the mined
     Reddit-scale community graph (bench.COMMUNITY): the passes=2
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
     wires; times of kernel, plain and the one PyTorch call, and for K9's
     pack and placement and K10 the kernel-only ms and the host's µs to
     enqueue a pass; then K9 and K10 the same way at F=64 (f32 and bf16,
     exact wire) on rank 0's plan of the 2-way partition, phase 9's graph
     shards. One process, no collective;
  3h. (beside 3g) the sharded degree op on the same shard: the degree
     pass over rank 0's combined, interior and boundary plans (K1 static,
     K2 dst, K7 dynamic with dval; forward, dh or dghosts, d_dst, dval;
     F=128 and 41, f32 and bf16) vs the plain degree pass; the interior and
     boundary hyb plans vs the plain hyb pass; interior + boundary against
     the combined plan's output (f32, 1e-4); times of kernel, plain and
     `torch.sparse.mm` on that plan's CSR;
  3i. rank 0's shard of the 4-way range partition of the Reddit-scale
     community graph: the sharded reuse op at the engine's pair budget (the
     miner's seconds, pairs, row cut), K6 bit for bit at base vp + n*max_h
     and vp, the non-square reuse pass forward and dh vs plain and vs the
     unrewritten combined plan;
  3j. the primitive probes P1-P4 (tools/probe_prims.py): their rates on one
     block and on a grid that fills the card, 100,000 ops a stream (P3 on
     tables of 32 MB, 60 MB, 119 MB and 1 GB of 512-byte rows and on 60 MB
     of 256-byte rows), each timed launch held against its plain version on
     the same inputs (P2, P3 bit for bit; P1, P4 to 1e-4), after a fast
     check at 2,000 ops; then the
     one PyTorch call of P1's, P2's and P3's function (`embedding_bag`,
     `bincount`, `index_select`), timed on those inputs;
  4. main path, GCN: Engine.run() of the Reddit-config GCN (602-128-41,
     kernel="hyb", bf16 gather tables) for 3 epochs (the epoch's CUDA
     graphs, one epoch a group, so that a record times one epoch); losses finite and
     falling, K1 launches > 0; the run's notes: "hbm" peak bytes > 0 and at
     most the card's memory, "cost" GPU-seconds > 0; the train step's ms,
     also with staleness 1;
     then a torch.profiler table of 10 train steps (device time by kernel,
     the device's idle share), as for 4b;
  4b. main path, GAT: the Reddit-config GAT (kernel="hyb", bf16 gather,
     lr 0.005) for 3 epochs; losses finite and falling, K2 launches > 0,
     predict() finite (V, 41); the step also with staleness 1;
  4c. the edgewise path at full size: GCN and GAT with kernel="xla" for 3
     epochs in f32, each against the same model on kernel="hyb" with f32
     aggregation (the same sums in another order: loss rtol 1e-4); train
     step ms (CUDA events) and launches per step; K3's forward launches >
     0, and K3's dh alone for GCN, K3's dh fused with K4's value gradient
     and K5 for GAT (K4 alone runs on neither path);
  4g. the edgewise path past 400k vertices: GCN with kernel="auto" on
     build_graph(450_000, 16, 602, 41, seed=2) (7.2M edges: auto resolves to
     xla, and the engine takes JAX's dst-blocked branch) for 2 epochs in
     f32: losses finite and falling, K3 and its dh launched;
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
     steps through the model's `apply(h, edge_val)` branch: K7 launches 4 a
     step (one a pass: two forwards, two dh alone); then the same with the
     edge values requiring a gradient, whose backward is K7's fused dh +
     dval (two forwards, two fused passes a step); losses finite and
     falling, and equal to the static-value path's to rtol 1e-4 (both round
     each weight and product to bf16);
  5. a planted 2,000-vertex graph, GCN on hyb, 5 epochs on the card and on
     the CPU (f32 aggregation): loss trajectories agree to atol 1e-3;
  5b. the same graph for GAT on hyb and for the default config (kernel
     "auto" -> xla) of GCN and GAT: relative agreement, rtol 1e-5 (GAT's
     losses are O(100) at init);
  5c. card vs CPU for GCN and GAT on kernel="degree" (the planted graph,
     5 epochs) and on reuse="pairs" (the 4,000-vertex community graph,
     passes=2, 3 epochs): relative agreement, rtol 1e-5;
  6. the sharded engine at full width: 4 ranks on the card over gloo (one
     process per shard, rank = shard id; the parent partitions once and
     hands each rank its shard file), Reddit-config GCN then GAT on
     kernel="hyb" with the fused-overlap plan, the exact wire and bf16
     gather tables, 2 epochs each: losses finite, GCN's falling, K8, K9,
     K10 and K1/K2 launches > 0 on every rank; per-rank edges, ghosts,
     max_h, wire bytes per exchange, warm epoch, train step and exchange
     ms, kernel time and idle share; rank 0 prints the GCN run's
     ShardedEngine.profile(iters=3), taken before its trace. Then both in f32
     against 4c's
     single-device hyb f32 losses (rtol 1e-4), and GCN with overlap off
     (the combined plan) against the fused plan (rtol 1e-5). Every overlap
     run (here and in 6d, 6f) splits each forward exchange around the
     rank's interior work (parallel/halo.py `Halo.start` / `finish`) and
     each reverse exchange around the gradient work that does not read it
     (the interior op's backward, the self term, GAT's attention gradient:
     started in HaloRecvFn's backward, finished in HaloJoinFn's): each
     rank prints its fused plan's pure_edges / mixed_edges (or the pair's
     interior / boundary edges), the exchanges its training started, those
     whose interior work had completed when gloo's wait returned (an event
     recorded before the wait, queried after it), the host's ms an exchange
     and the card's ms beside a held one, and the same of the reverse
     exchanges (multihost.EXCHANGES); an overlap run that split no forward
     or no reverse exchange, or a combined one that split any, fails;
  6d. (in phase 6's launch) the same on kernel="degree" with the (interior,
     boundary) plan pair, bf16, 2 epochs: degree, K9 and K10 launches > 0 on
     every rank; in f32 against 4c's hyb losses (rtol 1e-4) and against
     the combined degree plan (overlap=False, rtol 1e-5), both timed;
  6f. (in phase 6's launch) kernel="xla" with overlap=True in f32, GCN and
     GAT, against the combined edgewise run (rtol 1e-5): the launches per
     step of K3's forward and of its dh (fused with K4's value gradient for
     GAT) double, K5 > 0 for GAT;
  6e. 4 ranks on the community graph's shards: GCN and GAT on hyb with
     reuse="pairs" against reuse="off", bf16, 2 epochs (rtol 1e-2); K6 and
     K2 launches > 0 on every rank, overlap turned off by the rewrite;
  6b. (in 6e's launch: the card's runs, then the same ranks' CPU runs)
     small graphs, 4 ranks on the card against 4 ranks on the CPU: the
     planted 2,000-vertex graph, GCN (3 epochs) and GAT (2) on hyb (with
     predict() in global order against the single-device engine's) and on
     the degree pair, and the 4,000-vertex community graph with
     reuse="pairs": rtol 1e-5;
  6c. only where torch.cuda.device_count() >= 2: phase 6's GCN over NCCL,
     one rank per card, through the epochs' CUDA graphs (the halo
     exchanges, each forked onto a side stream beside the pure K8 range and
     joined before the mixed one, each reverse exchange forked in
     HaloRecvFn's backward and joined in HaloJoinFn's, beside the self
     term's gradient, and the all-reduce captured) and then
     eagerly from the same init, bit for bit with the same launches; else
     one line says the NCCL path was not run.
  7. the command line, through `cli.main` on the card it picks by default,
     at the Reddit config (602-128-41) on synthetic_graph(232_965, 25, 602,
     41, seed=8888) (11.6M edges), degree-ascending, one graph for 7a-7d:
     (a) GCN on hyb with bf16 gather tables, --staleness 1, 4 epochs with a
     checkpoint every 2, then --resume for 2, an uninterrupted 6-epoch run
     and a synchronous 2-epoch one: losses finite and falling, K1 launched
     on every step, the checkpointed run equal to the uninterrupted one's
     first 4 epochs and the resumed epochs to the loss at the loaded params
     (rtol 1e-5: a resumed window starts there), S=1 apart from S=0 at
     epoch 1; (b) `infer` from that checkpoint writes 232,965 finite lines
     of 41; (c) GAT with --kernel xla --staleness 2 for 3 epochs: K3, its
     dh fused with K4 and K5 launched, the 3 losses those of the starting
     params; (d) --shards 4 over gloo on the card, S=1, 3 epochs, one
     checkpoint: losses within 1e-3 of (a)'s; each sub-phase's seconds;
  8. (run first, right after the Reddit-shaped graph is built: before any
     torch.profiler session in the process) Engine.profile(iters=20) on the
     Reddit-config GCN and GAT (hyb, bf16 gather): each layer's aggregate
     brackets run once with the counts at 0 launch K1 (GCN) or K2 (GAT) 3
     times (forward; the backward's forward and dh) and nothing else; the brackets are
     JAX's, finite and > 0; each printed, the aggregate brackets beside
     phase 3's K1/K2 pass at the same width;
  9. (in phase 6's launch, before its traced runs) tensor parallelism on the
     one card: 4 gloo ranks as 2 graph x 2 feat shards (rank r on shard
     r // 2 of the 2-way partition) at the Reddit config, GCN on hyb with
     f32 gather and GAT on hyb with bf16 gather, 2 epochs each: GCN's losses
     within rtol 1e-4 of 4c's single-device hyb f32 losses, GAT's finite
     and falling; each rank's K1/K2, K9 and K10 launches by table width (all
     of GCN's at 64; GAT's output layer at 41); the step ms, host-bound
     (gloo on one card), GAT's step traced for the device's idle share;
     rank 0 prints ShardedEngine.profile(iters=3);
 11. (right after phase 8, before any torch.profiler session) the epoch
     groups' CUDA graphs (engine/graphs.py) on phase 3's Reddit graph: GCN
     (K1) and GAT (K2) on hyb with bf16 gather tables, 8 epochs in one
     group with eval every 3 epochs, the eager loop and then the graph path
     from one init: losses, accuracies, params and launch counts bit for
     bit, notes["hbm"]'s peak of each; the warm epoch of a group of 10 with
     eval_every 0 and 1, replayed and eager in turns (CUDA events over the
     group, and the host's wall time with the group's read);
 11c. (right after phase 11, before any torch.profiler session) the same
     on `ShardedEngine` with no process group (one shard, the combined
     plan), GCN (K1) and GAT (K2): the eager loop then the graph path, bit
     for bit with equal launch counts; losses within rtol 1e-4 of phase
     11's Engine (printed: whether bit for bit); a replayed group of 10's
     warm epoch beside phase 11's; a second run() of each sharded engine
     and of phase 11's GCN Engine captures nothing (the graphs live as
     long as the engine);
 11b. (after phase 5) one traced group of 10 of phase 11's GCN, replayed
     and eager: the device's idle share; then xla, degree in f32 (K7) and
     reuse="pairs" (K6, K2) on phase 5's 4,000-vertex community graph, GCN
     and GAT, 3 epochs at staleness 1: the graph path equal to the eager
     loop bit for bit, the same launch counts;
 12. (right after phase 11, before any torch.profiler session) the port's
     benchmark (dorylus_tpu_torch/bench.py, `python -m dorylus_tpu_torch.cli
     bench`) on phase 3's Reddit graph and on the plans phase 3 then checks:
     its pass cells (K1 bf16 and f32, K7 forward, the degree pass, K3
     forward, P3 over K1's live slot rows for the gather bound,
     torch.sparse.mm), each held against its plain version first, and its
     four Reddit-config epoch cells (Engine.run(3) twice), launch counts set
     to 0 just before and read after;
 12b. (after phase 4e) the bench's reuse cells: K2's pass against K6 + K2
     over the passes=2 rewrite of the 1.6M-vertex community graph (its
     graph, mining and plans made on the host in a process of its own,
     started after phase 10, handed back as an .npz), and GCN's warm epochs
     with reuse "off" and "pairs" on phase 3f's community graph; then the
     scipy baseline and the bench's record: every key of bench.py's JSON
     present, its numbers finite and > 0; the reuse="auto" gate's decision
     on that graph from `reuse_payoff` (phase 5 runs reuse="auto" on its
     4,000-vertex community graph: the branch the gate predicts, and the
     losses of the explicit setting bit for bit);
 12c. (right after phase 12, before any torch.profiler session) the card's
     switch points (tools/switch_points.py): kernel="auto"'s choice (the
     engines' kernel_selected) on phase 3's Reddit graph and on phase 4g's
     450k-vertex graph (made here, trained in 4g), the plan overlap="auto"
     picks per kernel on phase 6's 4-way partition (made here, used from
     3g on), and one hyb/xla f32 GCN pair of warm epochs (groups of 10
     replayed) with the tool's `engine_times` on phase 12's plans;
 10. (after 3, 3b, 3d) the Amazon config at its JAX run script's SCALE 0.12
     (benchmarks/run-amazon-gcn: synthetic_graph(1_131_610, 12, 300, 25,
     seed=8888), 27.2M edges, 300-64-25, degree-ascending, hyb, bf16 gather)
     through tools/reference_configs.py and `cli.main`, one graph for both
     runs (made by the command line's loader in a process of its own,
     started before phase 8, so its host seconds pass beside phases 8-3): first K1 at F=64 and F=25 and K2 at F=64 on its plan against
     their plain versions (tables past the card's 50 MB L2), timed as in
     phase 3, with the bound and the time if every gathered row came from
     device memory; then amazon-gcn and amazon-gat, 3 epochs each: losses
     finite (GCN's falling), kernel "auto" -> hyb, K1 / K2 launches by table
     width (64 and 32, 25 padded; 2 each a step), notes["hbm"]'s peak within
     the card's memory (and of 3 more epochs of the same engine, eager and
     through the epoch's CUDA graphs), the train step's ms;
 13. (after 7) tools/weak_scaling.py's device mode at the JAX package's
     r5 config (benchmarks/results/weak_scaling_hyb_r5.json: kernel hyb,
     GCN, 262,144 base vertices, degree 16, 64-32-8, clustered, cut 0.1,
     10 epochs, 3 repeats, --overlap both --decompose, shards 1 2 4): one
     NCCL rank a card through the tool's `sweep`, so on one card n = 1
     runs over NCCL (a world of 1, the port's first NCCL group on the
     card) and 2 and 4 print the skip line: backend nccl, the graph's
     edges, a finite epoch and 3 runs, ShardedEngine.profile's keys; the
     rank's losses against a one-device Engine on the same graph and
     config (rtol 1e-4), K1 launched in the rank's window (the combined
     plan: no K8-K10 at n = 1); the rank's epochs replayed as CUDA graphs
     (`epoch_timing` "replayed"), equal bit for bit to the same config run
     eagerly from the same init in the rank; `multihost.all_to_all_rows`
     (its fork onto the side stream and join) and an NCCL all-reduce
     captured in one CUDA graph on the world of 1, 3 replays with new
     inputs exact; the replayed epoch beside the Engine's and the rank's
     eager one; then K8 as the engines launch it, two ranges of its parts
     (the pure range, then the mixed one into the same output) on shard 0
     of the 4-way partition of that graph (its pure range not empty;
     n_pure and pure_edges printed), GCN's static op in bf16 and the mask
     op in f32 at F=32 and 8: each range against its plain half (f32 1e-4,
     bf16 1e-2 of max |plain|), the two bit for bit against one launch over
     every part, the pure range's launch counted apart (FUSED_PURE_LAUNCHES);
     the pass and kernel-only ms of each range at F=32 bf16 beside the one
     launch's;
K1, K2, K7 and K8 (and the degree passes on K1/K7) are one launch a pass
over every part of their plan (the gather core, csrc/gather_pass.cuh); their
timed rows carry the pass ms (CUDA events: the table's cast, the
zero-filled output and the launch) and, apart, the kernel's own device ms
and the rest's (torch.profiler, `*_kernel_ms` / `*_other_ms`).
Each main path runs with every launch count set to 0 just before it and
read just after (in each rank, for the sharded engine). The sharded ranks do
not retry building native/libgraphcore.so where phase 2 found it does not
build on this host. Then one JSON line
with the kernels' numbers (K1-K10, K1/K2/K9/K10 also at F=64 with phase 9's
launches at that width, K1 at F=64 and 25 and K2 at F=64 on phase 10's
Amazon plan with its launches (K5, K9 and K10 also with their kernel-only
ms and the host's µs to enqueue a pass), K3's dh alone and fused with K4's value
gradient, K7's dh alone and fused with its value gradient, the fused plan's
backward, the degree, reuse, sharded-degree and sharded-reuse passes, which
run on K1/K2/K7 and K6 + K2, and the probes P1-P4): beside each kernel's time
its plain version's, its bound (the bytes it must move over 3.35 TB/s, or
its operations over 67 TFLOP/s of f32, whichever is larger, from this
run's inputs; for the probes what each uses: P1's and P2's shared-memory
bytes at 128 B a clock on every SM, P4's warp shuffles at one a clock on
every SM, at the SM clock nvidia-smi reports) and, where one PyTorch call
computes the same function, that
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
import multiprocessing
import re
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
MAX_ERR = {k: 0.0 for k in ("K1", "K2", "K3", "K3_dh", "K3_dh_dval", "K4", "K5", "K6", "K7",
                            "K7_dh", "K7_dh_dval", "K8", "K9", "K10", "degree", "reuse",
                            "degree_sharded", "reuse_sharded")}
# The card's published peaks (H100 SXM): device memory rate, and f32 outside
# the tensor cores (the gather kernels multiply and add in f32 registers).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Shared memory moves 128 bytes a clock on each SM (32 banks of 4 bytes),
# the rate the probes P1 and P2 use.
SMEM_BYTES_PER_CLOCK = 128
RANKS = 4
# Timed train steps and exchanges a sharded rank's timed run averages, each
# after a warm one (the ranks' wall time is gloo's through the host).
RANK_REPEATS = 1
T_START = time.perf_counter()


def stamp(label: str) -> None:
    """The seconds since the script started, before a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {label}", flush=True)


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


def probe_bound(smem_bytes: float, shuffles: float, flops: float, sm_hz: float,
                n_sms: int) -> dict:
    """The bound of a probe by what it uses: its shared-memory bytes at
    SMEM_BYTES_PER_CLOCK a clock on every SM, its warp shuffles at one a
    clock on every SM (both at the SM clock the card reports), or its f32
    operations over the f32 rate, whichever is largest."""
    by_smem = 1e3 * smem_bytes / (SMEM_BYTES_PER_CLOCK * n_sms * sm_hz)
    by_shfl = 1e3 * shuffles / (n_sms * sm_hz)
    by_ops = 1e3 * flops / F32_FLOPS
    ms = max(by_smem, by_shfl, by_ops)
    return {"bound_ms": ms, "bound_by": "bytes" if ms == by_smem else "operations",
            "bound_smem_bytes": int(smem_bytes), "bound_shuffles": int(shuffles),
            "bound_flops": int(flops)}


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


def dyn_bwd_bound(op, f: int, elt: int, val: torch.Tensor) -> dict:
    """Bound of K7's backward with the fused dval: the table (gout) and the
    `other` rows (h) once, a row index and an edge id per live slot, each
    value read and each dval written once, the f32 output; four operations
    per gathered element (the weighted sum and the dot)."""
    live = live_slots(op.bwd)
    return bound((op.num_out + op.num_in) * f * elt + live * 8 + 2 * nbytes(val)
                 + op.num_in * f * 4, 4.0 * live * f)


def dyn_dh_bound(op, f: int, elt: int, val: torch.Tensor) -> dict:
    """Bound of K7's dh alone: the table (gout) once, a row index and an edge
    id per live slot of the transposed plan, each value once, the f32 dh."""
    return pass_bound(op.num_out, f, elt, live_slots(op.bwd), op.num_in, 8,
                      extra_bytes=nbytes(val))


def dyn_library(res: dict, csr: dict, val: torch.Tensor, shape, h: torch.Tensor,
                gout: torch.Tensor, dt: torch.dtype) -> None:
    """K7's yardsticks, each row's `library_ms` (and `library_f32_ms`):
    the forward's `sparse.mm` of the dst CSR with the call's values; dh's
    (`dh`) of the transposed CSR (values val[order]) with gout; the fused
    pass's (`bwd`) that `sparse.mm` plus `sampled_addmm` of the dst pattern
    (dval[e] = <gout[dst e], h[src e]>), summed, in f32."""
    spmm_library(res, csr, val, shape, h, dt)
    tcsr = {"row_ptr": csr["t_row_ptr"], "col": csr["t_col"]}
    spmm_library(res["dh"], tcsr, val[csr["order"]], shape[::-1], gout, dt)
    dh32 = res["dh"].get("library_f32_ms", res["dh"].get("library_ms"))
    pattern = torch.sparse_csr_tensor(csr["row_ptr"], csr["col"], torch.ones_like(val),
                                      size=shape)
    g32, ht = gout.float(), h.float().t()
    sddmm = library_ms(lambda: torch.sparse.sampled_addmm(pattern, g32, ht, beta=0.0),
                       "torch.sparse.sampled_addmm float32")
    del pattern, g32, ht
    both = None if sddmm is None or dh32 is None else dh32 + sddmm
    res["bwd"].update({"library_ms": both if dt == torch.float32 else None,
                       "library_f32_ms": both,
                       "library_calls": "torch.sparse.mm + torch.sparse.sampled_addmm"})


def kernel_split(res: dict, key: str, plan: dict, fn, iters: int = 20) -> None:
    """The gather kernels' device ms per call of fn (`{key}_kernel_ms`)
    apart from the rest of its device time (`{key}_other_ms`: the table's
    cast and the zero-filled output), by torch.profiler, beside the pass ms
    that CUDA events give; and the hub rows of the plan (`{key}_top_rows`):
    the hub top runs in the pass's one launch, its blocks first."""
    from dorylus_tpu_torch.tools.gather_bench import device_split

    res[f"{key}_kernel_ms"], res[f"{key}_other_ms"] = device_split(torch, fn, iters)
    top = plan.get("top")
    res[f"{key}_top_rows"] = 0 if top is None else int(top["v"].shape[0])


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
        kernel_split(res, "fwd", op.fwd, lambda: hyb_static_pass(h, op.fwd, op.num_out, gd))
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
        kernel_split(res, "fwd", op.fwd, lambda: hyb_mask_pass(h, op.fwd, op.num_out, gd))
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
    """K3 (forward over the dst CSR, dh over the src CSR), K3's dh pass with
    K4's dval fused in, K4 alone and K5 ((E,) and (E, F) cotangents) vs
    their plain versions on the same CUDA tensors; first through autograd
    (the forward, then the fused backward of GAT's edgewise aggregation).
    Timed: each entry's pass ms (CUDA events: the table's layout and the
    launch) and, apart, its kernel's device ms (`*_kernel_ms`)."""
    from dorylus_tpu_torch.ops import spmm
    from dorylus_tpu_torch.tools.gather_bench import device_split, enqueue_us

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = DTYPES[dtype]
    h = randn(gen, eop.num_in, f, dtype=dt)
    gout = randn(gen, eop.num_out, f, dtype=dt)
    trp, tc, order, inv = eop.t_row_ptr, eop.t_col, eop.order, eop.inv_order
    hk = h.clone().requires_grad_(True)
    vk = val.clone().requires_grad_(True)
    before = launch_counts()
    out = spmm.spmm_edgewise(hk, src, dst, vk, eop.num_out, op=eop)
    out.backward(gout)
    torch.cuda.synchronize()
    res = {"case": name, "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    ran = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    check(ran == {"K3": 1, "K3_dh_dval": 1},
          f"{name} F={f} {dtype}: autograd launched {ran}, want the forward and one fused pass")
    # (the path, dh cast to h's dtype: not a kernel's error against its plain version)
    dh_ref, dval_ref = spmm.csr_spmm_dval_plain(gout, h, trp, tc, val, order, inv)
    close(res, None, "autograd_dh", hk.grad, dh_ref, dtype)
    close(res, None, "autograd_dval", vk.grad, dval_ref, dtype)
    del out, hk, vk
    close(res, "K3", "K3_fwd", spmm.csr_spmm(h, eop.row_ptr, src, val),
          spmm.csr_spmm_plain(h, eop.row_ptr, src, val), dtype)
    close(res, "K3_dh", "K3_bwd", spmm.csr_spmm(gout, trp, tc, val, order), dh_ref, dtype)
    dh_k, dval_k = spmm.csr_spmm_dval(gout, h, trp, tc, val, order, inv)
    close(res, "K3_dh_dval", "K3_dh_dval_dh", dh_k, dh_ref, dtype)
    close(res, "K3_dh_dval", "K3_dh_dval_dval", dval_k, dval_ref, dtype)
    del dh_k, dval_k
    close(res, "K4", "K4", spmm.sddmm(h, gout, eop.row_ptr, src),
          spmm.sddmm_plain(h, gout, eop.row_ptr, src), dtype)
    g_vec = randn(gen, eop.num_edges)
    close(res, "K5", "K5_vec", spmm.segment_sum(g_vec, eop.row_ptr),
          spmm.segment_sum_plain(g_vec, eop.row_ptr), "float32")
    # a view one element past a 16-byte boundary: the chunks at g's ends
    # are read element by element
    g_view = randn(gen, eop.num_edges + 1)[1:]
    close(res, "K5", "K5_vec_view", spmm.segment_sum(g_view, eop.row_ptr),
          spmm.segment_sum_plain(g_view, eop.row_ptr), "float32")
    del g_view
    g_mat = randn(gen, eop.num_edges, f, dtype=dt)
    close(res, "K5", "K5_mat", spmm.segment_sum(g_mat, eop.row_ptr),
          spmm.segment_sum_plain(g_mat, eop.row_ptr), dtype)
    if timed:
        for key, kern, plain, iters in (
            ("K3_fwd", lambda: spmm.csr_spmm(h, eop.row_ptr, src, val),
             lambda: spmm.csr_spmm_plain(h, eop.row_ptr, src, val), 20),
            ("K3_bwd", lambda: spmm.csr_spmm(gout, trp, tc, val, order),
             lambda: spmm.csr_spmm_plain(gout, trp, tc, val, order), 20),
            ("K3_dh_dval", lambda: spmm.csr_spmm_dval(gout, h, trp, tc, val, order, inv),
             lambda: spmm.csr_spmm_dval_plain(gout, h, trp, tc, val, order, inv), 20),
            ("K4", lambda: spmm.sddmm(h, gout, eop.row_ptr, src),
             lambda: spmm.sddmm_plain(h, gout, eop.row_ptr, src), 20),
            ("K5_vec", lambda: spmm.segment_sum(g_vec, eop.row_ptr),
             lambda: spmm.segment_sum_plain(g_vec, eop.row_ptr), 20),
            ("K5_mat", lambda: spmm.segment_sum(g_mat, eop.row_ptr),
             lambda: spmm.segment_sum_plain(g_mat, eop.row_ptr), 20),
        ):
            res[f"{key}_ms"] = cuda_ms(kern, iters)
            res[f"{key}_plain_ms"] = cuda_ms(plain, 3)
            res[f"{key}_kernel_ms"], res[f"{key}_other_ms"] = device_split(torch, kern, 20)
            if key.startswith("K5"):
                res[f"{key}_host_us"] = enqueue_us(torch, kern)
        e = eop.num_edges
        out = spmm.csr_spmm(h, eop.row_ptr, src, val)
        dval = torch.empty(e, device="cuda")
        res["K3"] = bound(nbytes(h, eop.row_ptr, src, val, out), 2.0 * e * f)
        res["K3_dh"] = bound(nbytes(gout, trp, tc, order, val, out), 2.0 * e * f)
        res["K3_dh_dval"] = bound(nbytes(gout, h, trp, tc, order, val, out, dval), 4.0 * e * f)
        res["K4"] = bound(nbytes(h, gout, eop.row_ptr, src, dval), 2.0 * e * f)
        res["K5"] = bound(nbytes(g_vec, eop.row_ptr) + 4 * eop.num_out, e)
        # (E, F): g once, row_ptr once, the f32 rows once; an add an element
        res["K5_mat"] = bound(nbytes(g_mat, eop.row_ptr) + 4 * eop.num_out * f, e * f)
        del out, dval
        shape = (eop.num_out, eop.num_in)
        lib = {}
        spmm_library(lib, {"row_ptr": eop.row_ptr, "col": src}, val, shape, h, dt)
        res["K3"].update(lib)
        # dh's yardstick: sparse.mm of the transposed CSR (its values val[order])
        lib = {}
        spmm_library(lib, {"row_ptr": trp, "col": tc}, val[order.long()], (eop.num_in,
                                                                            eop.num_out),
                     gout, dt)
        res["K3_dh"].update(lib)
        res["K3_dh_dval"]["library_ms"] = None
        if dt == torch.float32:
            pattern = torch.sparse_csr_tensor(eop.row_ptr, src, torch.ones_like(val), size=shape)
            ht = h.t()
            res["K4"]["library_ms"] = library_ms(
                lambda: torch.sparse.sampled_addmm(pattern, gout, ht, beta=0.0),
                "torch.sparse.sampled_addmm float32")
            del pattern
            # two calls, sparse.mm + sampled_addmm, summed
            if res["K4"]["library_ms"] is not None and lib.get("library_ms") is not None:
                res["K3_dh_dval"]["library_ms"] = lib["library_ms"] + res["K4"]["library_ms"]
                res["K3_dh_dval"]["library_calls"] = ("torch.sparse.mm + "
                                                      "torch.sparse.sampled_addmm")
        dst_l = dst.long()
        res["K5"]["library_ms"] = library_ms(
            lambda: torch.zeros(eop.num_out, device="cuda").index_add_(0, dst_l, g_vec),
            "index_add_")
        g_mat32 = g_mat.float()
        res["K5_mat"]["library_ms"] = library_ms(
            lambda: torch.zeros((eop.num_out, f), device="cuda").index_add_(0, dst_l, g_mat32),
            "index_add_")
        del g_mat32
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_dyn(name: str, op, f: int, seed: int, timed: bool,
                csr: dict | None = None) -> dict:
    """K7: op.apply (forward, then dh and dval in its backward's one fused
    pass) and the dh pass alone vs hyb_dynamic_pass_plain on the same CUDA
    tensors; val is random per edge. Timed: each pass's ms (CUDA events:
    the table's layout, the zero-filled output, the launch and, for the
    fused pass, the gather into edge order) and, apart, its kernel's device
    ms (`*_kernel_ms`), bounds and library calls."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_dynamic_pass, hyb_dynamic_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, op.num_in, f)
    gout = randn(gen, op.num_out, f)
    val = randn(gen, op.fwd["n_edges"])
    gd = op.gather_dtype
    hk = h.clone().requires_grad_(True)
    vk = val.clone().requires_grad_(True)
    before = launch_counts()
    out = op.apply(hk, vk)
    out.backward(gout)
    dh_alone = hyb_dynamic_pass(gout, op.bwd, op.num_in, val, gd)
    torch.cuda.synchronize()
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": "K7", "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    ran = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    check(ran == {"K7": 1, "K7_dh": 1, "K7_dh_dval": 1},
          f"{name} F={f} {dtype}: K7 launched {ran}, want one forward, one fused pass and "
          f"one dh alone")
    close(res, "K7", "fwd", out.detach(),
          hyb_dynamic_pass_plain(h, op.fwd, op.num_out, val, gd), dtype)
    del out
    ref_dh, ref_dval = hyb_dynamic_pass_plain(gout, op.bwd, op.num_in, val, gd, other=h)
    close(res, "K7_dh_dval", "dh", hk.grad, ref_dh[: h.shape[0]], dtype)
    close(res, "K7_dh_dval", "dval", vk.grad, ref_dval, dtype)
    close(res, "K7_dh", "dh_alone", dh_alone, ref_dh, dtype)
    del ref_dh, ref_dval, hk, vk, dh_alone
    if timed:
        for key, plan, kern, plain in (
            ("fwd", op.fwd, lambda: hyb_dynamic_pass(h, op.fwd, op.num_out, val, gd),
             lambda: hyb_dynamic_pass_plain(h, op.fwd, op.num_out, val, gd)),
            ("dh", op.bwd, lambda: hyb_dynamic_pass(gout, op.bwd, op.num_in, val, gd),
             lambda: hyb_dynamic_pass_plain(gout, op.bwd, op.num_in, val, gd)),
            ("bwd", op.bwd, lambda: hyb_dynamic_pass(gout, op.bwd, op.num_in, val, gd, other=h),
             lambda: hyb_dynamic_pass_plain(gout, op.bwd, op.num_in, val, gd, other=h)),
        ):
            res[f"{key}_ms"] = cuda_ms(kern, 20)
            kernel_split(res, key, plan, kern)
            res[f"{key}_plain_ms"] = cuda_ms(plain, 3)
        # forward: a row index per live slot and each value once (K3's
        # row_ptr, src and val); the backward's bounds add the permutation
        elt = 2 if gd is torch.bfloat16 else 4
        res.update(pass_bound(op.num_in, f, elt, live_slots(op.fwd), op.num_out, 4,
                              extra_bytes=nbytes(val)))
        res["dh"] = dyn_dh_bound(op, f, elt, val)
        res["bwd"] = dyn_bwd_bound(op, f, elt, val)
        dyn_library(res, csr, val, (op.num_out, op.num_in), h, gout, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def compare_degree(name: str, op, f: int, seed: int, timed: bool,
                   csr: dict | None = None, key: str = "degree") -> dict:
    """The degree pass on degree plans: K1 (apply_static), K2 (apply_dst:
    forward, dh, d_dst) and K7 (apply: forward, dh, dval; and dh alone) vs
    degree_pass_plain and the torch row scale / row-dot around it. key: the
    MAX_ERR entry ("degree_sharded" for a rank's plans, whose csr names the
    table rows the plan's edges read, `src_rows`)."""
    from dorylus_tpu_torch.ops.degree_spmm import degree_pass, degree_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = randn(gen, op.num_in, f)
    gout = randn(gen, op.num_out, f)
    val = randn(gen, op.fwd["n_edges"])
    dst_val = randn(gen, op.num_out)
    gd = op.gather_dtype
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": key, "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    n = h.shape[0]

    def plain(table, plan, num, mode, other=None):
        return degree_pass_plain(table, plan, num, gd, mode, val, other)

    hs = h.clone().requires_grad_(True)
    out = op.apply_static(hs)
    out.backward(gout)
    close(res, key, "static_fwd", out.detach(), plain(h, op.fwd, op.num_out, "static"),
          dtype)
    close(res, key, "static_bwd", hs.grad,
          plain(gout, op.bwd, op.num_in, "static")[:n], dtype)
    del out, hs
    hd = h.clone().requires_grad_(True)
    dd = dst_val.clone().requires_grad_(True)
    out = op.apply_dst(hd, dd)
    out.backward(gout)
    u = plain(h, op.fwd, op.num_out, "mask")
    close(res, key, "dst_fwd", out.detach(), u * dst_val[:, None], dtype)
    close(res, key, "dst_bwd", hd.grad,
          plain(gout * dst_val[:, None], op.bwd, op.num_in, "mask")[:n], dtype)
    close(res, key, "d_dst", dd.grad, (u * gout).sum(-1), dtype)
    del out, hd, dd, u
    hy = h.clone().requires_grad_(True)
    vy = val.clone().requires_grad_(True)
    out = op.apply(hy, vy)
    out.backward(gout)
    close(res, key, "dyn_fwd", out.detach(), plain(h, op.fwd, op.num_out, "dynamic"),
          dtype)
    del out
    ref_dh, ref_dval = plain(gout, op.bwd, op.num_in, "dynamic", other=h)
    close(res, key, "dyn_dh", hy.grad, ref_dh[:n], dtype)
    close(res, key, "dyn_dval", vy.grad, ref_dval, dtype)
    close(res, key, "dyn_dh_alone", degree_pass(gout, op.bwd, op.num_in, gd, "dynamic", val),
          ref_dh, dtype)
    del ref_dh, ref_dval, hy, vy
    if timed:
        for key, mode, iters in (("static", "static", 20), ("mask", "mask", 20),
                                 ("dyn", "dynamic", 20)):
            res[f"{key}_fwd_ms"] = cuda_ms(
                lambda: degree_pass(h, op.fwd, op.num_out, gd, mode, val), iters)
            if mode != "mask":
                kernel_split(res, f"{key}_fwd", op.fwd,
                             lambda: degree_pass(h, op.fwd, op.num_out, gd, mode, val))
            res[f"{key}_fwd_plain_ms"] = cuda_ms(
                lambda: plain(h, op.fwd, op.num_out, mode), 3)
        for key, mode, other in (("static_bwd", "static", None), ("dyn_dh", "dynamic", None),
                                 ("dyn_bwd", "dynamic", h)):
            def kern():
                return degree_pass(gout, op.bwd, op.num_in, gd, mode, val, other)
            res[f"{key}_ms"] = cuda_ms(kern, 20)
            if mode == "dynamic":
                kernel_split(res, key, op.bwd, kern)
            res[f"{key}_plain_ms"] = cuda_ms(
                lambda: plain(gout, op.bwd, op.num_in, mode, other), 3)
        elt = 2 if gd is torch.bfloat16 else 4
        res.update(pass_bound(csr.get("src_rows", op.num_in), f, elt, live_slots(op.fwd),
                              op.num_out, 4 + elt))
        res["dh"] = dyn_dh_bound(op, f, elt, val)
        res["bwd"] = dyn_bwd_bound(op, f, elt, val)
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
    from dorylus_tpu_torch.tools.gather_bench import device_split

    # the K6 launches' own device ms per build (the rest: h's copy)
    res["kernel_ms"] = device_split(torch, lambda: build_pair_table(h, levels, table_size), 20,
                                    re.compile("pair_level_kernel"))[0]

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
    # The same function by PyTorch calls: h copied into the table
    # (`copy_`), then each level's rows in one `embedding_bag` (a bag of
    # the pair's two rows, summed) from the table the level reads; the
    # library time is the sum of those calls, and each level's beside
    # level_ms.
    lib_tbl = torch.empty_like(tbl)
    copy_ms = library_ms(lambda: lib_tbl[:v].copy_(h), "copy_")
    lib_tbl[:v].copy_(h)
    res["library_level_ms"] = []
    base = v
    for p in levels:
        bags, rows = p.long(), tbl[:base]
        got = torch.nn.functional.embedding_bag(bags, rows, mode="sum")
        close(res, None, f"library_level{len(res['library_level_ms'])}", got,
              tbl[base: base + p.shape[0]], dtype)
        res["library_level_ms"].append(library_ms(
            lambda: torch.nn.functional.embedding_bag(bags, rows, mode="sum"),
            "embedding_bag"))
        base += p.shape[0]
    res["library_ms"] = (None if copy_ms is None or None in res["library_level_ms"]
                         else copy_ms + sum(res["library_level_ms"]))
    del lib_tbl
    print("compare " + json.dumps(res), flush=True)
    return res


def compare_reuse(rop, hop, f: int, gd, seed: int, case: str = "community",
                  key: str = "reuse") -> dict:
    """The reuse pass: K2 over the K6-built table of the rewritten plan,
    forward and dh, vs the plain mask pass on the same tables, and vs K2
    over the original edges (the same sums; a bf16 pair row rounds once, not
    twice); times of both and of the unrewritten pass. rop: a ReuseSpMM or
    one rank's ShardedReuseSpMM (num_in table rows, num_out output rows);
    hop: the hyb op over the same edges."""
    from dorylus_tpu_torch.ops.hyb_spmm import hyb_mask_pass, hyb_mask_pass_plain
    from dorylus_tpu_torch.ops.reuse_spmm import build_pair_table

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_in, n_out = rop.num_in, rop.num_out
    h = randn(gen, n_in, f)
    gout = randn(gen, n_out, f)
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": case, "kernel": key, "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    tbl = build_pair_table(h, rop.lvl_fwd, rop.fwd_table_size)
    out = hyb_mask_pass(tbl, rop.fwd, n_out, gd)
    close(res, key, "vs_plain", out, hyb_mask_pass_plain(tbl, rop.fwd, n_out, gd), dtype)
    close(res, None, "vs_unrewritten", out, hyb_mask_pass(h, hop.fwd, n_out, gd), dtype)
    gtbl = build_pair_table(gout, rop.lvl_bwd, rop.bwd_table_size)
    dh = hyb_mask_pass(gtbl, rop.bwd, n_in, gd)
    close(res, key, "bwd_vs_plain", dh, hyb_mask_pass_plain(gtbl, rop.bwd, n_in, gd), dtype)
    close(res, None, "bwd_vs_unrewritten", dh, hyb_mask_pass(gout, hop.bwd, n_in, gd), dtype)
    del out, dh, gtbl
    res["fwd_ms"] = cuda_ms(lambda: hyb_mask_pass(tbl, rop.fwd, n_out, gd), 20)
    res["fwd_plain_ms"] = cuda_ms(lambda: hyb_mask_pass_plain(tbl, rop.fwd, n_out, gd), 3)
    res["unrewritten_fwd_ms"] = cuda_ms(lambda: hyb_mask_pass(h, hop.fwd, n_out, gd), 20)
    if gd is rop.gather_dtype:
        res["unit_fwd_ms"] = cuda_ms(lambda: rop.apply_unit(h), 20)  # K6 + K2
    elt = 2 if gd is torch.bfloat16 else 4
    res.update(pass_bound(rop.fwd_table_size, f, elt, live_slots(rop.fwd), n_out, 4))
    csr = csr_pattern(rop.plan_fwd.src, rop.plan_fwd.dst, n_out)
    spmm_library(res, csr, torch.ones(csr["col"].shape[0], device="cuda"),
                 (n_out, rop.fwd_table_size), tbl, DTYPES[dtype])
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
    fop: a fused ShardedHybSpMM with static values."""
    from dorylus_tpu_torch.ops import hyb_sharded, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    out = torch.zeros((op.num_out, 8), device="cuda")
    e = eop.num_edges
    col = eop.t_col
    val = torch.ones(e, device="cuda")
    fout = torch.zeros((fop.vp, 8), device="cuda")
    idx = torch.zeros(4, dtype=torch.int32, device="cuda")
    before = launch_counts()
    for bad in (torch.float16, torch.float64):
        tb = torch.zeros((op.num_in, 8), dtype=bad, device="cuda")
        calls = {
            "K1": lambda: hyb_spmm._launch_pass(tb, op.fwd, out),
            "K2": lambda: hyb_spmm._launch_pass(tb, op.fwd, out, unit=True),
            "K3": lambda: spmm._launch_csr_spmm(tb, eop.row_ptr, col, val, None, out),
            "K4": lambda: spmm._launch_sddmm(tb, tb, eop.row_ptr, col,
                                             torch.zeros(e, device="cuda")),
            "K3_dh_dval": lambda: spmm._launch_csr_spmm_dval(
                tb, tb, eop.t_row_ptr, col, val, eop.order, out,
                torch.zeros(e, device="cuda")),
            "K5": lambda: spmm._launch_segment_sum(val.to(bad), eop.row_ptr,
                                                   torch.zeros(eop.num_out, device="cuda")),
            "K6": lambda: reuse_spmm._launch_level(
                torch.zeros((rop.fwd_table_size, 8), dtype=bad, device="cuda"),
                rop.lvl_fwd[0], rop.num_in),
            "K7": lambda: hyb_spmm._launch_dyn_pass(
                tb, op.fwd, torch.ones(op.fwd["n_edges"], device="cuda"), out),
            "K8": lambda: hyb_sharded._launch_fused_pass(
                torch.zeros((fop.vp, 8), dtype=bad, device="cuda"),
                torch.zeros((fop.table - fop.vp, 8), dtype=bad, device="cuda"),
                fop.fwd, fout, unit=False),
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
            "K3": spmm.SPMM_LAUNCHES, "K3_dh": spmm.SPMM_T_LAUNCHES,
            "K3_dh_dval": spmm.SPMM_DVAL_LAUNCHES, "K4": spmm.SDDMM_LAUNCHES,
            "K5": spmm.SEGSUM_LAUNCHES, "K6": reuse_spmm.PAIR_LAUNCHES,
            "K7": hyb_spmm.DYN_LAUNCHES, "K7_dh": hyb_spmm.DYN_T_LAUNCHES,
            "K7_dh_dval": hyb_spmm.DYN_DVAL_LAUNCHES, "K8": hyb_sharded.FUSED_LAUNCHES,
            "K8_pure": hyb_sharded.FUSED_PURE_LAUNCHES,
            "K9": halo.PACK_LAUNCHES, "K10": halo.HALO_BWD_LAUNCHES,
            "degree": degree_spmm.DEGREE_LAUNCHES}


def reset_counts() -> None:
    from dorylus_tpu_torch.ops import degree_spmm, hyb_sharded, hyb_spmm, reuse_spmm, spmm
    from dorylus_tpu_torch.parallel import halo

    hyb_spmm.KERNEL_LAUNCHES = hyb_spmm.MASK_LAUNCHES = hyb_spmm.DYN_LAUNCHES = 0
    hyb_spmm.DYN_T_LAUNCHES = hyb_spmm.DYN_DVAL_LAUNCHES = 0
    spmm.SPMM_LAUNCHES = spmm.SPMM_T_LAUNCHES = spmm.SPMM_DVAL_LAUNCHES = 0
    spmm.SDDMM_LAUNCHES = spmm.SEGSUM_LAUNCHES = 0
    reuse_spmm.PAIR_LAUNCHES = degree_spmm.DEGREE_LAUNCHES = 0
    hyb_sharded.FUSED_LAUNCHES = halo.PACK_LAUNCHES = halo.HALO_BWD_LAUNCHES = 0
    hyb_sharded.FUSED_PURE_LAUNCHES = 0


def step_launches(step) -> dict:
    """Kernel launches of one call of `step` (a train step: loss, backward,
    Adam), the non-zero counts only."""
    reset_counts()
    step()
    torch.cuda.synchronize()
    return {k: n for k, n in launch_counts().items() if n}


def train(g, layers, cfg, label: str):
    """Engine.run() on the card (the epoch's CUDA graphs, one epoch a group)
    with every launch count set to 0 just before; returns (engine, report,
    launch counts read just after)."""
    from dorylus_tpu_torch.engine.engine import Engine

    reset_counts()
    t0 = time.perf_counter()
    # one epoch a group, so that each record times one epoch (a replay
    # after the first) and its host read; phase 11 times whole groups
    eng = Engine(g, layers, dataclasses.replace(cfg, epochs_per_call=1), device="cuda")
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
    launched, finite (V, C) predictions; warm epoch and train step ms, the
    step also with staleness 1."""
    from dorylus_tpu_torch.engine.engine import StaleWindow

    eng, rep, counts = train(g, layers, cfg, label)
    losses = [e.loss for e in rep.epochs]
    check(losses[-1] < losses[0], f"{label}: training loss did not fall")
    check(counts[kernel] > 0, f"{label}: the main path launched no {kernel}")
    # the run's cost and memory notes (engine/profiling.py)
    hbm, cost = rep.notes.get("hbm"), rep.notes.get("cost")
    total = torch.cuda.get_device_properties(0).total_memory
    check(hbm is not None and 0 < hbm["peak_bytes_in_use"] <= total
          and cost is not None and cost["chip_seconds"] > 0,
          f"{label}: notes hbm {hbm} / cost {cost} (card memory {total} bytes)")
    print(f"{label} notes: hbm {json.dumps(hbm)}, cost {json.dumps(cost)}", flush=True)
    logits = eng.predict()
    check(logits.shape == (g.num_vertices, layers.dims[-1])
          and bool(np.isfinite(logits).all()),
          f"{label}: predict gave {logits.shape} or non-finite values")
    warm_epoch_ms = float(np.mean([e.time_ms for e in rep.epochs][1:]))
    # train step alone (loss, backward, Adam; no eval), for comparison with
    # bench.py's eval_every=0 epochs
    step_ms = cuda_ms(lambda: eng._train_epoch(cfg.learning_rate), 5)
    per_step = step_launches(lambda: eng._train_epoch(cfg.learning_rate))
    # the same step with staleness 1: gradients at the window's oldest copy
    # (through torch.func.functional_call), then the window's roll
    window = StaleWindow(eng.params, 1)

    def stale_step():
        eng._train_epoch(cfg.learning_rate, window.oldest)
        window.roll(eng.params)

    s1_step_ms = cuda_ms(stale_step, 5)
    print(f"{label} warm epoch (with eval) {warm_epoch_ms:.3f} ms, train step "
          f"{step_ms:.3f} ms (staleness 1: {s1_step_ms:.3f}), launches per train step "
          f"{json.dumps(per_step)}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_steps(eng, cfg, label)
    del eng
    torch.cuda.empty_cache()
    return counts, {"warm_epoch_ms": warm_epoch_ms, "step_ms": step_ms,
                    "s1_step_ms": s1_step_ms, "launches_per_step": per_step}


def stage_phase(g, layers) -> dict:
    """Phase 8: Engine.profile(iters=20) on the Reddit-config GCN and GAT
    (kernel="hyb", bf16 gather tables), before any torch.profiler session
    in this process (a session slows every later launch on the host):
    first each layer's aggregate brackets once with the launch counts set
    to 0, which must launch the model's kernel (K1 for GCN, K2 for GAT) 3
    times (the forward; the backward bracket's forward and dh) and nothing
    else; then the profile, whose
    brackets must be JAX's, finite and > 0. Returns {model: {bracket: ms}}
    and the brackets' widths, and the two engines, which phase 11 trains
    (the profile steps no param)."""
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.engine import profiling
    from dorylus_tpu_torch.engine.engine import Engine

    out, engines = {}, {}
    for model, kernel, lr in (("gcn", "K1", 0.01), ("gat", "K2", 0.005)):
        cfg = TrainConfig(epochs=1, eval_every=0, model=model, kernel="hyb",
                          agg_dtype="bfloat16", learning_rate=lr, reuse="off")
        t0 = time.perf_counter()
        eng = Engine(g, layers, cfg, device="cuda")
        widths = []
        for l, (f, fwd, bwd) in enumerate(profiling.agg_brackets(eng.model, eng.batch)):
            reset_counts()
            fwd()
            bwd()
            torch.cuda.synchronize()
            got = {k: n for k, n in launch_counts().items() if n}
            check(got == {kernel: 3}, f"phase 8 {model} aggregate_l{l} (F={f}): launches "
                                      f"{got}, want {kernel} 3 times (the forward bracket; "
                                      "the backward's forward and dh)")
            widths.append(f)
        reset_counts()
        times = eng.profile(iters=20)
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts().items() if n}
        want = {f"{s}_l{l}_ms" for l in range(layers.num_layers)
                for s in ("aggregate", "dense")}
        want |= {f"aggregate_l{l}_bwd_ms" for l in range(layers.num_layers)}
        want |= {"forward_ms", "loss_and_grad_ms"}
        check(set(times) == want, f"phase 8 {model}: brackets {sorted(times)}")
        check(all(np.isfinite(v) and v > 0 for v in times.values()),
              f"phase 8 {model}: a bracket is not finite and > 0: {times}")
        check(counts.get(kernel, 0) > 0, f"phase 8 {model}: the profile launched no {kernel}")
        print(f"phase 8 {model} Engine.profile(iters=20) ms, widths {widths} "
              f"({time.perf_counter() - t0:.1f} s with the engine): " + json.dumps(times)
              + f", launches {json.dumps(counts)}", flush=True)
        out[model] = {"stages_ms": times, "widths": widths}
        engines[model] = eng
    return out, engines


def graph_pair(eng) -> list:
    """Phase 11's comparison: the engine's run() through the eager loop,
    then through the epoch's CUDA graphs from the same init (params and
    Adam's state reset), each with the launch counts and the peak memory
    reset just before. Returns [(report, launch counts, params)] for the
    two, in that order."""
    from dorylus_tpu_torch.common.metrics import RunReport
    from dorylus_tpu_torch.optim.adam import adam_init

    init = {k: p.detach().clone() for k, p in eng.params.items()}
    out = []
    for graphs in (False, True):
        with torch.no_grad():
            for k, p in eng.params.items():
                p.copy_(init[k])
        eng.opt_state = adam_init(eng.params)
        eng.report = RunReport()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rep = eng.run(graphs=graphs)
        torch.cuda.synchronize()
        out.append((rep, launch_counts(), {k: p.detach().clone() for k, p in eng.params.items()}))
    return out


def graph_equal(label: str, pair: list, phase: str = "11") -> None:
    """The graph path equals the eager loop bit for bit: losses, evaluated
    accuracies, the final accuracies, params; the same launch counts."""
    label = f"{phase} {label}"
    (re_, ce, pe), (rg, cg, pg) = pair
    same = ([e.loss for e in rg.epochs] == [e.loss for e in re_.epochs]
            and [e.accuracy for e in rg.epochs] == [e.accuracy for e in re_.epochs]
            and (rg.final_accuracy, rg.test_accuracy) == (re_.final_accuracy,
                                                          re_.test_accuracy))
    check(same, f"phase {label}: graph losses {[e.loss for e in rg.epochs]} / accuracies "
                f"{[e.accuracy for e in rg.epochs]}, eager {[e.loss for e in re_.epochs]} / "
                f"{[e.accuracy for e in re_.epochs]}")
    diff = {k: float((pg[k] - pe[k]).abs().max()) for k in pe if not torch.equal(pg[k], pe[k])}
    check(not diff, f"phase {label}: params differ from the eager loop's: {diff}")
    check(cg == ce and sum(cg.values()) > 0,
          f"phase {label}: launches graph {json.dumps(cg)}, eager {json.dumps(ce)}")
    print(f"phase {label}: graph == eager bit for bit over {len(rg.epochs)} epochs "
          f"(losses {json.dumps([e.loss for e in rg.epochs])}), launches "
          f"{json.dumps({k: n for k, n in cg.items() if n})} on both", flush=True)


def group_times(eng, lr: float, k: int = 10) -> dict:
    """Warm epoch ms of a group of k, with eval_every 0 and 1, through the
    run's graphs and eagerly, in turns (graph, eager, eager, graph): CUDA
    events around the group's dispatch over k ("ms": the device's span,
    idle gaps included), and the host's wall time of the group with its one
    read over k ("wall_ms")."""
    from dorylus_tpu_torch.engine.engine import eager_group

    graphs = eng._graphs
    out = {}
    for every in (0, 1):
        flags = np.full(k, bool(every))
        runs = {"graph": lambda: graphs.run_group(eng, [lr] * k, flags, None),
                "eager": lambda: eager_group(eng, [lr] * k, flags, None)}
        got = {name: {"ms": [], "wall_ms": []} for name in runs}
        for name in ("graph", "eager", "eager", "graph"):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            losses, stats = runs[name]()
            end.record()
            torch.cat([losses[:, None], stats.flatten(1)], 1).tolist()
            wall = 1e3 * (time.perf_counter() - t0) / k
            got[name]["ms"].append(start.elapsed_time(end) / k)
            got[name]["wall_ms"].append(wall)
        out[f"eval_every={every}"] = got
    return out


def traced_group(eng, lr: float, label: str, k: int = 10) -> dict:
    """torch.profiler over one group of k epochs without eval, replayed and
    then eager: the kernels' device time over the host's wall time of the
    group (its read included) and over the device's span of the group (CUDA
    events around its dispatch); the device's idle share is 1 minus each,
    or None where the trace shows no kernel."""
    from torch.profiler import ProfilerActivity, profile

    from dorylus_tpu_torch.engine.engine import eager_group

    graphs = eng._graphs
    flags = np.zeros(k, bool)
    out = {}
    for name, fn in (("graph", lambda: graphs.run_group(eng, [lr] * k, flags, None)),
                     ("eager", lambda: eager_group(eng, [lr] * k, flags, None))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            losses, _ = fn()
            end.record()
            losses.tolist()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        span_ms = start.elapsed_time(end)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in rows) / 1e3
        seen = busy_ms > 0
        out[name] = {"wall_ms_per_epoch": wall_ms / k, "span_ms_per_epoch": span_ms / k,
                     "kernel_ms_per_epoch": busy_ms / k,
                     "kernels_per_epoch": sum(e.count for e in rows) / k,
                     "idle_share": (1 - busy_ms / wall_ms) if seen else None,
                     "idle_share_of_span": (1 - busy_ms / span_ms) if seen else None}
    print(f"phase 11 {label} traced group of {k}: " + json.dumps(out), flush=True)
    return out


def graph_phase(engines: dict) -> dict:
    """Phase 11 (right after phase 8, before any torch.profiler session):
    on phase 3's Reddit graph, GCN (K1) and GAT (K2) on hyb with bf16 gather
    tables (phase 8's engines: two builds fewer, their epochs and eval
    cadence set here), 8 epochs in one group with eval every 3 epochs: the eager loop,
    then the graph path from the same init, equal bit for bit (losses,
    accuracies, params, launch counts), notes["hbm"] of each; then warm
    epoch ms of groups of 10 with eval_every 0 and 1, replayed and eager.
    Returns the numbers and the GCN engine, kept for phase 11b's trace."""
    out, kept = {}, None
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        label = f"reddit-config {model} hyb bf16"
        eng = engines.pop(model)
        eng.cfg = dataclasses.replace(eng.cfg, epochs=8, eval_every=3)
        pair = graph_pair(eng)
        graph_equal(label, pair)
        hbm = {"eager": pair[0][0].notes["hbm"]["peak_bytes_in_use"],
               "graph": pair[1][0].notes["hbm"]["peak_bytes_in_use"]}
        times = group_times(eng, lr)
        print(f"phase 11 {label}: notes hbm peak bytes {json.dumps(hbm)}, warm epoch ms "
              f"of a group of 10 {json.dumps(times)}", flush=True)
        out[model] = {"hbm_peak_bytes": hbm, "group_of_10": times,
                      "losses": [e.loss for e in pair[1][0].epochs],
                      "run_epoch_ms": {"eager": [e.time_ms for e in pair[0][0].epochs],
                                       "graph": [e.time_ms for e in pair[1][0].epochs]}}
        if model == "gcn":
            kept = eng
        else:
            del eng
            torch.cuda.empty_cache()
    return out, kept


def second_run_captures_nothing(eng, label: str, kernel: str) -> float:
    """A second run() of an engine that has captured: it replays from its
    first epoch and captures nothing (its kept graphs), launching `kernel`
    with the counts at 0 just before; returns its mean epoch ms."""
    graphs, caps = eng._graphs, eng._graphs.captures
    n0 = len(eng.report.epochs)
    reset_counts()
    rep = eng.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(eng._graphs is graphs and graphs.captures == caps and counts[kernel] > 0,
          f"phase 11c {label}: a second run() captured {graphs.captures - caps} graphs "
          f"(kept: {eng._graphs is graphs}), launches {json.dumps(counts)}")
    return float(np.mean([e.time_ms for e in rep.epochs[n0:]]))


def sharded_graph_phase(g, layers, engine_res: dict, engine_eng) -> dict:
    """Phase 11c (right after phase 11, before any torch.profiler session):
    on phase 3's Reddit graph, ShardedEngine with no process group (one
    shard: the combined plan), GCN (K1) and GAT (K2) on hyb with bf16
    gather tables, phase 11's config (8 epochs in one group, eval every 3):
    the eager loop, then the graph path from one init, bit for bit (losses,
    accuracies, params, launch counts); the losses within rtol 1e-4 of
    phase 11's Engine, and whether bit for bit; the warm epoch of a
    replayed group of 10 beside phase 11's; a second run() of each engine,
    and of phase 11's GCN Engine, captures nothing."""
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    t0 = time.perf_counter()
    out = {"engine_second_run_ms": second_run_captures_nothing(engine_eng, "Engine gcn", "K1")}
    for model, lr, kernel in (("gcn", 0.01, "K1"), ("gat", 0.005, "K2")):
        label = f"reddit-config {model} hyb bf16 ShardedEngine (no group)"
        cfg = TrainConfig(epochs=8, eval_every=3, model=model, kernel="hyb",
                          agg_dtype="bfloat16", learning_rate=lr, reuse="off")
        t1 = time.perf_counter()
        eng = ShardedEngine(g, layers, cfg, device="cuda")
        build_s = time.perf_counter() - t1
        check(eng.graph_refusal is None and eng.n == 1 and eng.halo_plan is None,
              f"phase 11c {label}: refusal {eng.graph_refusal}, {eng.n} shards")
        pair = graph_pair(eng)
        graph_equal(label, pair, phase="11c")
        check(pair[1][1][kernel] > 0, f"phase 11c {label}: no {kernel} in the graph run")
        losses = [e.loss for e in pair[1][0].epochs]
        gap = rel_gap(losses, engine_res[model]["losses"])
        bitwise = losses == engine_res[model]["losses"]
        check(gap <= 1e-4, f"phase 11c {label}: losses {losses} against the Engine's "
                           f"{engine_res[model]['losses']}: rtol {gap:.3e} > 1e-4")
        second_ms = second_run_captures_nothing(eng, label, kernel)
        times = group_times(eng, lr)
        hbm = {"eager": pair[0][0].notes["hbm"]["peak_bytes_in_use"],
               "graph": pair[1][0].notes["hbm"]["peak_bytes_in_use"]}
        warm = {k: float(np.median(v["graph"]["ms"])) for k, v in times.items()}
        engine_warm = {k: float(np.median(v["graph"]["ms"]))
                       for k, v in engine_res[model]["group_of_10"].items()}
        agree = "bit for bit" if bitwise else f"within rtol {gap:.3e}"
        print(f"phase 11c {label}: built in {build_s:.1f} s; losses {agree} "
              f"of the Engine's; a second run() captured nothing ({second_ms:.3f} ms an "
              f"epoch); replayed warm epoch ms of a group of 10 {json.dumps(warm)} beside the "
              f"Engine's {json.dumps(engine_warm)}; notes hbm peak bytes {json.dumps(hbm)}; "
              f"group of 10 {json.dumps(times)}", flush=True)
        out[model] = {"build_s": build_s, "loss_rtol": gap, "bitwise": bitwise,
                      "second_run_ms": second_ms, "group_of_10": times, "hbm_peak_bytes": hbm,
                      "launches": pair[1][1]}
        del eng, pair
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11c {out['seconds']:.1f} s", flush=True)
    return out


def graph_phase_b(eng, gs, layers) -> dict:
    """Phase 11b (after phase 5, where torch.profiler sessions have run):
    one traced group of 10 of phase 11's GCN engine, replayed and eager,
    for the device's idle share; then on phase 5's 4,000-vertex community
    graph, 3 epochs at staleness 1 (eval every epoch): xla (K3/K4/K5),
    degree in f32 (K7) and reuse="pairs" (K6, K2), GCN and GAT, the graph
    path equal to the eager loop bit for bit."""
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.engine.engine import Engine

    out = {"trace": traced_group(eng, 0.01, "reddit-config gcn hyb bf16")}
    for kernel, kw in (("xla", {}), ("degree", {}), ("hyb", {"reuse": "pairs", "reuse_passes": 2})):
        for model, lr in (("gcn", 0.01), ("gat", 0.005)):
            kw.setdefault("reuse", "off")
            label = f"community {model} {kernel} f32 reuse={kw['reuse']} staleness 1"
            cfg = TrainConfig(epochs=3, eval_every=1, model=model, kernel=kernel,
                              learning_rate=lr, staleness=1, **kw)
            graph_equal(label, graph_pair(Engine(gs, layers, cfg, device="cuda")))
    torch.cuda.empty_cache()
    return out


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
        kernel_split(res, "fwd", op.fwd,
                     lambda: hyb_sharded.fused_pass(h, gh, op.fwd, op.n_pure, gd, mode))
        res["fwd_plain_ms"] = cuda_ms(
            lambda: hyb_sharded.fused_pass_plain(h, gh, op.fwd, op.n_pure, gd, mode), 3)
        # the backward is K1/K2 over the transpose plan into one buffer
        res["bwd_ms"] = cuda_ms(lambda: op._pass(gout, op.bwd, op.table, mode), 20)
        kernel_split(res, "bwd", op.bwd, lambda: op._pass(gout, op.bwd, op.table, mode))
        res["bwd_plain_ms"] = cuda_ms(lambda: _hyb_pass_plain(gout, op.bwd, op.table, gd, mode),
                                      3)
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
        # the backward (JAX `_fused_bwd_pass`): the transpose plan over gout
        # into one (table, F) buffer; its bound, and sparse.mm of the
        # transposed CSR with gout
        res["bwd"] = pass_bound(vp, f, elt, live_slots(op.bwd), op.table,
                                4 + (elt if mode == "static" else 0))
        spmm_library(res["bwd"], csr["t"], csr["t"]["norm" if mode == "static" else "ones"],
                     (op.table, vp), gout, DTYPES[dtype])
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def compare_fused_ranges(name: str, op, f: int, seed: int, timed: bool) -> dict:
    """K8 as the engines launch it (ops/hyb_sharded.py): the pure range
    (fused_pure_pass, before the exchange's finish), then the mixed buckets
    and the hub top into the same output (fused_mixed_pass). Each range
    against its plain half on the same CUDA tensors (the mixed range alone,
    into a zeroed output), launches 1 + 1 (the pure range none where the
    plan has no pure bucket), and the two ranges bit for bit against one
    launch over every part (fused_pass). Where timed: the pass ms of each
    range, of both, of the one launch and of the plain halves, and each
    range's kernel-only ms."""
    from dorylus_tpu_torch.ops import hyb_sharded as hs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    vp, ng, f_plan = op.vp, op.table - op.vp, op.fwd
    h, gh = randn(gen, vp, f), randn(gen, ng, f)
    gd = op.gather_dtype
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    mode = "static" if op.has_static_vals else "mask"
    res = {"case": name, "kernel": "K8 ranges", "mode": mode, "F": f, "dtype": dtype,
           "tol_rel": TOL[dtype], "n_pure": op.n_pure, "pure_edges": op.pure_edges,
           "mixed_edges": op.mixed_edges,
           "parts": [len(f_plan[k]["parts"].parts) for k in ("pure", "mixed")]}
    before = (hs.FUSED_LAUNCHES, hs.FUSED_PURE_LAUNCHES)
    pure = hs.fused_pure_pass(h, f_plan, op.n_pure, gd, mode)
    pure_out = pure.out.clone()
    got = hs.fused_mixed_pass(pure, gh, f_plan, op.n_pure, gd, mode)
    torch.cuda.synchronize()
    res["launches"] = [hs.FUSED_LAUNCHES - before[0], hs.FUSED_PURE_LAUNCHES - before[1]]
    check(res["launches"] == ([2, 1] if op.n_pure else [1, 0]),
          f"{name}: K8 ranges launched {res['launches']} (all, pure)")
    want_pure = hs.fused_pure_plain(h, f_plan, op.n_pure, gd, mode)
    close(res, "K8", "pure", pure_out, want_pure.out, dtype)
    mixed = hs.fused_mixed_pass(hs.PureRange(torch.zeros_like(pure.out), pure.h_table), gh,
                                f_plan, op.n_pure, gd, mode)
    want_mixed = hs.fused_mixed_plain(hs.PureRange(torch.zeros_like(want_pure.out),
                                                   want_pure.h_table), gh, f_plan, op.n_pure,
                                      gd, mode)
    close(res, "K8", "mixed", mixed, want_mixed, dtype)
    one = hs.fused_pass(h, gh, f_plan, op.n_pure, gd, mode)
    check(torch.equal(got, one), f"{name} F={f} {dtype}: the two K8 ranges differ from one "
          "launch over every part")
    res["ranges_equal_one_launch"] = True
    del pure_out, mixed, want_mixed, one
    if timed:
        def both():
            return hs.fused_mixed_pass(hs.fused_pure_pass(h, f_plan, op.n_pure, gd, mode), gh,
                                       f_plan, op.n_pure, gd, mode)

        res["pure_ms"] = cuda_ms(lambda: hs.fused_pure_pass(h, f_plan, op.n_pure, gd, mode), 20)
        res["mixed_ms"] = cuda_ms(lambda: hs.fused_mixed_pass(pure, gh, f_plan, op.n_pure, gd,
                                                              mode), 20)
        res["both_ms"] = cuda_ms(both, 20)
        res["one_launch_ms"] = cuda_ms(lambda: hs.fused_pass(h, gh, f_plan, op.n_pure, gd,
                                                             mode), 20)
        res["plain_ms"] = cuda_ms(lambda: hs.fused_mixed_plain(
            hs.fused_pure_plain(h, f_plan, op.n_pure, gd, mode), gh, f_plan, op.n_pure, gd,
            mode), 3)
        kernel_split(res, "pure", f_plan["pure"],
                     lambda: hs.fused_pure_pass(h, f_plan, op.n_pure, gd, mode))
        kernel_split(res, "mixed", f_plan,
                     lambda: hs.fused_mixed_pass(pure, gh, f_plan, op.n_pure, gd, mode))
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def fused_ranges_phase(g) -> list:
    """(Phase 13) K8's two ranges on shard 0 of the 4-way range partition
    of JAX's r5 clustered graph (clustered cut 0.1, in-degree 16: about a
    fifth of a shard's vertices have only local in-edges, so its pure range
    is not empty), built in this process: GCN's static op in bf16 and the
    mask op in f32, at the r5 model's aggregation widths 32 and 8 (the
    static bf16 pass at 32 timed)."""
    from dorylus_tpu_torch.graph.partition import partition_graph
    from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM

    t0 = time.perf_counter()
    shard = partition_graph(g, RANKS).shards[0]
    out = []
    for static, gd in ((True, torch.bfloat16), (False, None)):
        op = ShardedHybSpMM(shard, RANKS, edges="fused", static_vals=static, gather_dtype=gd,
                            device="cuda")
        check(op.n_pure > 0, f"r5 shard 0: no pure bucket ({op.pure_edges} pure edges)")
        for f in (32, 8):
            out.append(compare_fused_ranges(
                f"r5 shard 0/{RANKS} {'static' if static else 'mask'}", op, f, 80 + f,
                timed=static and f == 32))
        del op
    print(f"K8 ranges on the r5 shard: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def compare_hyb_split(name: str, op, f: int, seed: int) -> dict:
    """A rank's interior or boundary hyb plan (ShardedHybSpMM with static
    values): K1 through apply_static and K2 through apply_dst, forward and
    gradients, vs the plain hyb pass on the same CUDA tensors."""
    from dorylus_tpu_torch.ops.hyb_spmm import _hyb_pass_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    table, gout, dv = randn(gen, op.num_in, f), randn(gen, op.vp, f), randn(gen, op.vp)
    gd = op.gather_dtype
    dtype = "bfloat16" if gd is torch.bfloat16 else "float32"
    res = {"case": name, "kernel": "K1/K2", "F": f, "dtype": dtype, "tol_rel": TOL[dtype]}
    tk = table.clone().requires_grad_(True)
    out = op.apply_static(tk)
    out.backward(gout)
    close(res, "K1", "static_fwd", out.detach(),
          _hyb_pass_plain(table, op.fwd, op.vp, gd, "static"), dtype)
    close(res, "K1", "static_bwd", tk.grad,
          _hyb_pass_plain(gout, op.bwd, op.num_in, gd, "static"), dtype)
    tk, dk = table.clone().requires_grad_(True), dv.clone().requires_grad_(True)
    out = op.apply_dst(tk, dk)
    out.backward(gout)
    u = _hyb_pass_plain(table, op.fwd, op.vp, gd, "mask")
    close(res, "K2", "dst_fwd", out.detach(), u * dv[:, None], dtype)
    close(res, "K2", "dst_bwd", tk.grad,
          _hyb_pass_plain(gout * dv[:, None], op.bwd, op.num_in, gd, "mask"), dtype)
    close(res, "K2", "d_dst", dk.grad, (u * gout).sum(-1), dtype)
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
        from dorylus_tpu_torch.tools.gather_bench import device_split, enqueue_us

        passes = {"K9": lambda: halo.row_gather(h, plan.pack),
                  "K10": lambda: halo.segsum_gather(back, plan.order, plan.rows,
                                                    plan.row_ptr, plan.vp)}
        if recv is not None:
            passes["K9_place"] = lambda: halo.row_gather(recv, plan.place)
        # pass ms (CUDA events), the kernel's own device ms (torch.profiler)
        # and the host's microseconds to enqueue one pass
        for key, fn in passes.items():
            res[f"{key}_ms"] = cuda_ms(fn, 20)
            res[f"{key}_kernel_ms"] = device_split(torch, fn, 20)[0]
            res[f"{key}_host_us"] = enqueue_us(torch, fn)
        res["K9_plain_ms"] = cuda_ms(lambda: halo.row_gather_plain(h, plan.pack), 5)
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
        if recv is not None:
            # the placement reads every received row once and writes every
            # ghost slot (a dead one as zeros), an index a slot
            slots = int(plan.place.shape[0])
            res["K9_place"] = bound(recv.shape[0] * row_b + 4 * slots + slots * row_b, 0)
            # the same function as the pack's (a row gather with -1 dead
            # slots): index_select of the rows the live slots name
            place_l = plan.place[plan.place >= 0].long()
            res["K9_place"]["library_ms"] = library_ms(lambda: recv.index_select(0, place_l),
                                                       "index_select")
        back_live = back[live]
        res["K9"]["library_ms"] = library_ms(lambda: h.index_select(0, live_l), "index_select")
        res["K10"]["library_ms"] = library_ms(
            lambda: torch.zeros((plan.vp, f), device="cuda").index_add_(0, live_l,
                                                                        back_live.float()),
            "index_add_")
    print("compare " + json.dumps(res), flush=True)
    torch.cuda.empty_cache()
    return res


def width_counter():
    """Launch counts of K1, K2, K9 and K10 by the width of the table each
    launch reads (its leading dimension), by wrapping their launchers in
    this process until the returned function is called, which restores them
    and returns {kernel: {width: launches}}. A CUDA graph replay adds what
    its capture counted (engine/graphs.py LAUNCH_TALLIES)."""
    from dorylus_tpu_torch.engine import graphs
    from dorylus_tpu_torch.ops import hyb_spmm
    from dorylus_tpu_torch.parallel import halo

    seen: dict = {}  # "kernel width": launches, listed where graph replays add theirs
    graphs.LAUNCH_TALLIES.append(seen)

    def note(kernel, width):
        key = f"{kernel} {width}"
        seen[key] = seen.get(key, 0) + 1

    launch_pass, row_gather, segsum = (hyb_spmm._launch_pass, halo._launch_row_gather,
                                       halo._launch_segsum)

    def pass_(tb, plan, out, unit=False):
        n = launch_pass(tb, plan, out, unit)
        for _ in range(n):
            note("K2" if unit else "K1", tb.shape[1])
        return n

    def gather_(x, idx, out):
        launched = row_gather(x, idx, out)
        if launched:
            note("K9", x.shape[1])
        return launched

    def segsum_(g, order, row_ptr, out):
        launched = segsum(g, order, row_ptr, out)
        if launched:
            note("K10", g.shape[1])
        return launched

    hyb_spmm._launch_pass, halo._launch_row_gather, halo._launch_segsum = (
        pass_, gather_, segsum_)

    def restore():
        hyb_spmm._launch_pass, halo._launch_row_gather, halo._launch_segsum = (
            launch_pass, row_gather, segsum)
        graphs.LAUNCH_TALLIES.remove(seen)
        by_kernel: dict = {}
        for key, n in seen.items():
            kernel, width = key.split()
            by_kernel.setdefault(kernel, {})[width] = n
        return by_kernel

    return restore


def sharded_rank(rank: int, world: int, device, shard_dir: str, runs: list,
                 native_miner: bool = True) -> list:
    """One rank of phases 6-6f and 9 (started by multihost.spawn_local):
    for each run, a ShardedEngine on this rank's shard file (shard rank //
    feat_shards) on the run's "device" (the launch's where it names none),
    trained with this process's launch counts set to 0 just
    before and read just after (with "widths", also by table width); where
    the run is timed, also the train step's ms and launches and the halo
    exchange's ms at each layer's aggregation width; with "stages", the
    engine's stage profile (before any trace in the run); where it is
    profiled, a profile of the step. Each run also reports the exchanges
    its training split around the interior work, forward and reverse
    (multihost.EXCHANGES, set to 0 just before the run: started, held, the
    host's and the card's ms, the reverse ones under "bwd_") and its fused
    plan's pure and mixed edges. native_miner False: the parent found
    that native/libgraphcore.so does not build on this host, so the rank
    does not try again (each try costs seconds) and mines with numpy."""
    from dorylus_tpu_torch import native
    from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel import multihost
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine

    if not native_miner:
        native._tried = True

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = []
    for run in runs:
        dev = run.get("device") or device
        on_card = torch.device(dev).type == "cuda"
        if not on_card:
            torch.set_num_threads(2)
        cfg = TrainConfig(**run["cfg"])
        shard, meta = load_shard(f"{shard_dir}/{run['shards']}_{rank // cfg.feat_shards}.npz")
        if cfg.model == "gat":
            # a GAT partition differs from the GCN one in its edge values
            # alone: 1 on every real edge (the edgewise path's edge mask)
            shard = dataclasses.replace(shard, edge_val=np.ones_like(shard.edge_val))
        reset_counts()
        t0 = time.perf_counter()
        eng = ShardedEngine((shard, meta), LayerConfig(run["dims"]), cfg, device=dev)
        build_s = time.perf_counter() - t0
        restore = width_counter() if run.get("widths") else None
        multihost.reset_exchanges()
        rep = eng.run(graphs=not run.get("eager"))
        sync()
        exchanges = dict(multihost.EXCHANGES)
        row = {"label": run["label"], "rank": rank, "backend": multihost.backend_name(),
               "epoch_timing": "replayed" if eng._graphs is not None else "eager",
               "mesh": list(eng.mesh[:4]),
               "device": str(eng.device), "launches": launch_counts(),
               "losses": [e.loss for e in rep.epochs],
               "epoch_ms": [e.time_ms for e in rep.epochs], "val_acc": rep.final_accuracy,
               "build_s": build_s, "kernel": eng.kernel_selected,
               "overlap": bool(eng.cfg.overlap), "wire": eng.halo_plan.wire,
               "local_vertices": shard.num_local, "edges": shard.num_edges,
               "ghosts": int(eng.halo_plan.recv_cnt.sum()), "max_h": meta.max_h,
               "wire_rows": eng.halo_plan.wire_rows(rank), "exchanges": exchanges}
        split, op = eng.model.spmm_split, eng.model.spmm_op
        if getattr(split, "fused", False):
            row.update(n_pure=split.n_pure, pure_edges=split.pure_edges,
                       mixed_edges=split.mixed_edges)
        elif split is not None or eng.model.edge_split is not None:
            pair = split if split is not None else eng.model.edge_split
            row.update(interior_edges=pair[0].num_edges, boundary_edges=pair[1].num_edges)
        if restore is not None:
            row["launches_by_width"] = restore()
        if hasattr(op, "plan_fwd"):  # the sharded reuse op
            st = op.plan_fwd.stats
            row.update(miner=op.miner, mine_s=list(op.mine_seconds),
                       fwd_pairs=op.plan_fwd.num_pairs, bwd_pairs=op.plan_bwd.num_pairs,
                       row_cut=st["row_reduction"])
        lr = cfg.learning_rate
        if run.get("timed"):
            row["launches_per_step"] = step_launches(lambda: eng._train_epoch(lr))
            sync()
            t0 = time.perf_counter()
            for _ in range(RANK_REPEATS):
                eng._train_epoch(lr)
            sync()
            row["step_ms"] = 1e3 * (time.perf_counter() - t0) / RANK_REPEATS
            row["exchange_ms"] = {}
            elt = torch.empty((), dtype=eng.compute_dtype).element_size()
            for f in [eng.model.agg_width(l) for l in range(len(run["dims"]) - 1)]:
                h = torch.zeros((meta.vp, f), dtype=eng.compute_dtype, device=dev)
                eng.halo(h)
                sync()
                t0 = time.perf_counter()
                for _ in range(RANK_REPEATS):
                    eng.halo(h)
                sync()
                row["exchange_ms"][str(f)] = 1e3 * (time.perf_counter() - t0) / RANK_REPEATS
                row.setdefault("wire_bytes", {})[str(f)] = row["wire_rows"] * f * elt
        if run.get("stages"):
            row["stages_ms"] = eng.profile(iters=3)
        if run.get("profile"):
            row["profile"] = profile_rank(eng, lr)
        if run.get("predict"):
            row["predict"] = eng.predict()
        del eng
        if on_card:
            torch.cuda.empty_cache()
        out.append(row)
    return out


def profile_rank(eng, lr: float, steps: int = 2) -> dict:
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


def tp_phase(by_label: dict, hyb_f32_losses: dict) -> dict:
    """Phase 9's checks and numbers, from its runs in phase 6's launch: 4
    ranks on the one card over gloo, 2 graph x 2 feat shards at the Reddit
    config. GCN (hyb, f32 gather) within rtol 1e-4 of phase 4c's
    single-device hyb f32 losses; GAT (hyb, bf16 gather) finite and
    falling; K1/K2 launched at F = 64 on every rank and K9/K10 at 64 (GAT's
    output layer at 41); the step's ms, host-bound (gloo on one card); rank
    0's stage profile under TP. Returns the launches at F = 64 and the
    timings."""
    gcn, gat = by_label["gcn f32 tp 2x2"], by_label["gat bf16 tp 2x2"]
    for label, rows in (("gcn f32 tp 2x2", gcn), ("gat bf16 tp 2x2", gat)):
        check([r["mesh"] for r in rows] == [[2, 2, r // 2, r % 2] for r in range(RANKS)],
              f"{label}: mesh {[r['mesh'] for r in rows]}")
        for r in rows:
            check((r["kernel"], r["overlap"], r["wire"]) == ("hyb", False, "ragged"),
                  f"{label}: ran {r['kernel']}, overlap {r['overlap']}, wire {r['wire']}")
    gap = rel_gap(gcn[0]["losses"], hyb_f32_losses["gcn"][: len(gcn[0]["losses"])])
    print(f"phase 9 gcn f32 tp 2x2 vs the single-device hyb f32 engine: max relative loss "
          f"gap {gap:.3e}", flush=True)
    check(gap <= 1e-4, f"phase 9: TP and one-device losses differ by {gap:.3e} > 1e-4")
    lg = gat[0]["losses"]
    check(all(np.isfinite(lg)) and lg[-1] < lg[0], f"phase 9 gat: losses {lg}")
    launches = {"K1_tp": 0, "K2_tp": 0, "K9_tp": 0, "K10_tp": 0}
    for label, rows, slot in (("gcn", gcn, "K1"), ("gat", gat, "K2")):
        for r in rows:
            w = r["launches_by_width"]
            check(w.get(slot, {}).get("64", 0) > 0 and w.get("K9", {}).get("64", 0) > 0
                  and w.get("K10", {}).get("64", 0) > 0,
                  f"phase 9 {label} rank {r['rank']}: launches by width {w}")
            check(label == "gat" or set(w[slot]) == {"64"},
                  f"phase 9 gcn rank {r['rank']}: K1 at widths {w[slot]}, want 64 only")
            for k in (slot, "K9", "K10"):
                launches[f"{k}_tp"] += w[k].get("64", 0)
            print(f"phase 9 {label} rank {r['rank']}: launches by table width "
                  f"{json.dumps(w)}, step {r['step_ms']:.1f} ms (host-bound: gloo on one "
                  f"card), exchange ms {json.dumps(r['exchange_ms'])}", flush=True)
    stages = gcn[0]["stages_ms"]
    check(all(np.isfinite(v) and v > 0 for v in stages.values()),
          f"phase 9 stages {stages}")
    print("phase 9 gcn f32 tp 2x2 ShardedEngine.profile(iters=3) ms (the max over ranks): "
          + json.dumps(stages), flush=True)
    timings = {"note": "host-bound: 4 ranks on one card over gloo",
               "gcn_f32_step_ms": [r["step_ms"] for r in gcn],
               "gat_bf16_step_ms": [r["step_ms"] for r in gat],
               "gcn_losses": gcn[0]["losses"], "gat_losses": lg,
               "exchange_ms": [r["exchange_ms"] for r in gcn], "stages_ms": stages,
               "gat_idle_share": [r["profile"]["idle_share"] for r in gat],
               "gat_kernel_ms_per_step": [r["profile"]["kernel_ms_per_step"] for r in gat],
               "gat_copy_ms_per_step": [r["profile"]["copy_ms_per_step"] for r in gat]}
    print("phase 9 gat bf16 tp 2x2 profile of the step: " + json.dumps(
        {k: v for k, v in timings.items() if k.startswith("gat_")}), flush=True)
    return {"launches": launches, "timings": timings}


def sharded_phases(sg, sg2, sgc, layers, hyb_f32_losses, kernel_sources) -> dict:
    """Phases 6, 6b-6f and 9. sg: the Reddit-shaped graph's 4-way partition;
    sg2: its 2-way partition (phase 9's graph shards); sgc: the community
    graph's; hyb_f32_losses: {model: 3 single-device hyb f32 losses} from
    phase 4c. Returns what the kernels line needs."""
    from dorylus_tpu_torch import bench, native
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.graph.graph import synthetic_graph
    from dorylus_tpu_torch.graph.partition import ShardMeta, partition_graph, save_shard
    from dorylus_tpu_torch.ops import cuda_build
    from dorylus_tpu_torch.parallel.multihost import spawn_local

    # The ranks load the libraries the parent built: nothing compiles there
    # (nor the native miner, where phase 2 found it does not build here).
    cuda_build.compile_sources(kernel_sources)
    native_miner = native.has_mine_pairs()
    shard_dir = tempfile.mkdtemp(prefix="dorylus_smoke_shards_")
    try:
        t0 = time.perf_counter()
        gp = synthetic_graph(2000, 8, REDDIT["feat"], REDDIT["classes"], seed=8888)
        gs = bench.community_graph(4000, 20, REDDIT["feat"], REDDIT["classes"], comm=40,
                                   core=30, p_core=0.85, seed=0)
        for name, part in (("reddit", sg), ("reddit2", sg2), ("community", sgc),
                           ("planted", partition_graph(gp, RANKS)),
                           ("smallcomm", partition_graph(gs, RANKS))):
            for s in part.shards:
                save_shard(f"{shard_dir}/{name}_{s.shard_id}.npz", s, ShardMeta.of(part))
        print(f"shard files: {time.perf_counter() - t0:.1f} s", flush=True)
        dims = list(layers.dims)

        def run(label, shards, timed=False, profile=False, predict=False, stages=False,
                widths=False, eager=False, **cfg):
            cfg = dict(dict(epochs=2, eval_every=1, kernel="hyb", reuse="off"), **cfg)
            return {"label": label, "shards": shards, "dims": dims, "cfg": cfg,
                    "timed": timed or profile, "profile": profile, "predict": predict,
                    "stages": stages, "widths": widths, "eager": eager}

        def launch(phase, runs, device="cuda:0", timeout_s=900):
            t0 = time.perf_counter()
            res = spawn_local(RANKS, sharded_rank, (shard_dir, runs, native_miner),
                              backend="gloo", device=device, timeout_s=timeout_s)
            print(f"phase {phase}: {RANKS} ranks on {device} over gloo, {len(runs)} runs in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            by_label = {r["label"]: [res[k][i] for k in range(RANKS)]
                        for i, r in enumerate(runs)}
            for label, rows in by_label.items():
                for r in rows:
                    print(f"sharded {label} rank {r['rank']}: " + json.dumps(
                        {k: v for k, v in r.items() if k not in ("label", "rank", "predict")}),
                        flush=True)
                    check(all(np.isfinite(r["losses"])),
                          f"{label} rank {r['rank']}: non-finite loss")
                    check(r["losses"] == rows[0]["losses"],
                          f"{label}: rank {r['rank']} reports other losses than rank 0")
            return by_label

        def need(label, rows, kernels, kernel, overlap, wire="ragged"):
            for r in rows:
                check((r["kernel"], r["wire"], r["overlap"]) == (kernel, wire, overlap),
                      f"{label}: ran kernel {r['kernel']}, wire {r['wire']}, overlap "
                      f"{r['overlap']}")
                for k in kernels:
                    check(r["launches"][k] > 0, f"{label} rank {r['rank']}: no {k} launch")
                ex = r["exchanges"]
                # an overlap plan splits every exchange, forward and reverse,
                # around the work that does not read it; the combined plan
                # splits none
                for d in ("", "bwd_"):
                    check((ex[d + "started"] > 0) == overlap
                          and ex[d + "held"] <= ex[d + "started"],
                          f"{label} rank {r['rank']}: exchanges {ex}")
            if overlap:
                overlap_lines(label, rows)

        def overlap_lines(label, rows):
            """Per rank: the exchanges training split around the interior
            work, those whose interior work had completed when gloo's wait
            returned, the host's ms an exchange and the card's ms beside a
            held one; the same of the reverse exchanges (the gradient work
            beside them); and the fused plan's pure / mixed edges."""
            for r in rows:
                ex = r["exchanges"]
                edges = (f", pure_edges {r['pure_edges']}, mixed_edges {r['mixed_edges']}"
                         if "pure_edges" in r else
                         f", interior_edges {r['interior_edges']}, boundary_edges "
                         f"{r['boundary_edges']}" if "interior_edges" in r else "")
                print(f"overlap {label} rank {r['rank']}: exchanges started {ex['started']}, "
                      f"interior done within the wait {ex['held']}, host ms an exchange "
                      f"{ex['host_ms'] / max(1, ex['started']):.3f}, card ms beside a held "
                      f"exchange {ex['beside_ms'] / max(1, ex['held']):.4f}; reverse exchanges "
                      f"started {ex['bwd_started']}, gradient work done within the wait "
                      f"{ex['bwd_held']}, host ms an exchange "
                      f"{ex['bwd_host_ms'] / max(1, ex['bwd_started']):.3f}, card ms beside a "
                      f"held exchange {ex['bwd_beside_ms'] / max(1, ex['bwd_held']):.4f}{edges}",
                      flush=True)

        def timing(rows):
            out = {"warm_epoch_ms": float(np.mean(rows[0]["epoch_ms"][1:])),
                   "step_ms": [r["step_ms"] for r in rows],
                   "launches_per_step": [r["launches_per_step"] for r in rows],
                   "exchange_ms": [r["exchange_ms"] for r in rows],
                   "wire_bytes": [r["wire_bytes"] for r in rows]}
            if "profile" in rows[0]:
                for k in ("kernel_ms_per_step", "copy_ms_per_step", "idle_share"):
                    out[k] = [r["profile"][k] for r in rows]
            return out

        def gap_check(what, a, b, tol):
            gap = rel_gap(a, b[: len(a)])
            print(f"{what}: max relative loss gap {gap:.3e} over {len(a)} epochs", flush=True)
            check(gap <= tol, f"{what}: {gap:.3e} > {tol:.0e}")

        gat = dict(model="gat", learning_rate=0.005)
        bf16 = dict(agg_dtype="bfloat16")
        models = (("gcn", {}), ("gat", gat))
        # 6, 6d, 6f. the Reddit config on 4 ranks of the one card, one launch.
        # (Both models read the same shard files; a rank sets GAT's edge
        # values itself.) The f32 runs take 2 epochs: they are held against
        # the first 2 of 4c's.
        # Timed runs first, in pairs that are compared (each pair back to
        # back); the profiled bf16 runs last, so that no run is timed in a
        # process that has traced before.
        runs = [run("gcn f32 degree pair", "reddit", timed=True, kernel="degree", epochs=2),
                run("gcn f32 degree combined", "reddit", timed=True, kernel="degree",
                    overlap=False, epochs=2),
                run("gcn f32 fused", "reddit", epochs=2),
                run("gcn f32 combined", "reddit", overlap=False, epochs=2)]
        for model, kw in models:
            runs += [run(f"{model} f32 xla split", "reddit", timed=True, kernel="xla",
                         overlap=True, epochs=2, **kw),
                     run(f"{model} f32 xla combined", "reddit", timed=True, kernel="xla",
                         overlap=False, epochs=2, **kw)]
        runs += [run("gat f32 fused", "reddit", epochs=2, **gat),
                 run("gat f32 degree pair", "reddit", kernel="degree", epochs=2, **gat)]
        # 9. tensor parallelism: 2 graph shards x 2 feat shards, rank r on
        # shard r // 2, every aggregation and exchange at F/2 = 64 (GAT's
        # output layer at 41: it does not divide); timed and stage-profiled
        # before any run of the launch traces; GAT's step traced last
        tp = dict(feat_shards=2, num_shards=2)
        runs += [run("gcn f32 tp 2x2", "reddit2", timed=True, stages=True, widths=True, **tp),
                 run("gat bf16 tp 2x2", "reddit2", profile=True, widths=True, **tp, **bf16,
                     **gat)]
        for model, kw in models:
            runs += [run(f"{model} bf16 fused", "reddit", profile=True,
                         stages=model == "gcn", **bf16, **kw),
                     run(f"{model} bf16 degree pair", "reddit", profile=True, kernel="degree",
                         **bf16, **kw)]
        by_label = launch("6, 6d, 6f, 9", runs)
        launches = {}
        timings = {}
        for model, _ in models:
            slot = "K2" if model == "gat" else "K1"
            # GAT's backward: dh and the value gradient in one launch
            dh = "K3_dh_dval" if model == "gat" else "K3_dh"
            edge = ["K3", dh] + (["K5"] if model == "gat" else [])
            for label, kernels, kernel, overlap in (
                    (f"{model} bf16 fused", ["K8", "K9", "K10", slot], "hyb", True),
                    (f"{model} f32 fused", ["K8", "K9", "K10", slot], "hyb", True),
                    (f"{model} bf16 degree pair", ["degree", "K9", "K10", slot], "degree", True),
                    (f"{model} f32 degree pair", ["degree", "K9", "K10", slot], "degree", True),
                    (f"{model} f32 xla split", ["K9", "K10"] + edge, "xla", True),
                    (f"{model} f32 xla combined", ["K9", "K10"] + edge, "xla", False)):
                need(label, by_label[label], kernels, kernel, overlap)
            for plan in ("fused", "degree pair"):
                rows = by_label[f"{model} bf16 {plan}"]
                if model == "gcn":
                    check(rows[0]["losses"][-1] < rows[0]["losses"][0],
                          f"{model} bf16 {plan}: loss did not fall")
                for k in ("K1", "K2", "K8", "K8_pure", "K9", "K10", "degree"):
                    key = k if plan == "fused" or k == "degree" else f"{k}_degree"
                    launches[key] = launches.get(key, 0) + sum(r["launches"][k] for r in rows)
                timings[f"{model} {plan}"] = timing(rows)
            for plan in ("fused", "degree pair", "xla split"):
                gap_check(f"sharded {model} f32 {plan} vs the single-device hyb engine",
                          by_label[f"{model} f32 {plan}"][0]["losses"], hyb_f32_losses[model],
                          1e-4)
            split, comb = (by_label[f"{model} f32 xla {p}"] for p in ("split", "combined"))
            gap_check(f"sharded {model} f32 xla, split vs combined", split[0]["losses"],
                      comb[0]["losses"], 1e-5)
            for a, b in zip(split, comb):
                for k in ("K3", dh):
                    k3 = [r["launches_per_step"].get(k, 0) for r in (a, b)]
                    check(k3[1] > 0 and k3[0] == 2 * k3[1],
                          f"{model} xla split: {k} launches per step {k3[0]} against the "
                          f"combined path's {k3[1]}")
            timings[f"{model} xla split"] = timing(split)
            timings[f"{model} xla combined"] = timing(comb)
        need("gcn f32 combined", by_label["gcn f32 combined"], ["K1", "K9", "K10"], "hyb",
             False)
        need("gcn f32 degree combined", by_label["gcn f32 degree combined"],
             ["degree", "K1", "K9", "K10"], "degree", False)
        gap_check("sharded gcn f32, combined vs fused plan",
                  by_label["gcn f32 combined"][0]["losses"],
                  by_label["gcn f32 fused"][0]["losses"], 1e-5)
        gap_check("sharded gcn f32 degree, pair vs combined plan",
                  by_label["gcn f32 degree pair"][0]["losses"],
                  by_label["gcn f32 degree combined"][0]["losses"], 1e-5)
        timings["gcn f32 degree pair"] = timing(by_label["gcn f32 degree pair"])
        timings["gcn f32 degree combined"] = timing(by_label["gcn f32 degree combined"])
        # 6: rank 0's stage profile of the fused plan
        print("phase 6 gcn bf16 fused ShardedEngine.profile(iters=3) ms (the max over "
              "ranks): " + json.dumps(by_label["gcn bf16 fused"][0]["stages_ms"]), flush=True)
        tp_out = tp_phase(by_label, hyb_f32_losses)
        launches.update(tp_out["launches"])
        timings["tp 2x2"] = tp_out["timings"]

        # 6e. pair reuse on the community graph's shards; then, in the same
        # launch, 6b's card runs (untimed, after 6e's traced GAT runs) and
        # last its CPU runs (the same ranks on device "cpu")
        runs = [run(f"{model} bf16 reuse={reuse}", "community", timed=True, reuse=reuse,
                    **bf16, **kw)
                for model, kw in models for reuse in ("pairs", "off")]
        runs[-2]["profile"] = runs[-1]["profile"] = True  # the last two: GAT
        # 6b. card vs CPU on the small graphs, and predict() in global order
        small = [run("planted gcn", "planted", predict=True, epochs=3),
                 run("planted gat", "planted", predict=True, **gat),
                 run("planted gcn degree pair", "planted", kernel="degree", epochs=3),
                 run("planted gat degree pair", "planted", kernel="degree", **gat),
                 run("smallcomm gcn pairs", "smallcomm", reuse="pairs", reuse_passes=2),
                 run("smallcomm gat pairs", "smallcomm", reuse="pairs", reuse_passes=2,
                     **gat)]
        on_cpu_runs = [dict(r, label=f"{r['label']} (CPU)", device="cpu") for r in small]
        by_c = launch("6e, 6b", runs + small + on_cpu_runs)
        for model, _ in models:
            pairs, off = (by_c[f"{model} bf16 reuse={r}"] for r in ("pairs", "off"))
            need(f"{model} reuse=pairs", pairs, ["K6", "K2", "K9", "K10"], "hyb", False)
            need(f"{model} reuse=off", off, ["K2" if model == "gat" else "K1", "K9", "K10"],
                 "hyb", True)
            for r in pairs:
                check(r["fwd_pairs"] > 0 and r["bwd_pairs"] > 0,
                      f"{model} reuse=pairs rank {r['rank']}: mined no pairs")
            gap_check(f"sharded community {model}: reuse vs off", pairs[0]["losses"],
                      off[0]["losses"], 1e-2)
            for k in ("K6", "K2"):
                launches[f"{k}_reuse"] = launches.get(f"{k}_reuse", 0) + sum(
                    r["launches"][k] for r in pairs)
            timings[f"{model} community pairs"] = dict(
                timing(pairs), mine_s=[r["mine_s"] for r in pairs],
                fwd_pairs=[r["fwd_pairs"] for r in pairs],
                row_cut=[r["row_cut"] for r in pairs])
            timings[f"{model} community off"] = timing(off)

        for r in small:
            label = r["label"]
            gap_check(f"4 ranks on the card vs 4 on the CPU, {label}",
                      by_c[label][0]["losses"], by_c[f"{label} (CPU)"][0]["losses"], 1e-5)
            if not r["predict"]:
                continue
            single = Engine(gp, layers, TrainConfig(**r["cfg"]), device="cuda")
            single.run()
            want = single.predict()
            for k in range(RANKS):
                got = by_c[label][k]["predict"]
                err = float(np.abs(got - want).max()) / float(np.abs(want).max())
                check(got.shape == want.shape and err <= 1e-3,
                      f"{label}: rank {k}'s predict() is {err:.3e} off the single-device "
                      "engine's")
            print(f"  predict() in global order vs the single-device engine: rel err {err:.3e}",
                  flush=True)

        # 6c. one rank per card over NCCL, where there are cards
        if torch.cuda.device_count() >= 2:
            n = min(RANKS, torch.cuda.device_count())
            check(n == RANKS, f"the NCCL phase needs {RANKS} cards, found {n}")
            # through the epochs' CUDA graphs (the halo exchanges and the
            # all-reduce inside), then eagerly from the same init
            runs = [run("gcn bf16 fused nccl", "reddit", timed=True, agg_dtype="bfloat16"),
                    run("gcn bf16 fused nccl eager", "reddit", eager=True,
                        agg_dtype="bfloat16")]
            nres = spawn_local(RANKS, sharded_rank, (shard_dir, runs), backend="nccl",
                               device="cuda:{rank}", timeout_s=600)
            for k in range(RANKS):
                r, e = nres[k]
                print(f"sharded {r['label']} rank {k}: " + json.dumps(
                    {a: b for a, b in r.items() if a not in ("label", "rank")}), flush=True)
                check(r["backend"] == "nccl" and all(np.isfinite(r["losses"])),
                      f"nccl rank {k}: backend {r['backend']} or non-finite loss")
                check((r["epoch_timing"], e["epoch_timing"]) == ("replayed", "eager")
                      and r["losses"] == e["losses"] and r["launches"] == e["launches"],
                      f"nccl rank {k}: replayed losses {r['losses']} ({r['epoch_timing']}), "
                      f"launches {r['launches']}; eager {e['losses']}, {e['launches']}")
            gap = rel_gap(nres[0][0]["losses"], by_label["gcn bf16 fused"][0]["losses"])
            check(gap <= 1e-5, f"nccl and gloo runs differ by {gap:.3e} > 1e-5")
        else:
            print(f"nccl path not run: {torch.cuda.device_count()} card", flush=True)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    return {"launches": launches, "timings": timings}


def graph_key(args) -> tuple:
    """The command line's flags that shape its graph."""
    return (args.data_dir, args.dataset, args.config, args.synth_vertices, args.synth_degree,
            args.reorder, args.parts_file)


def memoised_loader(load_graph, graphs: dict):
    """The command line's graph loader memoised in `graphs` on the flags
    that shape the graph, so one graph serves every command of a phase (the
    set-up seconds the runs report are those of its one build)."""
    def load_graph_once(args):
        key = graph_key(args)
        if key not in graphs:
            graphs[key] = load_graph(args)
        return graphs[key]

    return load_graph_once


def bench_phase(g, ops: dict) -> tuple[dict, dict, dict]:
    """Phase 12 (right after phase 11, before any torch.profiler session):
    the port's benchmark (dorylus_tpu_torch/bench.py) on phase 3's Reddit
    graph and `ops` (bench.spmm_cells' plans, which phase 3 then checks): the
    pass cells, each held against its plain version first, then the four
    epoch cells, with every launch count set to 0 just before and read just
    after. Returns (pass cells, epoch cells, launch counts)."""
    from dorylus_tpu_torch import bench
    from dorylus_tpu_torch.engine import engine as engine_mod
    from dorylus_tpu_torch.tools import probe_prims

    cuda = torch.device("cuda")
    make_op = engine_mod.HybSpMM

    def op_once(src, dst, num_in, num_out, **kw):
        # GCN's engines ask for the static plans `ops` holds (the same
        # plans; the slot->edge maps beside them go unread): handed over
        # instead of built again. GAT's engines build theirs, without values.
        for op in (ops["bf16"], ops["f32"]):
            if (src is g.src and kw.get("static_val") is g.edge_norm
                    and kw.get("gather_dtype") is op.gather_dtype):
                return op
        return make_op(src, dst, num_in, num_out, **kw)

    reset_counts()
    for k in probe_prims.LAUNCHES:
        probe_prims.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    cells = bench.spmm_cells(g, ops, iters=10, device=cuda)
    t1 = time.perf_counter()
    engine_mod.HybSpMM = op_once
    try:
        epochs = bench.epoch_cells(g, cuda)
    finally:
        engine_mod.HybSpMM = make_op
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
    counts["P3"] = probe_prims.LAUNCHES["P3"]
    print(f"phase 12 bench pass cells ({t1 - t0:.1f} s): {json.dumps(cells)}; epoch cells "
          f"({time.perf_counter() - t1:.1f} s): {json.dumps(epochs)}; launches "
          f"{json.dumps(counts)}", flush=True)
    for k in ("K1", "K2", "K3", "K7", "degree", "P3"):
        check(counts.get(k, 0) > 0, f"phase 12: the bench launched no {k}")
    return cells, epochs, counts


def switch_phase(g, gb, sg, layers, ops: dict) -> dict:
    """Phase 12c (right after phase 12, before any torch.profiler session):
    the switch points the card's numbers set (tools/switch_points.py).
    Prints kernel="auto"'s choice on the Reddit graph g and the 450k-vertex
    graph gb (each an engine's kernel_selected) and the plan overlap="auto"
    picks per kernel on the 4-way partition sg (phase 6's ranks); then times
    one hyb/xla f32 GCN pair with the tool's `engine_times` (one
    construction each; warm epochs of groups of 10 replayed), the engines
    handed phase 12's f32 static plan and CSR op where they ask for them."""
    from dorylus_tpu_torch.common.config import AUTO_KERNEL_EDGES, TrainConfig, resolve_kernel
    from dorylus_tpu_torch.engine import engine as engine_mod
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.parallel.train_step import AUTO_OVERLAP
    from dorylus_tpu_torch.tools import switch_points

    t0 = time.perf_counter()
    cuda = torch.device("cuda")
    make_hyb, make_edge = engine_mod.HybSpMM, engine_mod.EdgeSpMM

    def hyb_once(src, dst, num_in, num_out, **kw):
        if (src is g.src and kw.get("static_val") is g.edge_norm
                and kw.get("gather_dtype") is None):
            return ops["f32"]
        return make_hyb(src, dst, num_in, num_out, **kw)

    def edge_once(src, dst, num_in, num_out, **kw):
        return ops["edge"] if src is g.src else make_edge(src, dst, num_in, num_out, **kw)

    out = {"threshold": AUTO_KERNEL_EDGES, "auto": {}}
    engine_mod.HybSpMM, engine_mod.EdgeSpMM = hyb_once, edge_once
    try:
        for name, graph in (("reddit", g), ("450k", gb)):
            eng = Engine(graph, layers, TrainConfig(kernel="auto", epochs=1), device=cuda)
            want = resolve_kernel("auto", graph.num_edges)
            check(eng.kernel_selected.split("+")[0] == want,
                  f"phase 12c {name}: auto ran {eng.kernel_selected}, the rule says {want}")
            out["auto"][name] = {"edges": graph.num_edges, "kernel": eng.kernel_selected}
            del eng
            torch.cuda.empty_cache()
        kernel = resolve_kernel("auto", sg.ep)
        out["overlap_4_ranks"] = {
            "auto_kernel": kernel, "edges_per_shard": sg.ep,
            "plans": {k: switch_points.OVERLAP_PLANS[k] if on else "combined"
                      for k, on in AUTO_OVERLAP.items()}}
        out["gcn_f32"] = {k: switch_points.engine_times(
            g, TrainConfig(kernel=k, epochs=1, eval_every=0), cuda, reps=1)
            for k in ("hyb", "xla")}
    finally:
        engine_mod.HybSpMM, engine_mod.EdgeSpMM = make_hyb, make_edge
    torch.cuda.empty_cache()
    for k, rec in out["gcn_f32"].items():
        check(rec["kernel_selected"] == k and 0 < rec["warm_ms"]["median"] < float("inf"),
              f"phase 12c {k}: {json.dumps(rec)}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12c switch points (threshold {AUTO_KERNEL_EDGES} edges): "
          + json.dumps(out), flush=True)
    return out


def bench_reuse_phase(proc, path: str, g, cg, cells: dict, epochs: dict, card: str) -> dict:
    """Phase 12b: the bench's reuse cells, launch counts set to 0 just before
    and read after: K2's pass against K6 + K2 on the plans
    bench.largev_worker made (its process started after phase 10), and GCN's
    epoch pair on phase 3f's community graph `cg`; then the scipy baseline
    and the bench's record, every key of bench.py's JSON present and its
    numbers finite and > 0; the reuse="auto" gate's decision on `cg` from
    `reuse_payoff`, beside the saving per row this run measured. Returns the
    record."""
    from dorylus_tpu_torch import bench
    from dorylus_tpu_torch.common.config import TrainConfig
    from dorylus_tpu_torch.engine import engine

    cuda = torch.device("cuda")
    proc.join(timeout=900)
    check(proc.exitcode == 0, f"phase 12b: the 1.6M graph's process ended with {proc.exitcode}")
    with np.load(path) as z:
        host = {k: z[k] for k in z.files}
    print(f"phase 12b 1.6M-vertex community graph (in its process): V={int(host['v'])} "
          f"E={int(host['e'])}, generated in {float(host['graph_s']):.1f} s, mined "
          f"({host['miner']}) in {float(host['mine_s']):.1f} s, plans {float(host['plan_s']):.1f} "
          f"s", flush=True)
    reset_counts()
    extra = bench.largev_cell(host, cuda, iters=10)
    del host
    torch.cuda.empty_cache()
    extra.update(bench.community_cells(cg, cuda))
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
    print(f"phase 12b launches {json.dumps(counts)}", flush=True)
    for k in ("K2", "K6", "K1"):
        check(counts.get(k, 0) > 0, f"phase 12b: the reuse cells launched no {k}")
    t0 = time.perf_counter()
    h = np.random.default_rng(0).normal(0, 1, size=(g.num_vertices, bench.F_HID))
    # one timed product after the warm-up (the bench times 3: 2.3 s each here)
    cpu_eps = bench.cpu_spmm_baseline(g, h.astype(np.float32), iters=1)
    print(f"phase 12b scipy baseline {cpu_eps:.1f} edges/s ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    rec = bench.record(g, cells, epochs, cpu_eps, "gpu", card, extra)
    ex = rec["extras"]
    missing = set(bench.BENCH_PY_EXTRAS + bench.BENCH_PY_REUSE) - set(ex)
    check(not missing, f"phase 12b: the bench's record lacks {sorted(missing)}")
    bad = {k: x for k, x in [("value", rec["value"]), ("vs_baseline", rec["vs_baseline"]),
                             *ex.items()]
           if not isinstance(x, str) and not (np.isfinite(x) and x > 0)}
    check(not bad, f"phase 12b: the bench's numbers not finite and > 0: {bad}")
    print("phase 12b bench " + json.dumps(rec), flush=True)
    # the gate's decision on this graph at the card's constants, and the
    # saving per row this run's epoch pair shows beside the fitted one
    v, e = cg.num_vertices, cg.num_edges
    saved_s = 1e-3 * (ex["reuse_reddit_community_epoch_off_ms"]
                      - ex["reuse_reddit_community_epoch_ms"])
    per_row = saved_s / (ex["reuse_reddit_community_row_cut"] * v)
    for model in ("gcn", "gat"):
        cfg = TrainConfig(model=model)
        worth, ceiling, mine = engine.reuse_payoff(cfg, v, e)
        want = (engine.REUSE_CUT_CAP * v * engine.REUSE_SAVE_S_PER_ROW
                * engine.REUSE_MODEL_EFF[model] * cfg.epochs >= e * engine.REUSE_MINE_S_PER_EDGE)
        check(worth == want, f"phase 12b {model}: reuse_payoff says {worth}, the constants {want}")
        print(f"phase 12b reuse auto {model} on the community graph at {cfg.epochs} epochs: "
              f"mines {worth} (ceiling {ceiling:.3f} s, mine {mine:.3f} s; fitted "
              f"{engine.REUSE_SAVE_S_PER_ROW:.3e} s/row, this run's epoch pair "
              f"{per_row:.3e} s/row, the ReuseSpMM build "
              f"{ex['reuse_reddit_community_mine_s'] / e:.3e} s/edge)", flush=True)
    return rec


def amazon_graph_worker(path: str) -> None:
    """Phase 10's graph in a process of its own, started before phase 8, so
    that its host seconds pass beside the card's phases: the command line's
    loader on amazon-gcn's flags (generation and the degree reorder), its
    fields written to `path` (.npz) with the loader's seconds (the graph and
    the reorder)."""
    from dorylus_tpu_torch import cli
    from dorylus_tpu_torch.tools import reference_configs

    g, layers, _, seconds = cli.load_graph(cli.parse_args(reference_configs.argv("amazon-gcn")))
    fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)
              if getattr(g, f.name) is not None}
    np.savez(path, graph_s=seconds["graph"], reorder_s=seconds["reorder"],
             layer_dims=np.asarray(layers.dims), **fields)


def amazon_graph(proc, path: str):
    """(graph, layers, the loader's seconds) from amazon_graph_worker's
    file, once the process has ended."""
    from dorylus_tpu_torch.common.config import LayerConfig
    from dorylus_tpu_torch.graph.graph import Graph

    proc.join(timeout=900)
    check(proc.exitcode == 0, f"phase 10: the graph's process ended with {proc.exitcode}")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    seconds = {k: float(arrays.pop(f"{k}_s")) for k in ("graph", "reorder")}
    dims = arrays.pop("layer_dims").tolist()
    g = Graph(**{k: (int(a) if a.ndim == 0 else a) for k, a in arrays.items()})
    return g, LayerConfig(dims), seconds


def cli_phases(card: str) -> dict:
    """Phase 7: the command line (dorylus_tpu_torch/cli.py) through
    `cli.main`, on the card it picks by default, at the Reddit config on
    `synthetic_graph(232_965, 25, 602, 41, seed=8888)` (11.6M edges after
    symmetrising), degree-ascending. One graph serves 7a, 7c and 7d: the
    command's graph loader is memoised on the flags that shape the graph.
    Every run is held with the launch counts set to 0 just before it and
    read just after. Returns the sub-phases' seconds."""
    from dorylus_tpu_torch import cli
    from dorylus_tpu_torch.graph.dataio import save_dataset

    graphs = {}
    load_graph = cli.load_graph
    load_graph_once = memoised_loader(load_graph, graphs)
    work = tempfile.mkdtemp(prefix="dorylus_smoke_cli_")
    times = {}

    def run(label, argv, epochs):
        """One cli.main call: its seconds, the report's losses, the launch
        counts; K1 on every step where the run is GCN on hyb."""
        out = f"{work}/{label}.json"
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--output", out])
        torch.cuda.synchronize()
        counts = launch_counts()
        times[label] = time.perf_counter() - t0
        check(rc == 0, f"phase {label}: cli.main returned {rc}")
        with open(out) as f:
            losses = [e["loss"] for e in json.load(f)["epochs"]]
        print(f"phase {label}: {times[label]:.1f} s, losses {json.dumps(losses)}, launches "
              f"{json.dumps({k: n for k, n in counts.items() if n})}", flush=True)
        check(len(losses) == epochs and all(np.isfinite(losses)),
              f"phase {label}: losses {losses}, want {epochs} finite")
        return np.array(losses), counts

    def files(d):
        import os

        return sorted(os.listdir(d))

    graph = ["train", "--dataset", "synthetic", "--synth-vertices", "232965",
             "--synth-degree", "25", "--config", "reddit", "--reorder", "degree-asc"]
    gcn = graph + ["--kernel", "hyb", "--agg-bf16", "--model", "gcn", "--eval-every", "2"]
    ck, ck4 = f"{work}/ck", f"{work}/ck4"
    cli.load_graph = load_graph_once
    try:
        # 7a. S=1 with checkpoints, the resume, the uninterrupted run, S=0
        t7 = time.perf_counter()
        a, ca = run("7a_checkpointed", gcn + ["--staleness", "1", "--epochs", "4",
                                             "--checkpoint-dir", ck, "--checkpoint-every", "2"],
                    4)
        check(files(ck) == ["LATEST", "ckpt_00000002.npz", "ckpt_00000004.npz"],
              f"7a: checkpoint dir holds {files(ck)}")
        r, cr = run("7a_resumed", gcn + ["--staleness", "1", "--epochs", "2",
                                        "--checkpoint-dir", ck, "--resume"], 2)
        u, cu = run("7a_uninterrupted", gcn + ["--staleness", "1", "--epochs", "6"], 6)
        s0, c0 = run("7a_sync", gcn + ["--epochs", "2"], 2)
        for label, counts, n in (("checkpointed", ca, 4), ("resumed", cr, 2),
                                 ("uninterrupted", cu, 6), ("sync", c0, 2)):
            # 4 K1 passes a GCN step (2 forwards, 2 dh), more for eval
            check(counts["K1"] >= 4 * n, f"7a {label}: {counts['K1']} K1 launches for {n} steps")
        # K1 writes the same bits on every call: the checkpointed run is the
        # uninterrupted one's first 4 epochs. The resumed run's window starts
        # at the loaded params (epoch 4's), so its epochs 4 and 5 both take
        # the loss at them, as the uninterrupted run's epoch 5 does.
        gaps = {"first_4": rel_gap(a, u[:4]), "resumed_4_vs_5": rel_gap(r[:1], u[5:6]),
                "resumed_5_vs_4": rel_gap(r[1:], r[:1]),
                "s1_vs_s0_epoch_1": rel_gap(a[1:2], s0[1:2])}
        print(f"phase 7a relative gaps: {json.dumps(gaps)}", flush=True)
        check(max(gaps["first_4"], gaps["resumed_4_vs_5"], gaps["resumed_5_vs_4"]) <= 1e-5,
              f"7a: resume does not continue the uninterrupted run: {gaps}")
        check(u[-1] < u[0] and s0[1] < s0[0], f"7a: losses {u.tolist()} did not fall")
        check(gaps["s1_vs_s0_epoch_1"] > 1e-4, "7a: S=1 equals S=0 at epoch 1")
        times["7a"] = time.perf_counter() - t7

        # 7b. infer from that checkpoint: one line per vertex
        t7 = time.perf_counter()
        g = next(iter(graphs.values()))[0]
        save_dataset(f"{work}/ds", g)
        preds = f"{work}/preds.txt"
        reset_counts()
        rc = cli.main(["infer", "--data-dir", f"{work}/ds", "--config", "reddit",
                       "--checkpoint-dir", ck, "--out", preds])
        torch.cuda.synchronize()
        counts = launch_counts()
        check(rc == 0 and counts["K1"] >= 2, f"7b: infer returned {rc}, launches {counts}")
        p = np.loadtxt(preds, dtype=np.float32)
        check(p.shape == (g.num_vertices, 41) and bool(np.isfinite(p).all()),
              f"7b: infer wrote {p.shape} (want ({g.num_vertices}, 41) finite)")
        times["7b"] = time.perf_counter() - t7
        print(f"phase 7b: infer wrote {p.shape[0]} lines of {p.shape[1]} in {times['7b']:.1f} s, "
              f"launches {json.dumps({k: n for k, n in counts.items() if n})}", flush=True)
        del p

        # 7c. GAT on the edgewise kernels with S=2: the first 3 epochs all
        # take their gradients (and losses) at the starting params
        t7 = time.perf_counter()
        gat, counts = run("7c_gat_xla_s2", graph + ["--kernel", "xla", "--model", "gat",
                                                   "--learning-rate", "0.005", "--staleness",
                                                   "2", "--epochs", "3", "--eval-every", "1"], 3)
        check(all(counts[k] > 0 for k in ("K3", "K3_dh_dval", "K5")),
              f"7c: launches {json.dumps(counts)}")
        check(rel_gap(gat[1:], gat[:1].repeat(2)) <= 1e-5,
              f"7c: S=2 losses {gat.tolist()} not all the starting params' loss")
        times["7c"] = time.perf_counter() - t7

        # 7d. --shards 4: four ranks on the one card over gloo, S=1, one
        # checkpoint (rank 0 writes it); the losses are 7a's single-device
        # ones (bf16 tables rounded alike; summation orders differ)
        t7 = time.perf_counter()
        sh, _ = run("7d_shards4", gcn + ["--staleness", "1", "--epochs", "3", "--shards",
                                        str(RANKS), "--checkpoint-dir", ck4,
                                        "--checkpoint-every", "3"], 3)
        check(files(ck4) == ["LATEST", "ckpt_00000003.npz"], f"7d: checkpoints {files(ck4)}")
        gap = rel_gap(sh, u[:3])
        print(f"phase 7d: 4 ranks vs one device, max relative loss gap {gap:.3e}", flush=True)
        check(gap <= 1e-3, f"7d: 4-rank losses differ from one device's by {gap:.3e}")
        times["7d"] = time.perf_counter() - t7
    finally:
        cli.load_graph = load_graph
        shutil.rmtree(work, ignore_errors=True)
    times["7"] = sum(times[k] for k in ("7a", "7b", "7c", "7d"))
    print(f"phase 7 seconds ({card}): " + json.dumps(times), flush=True)
    return times


def amazon_phase(graph: tuple) -> dict:
    """Phase 10: the Amazon config at its JAX run script's SCALE (0.12: 1,131,610
    vertices, about 27.2M edges, 300-64-25), through the reference-config
    tool (dorylus_tpu_torch/tools/reference_configs.py) and `cli.main` on
    the card, with the command line's graph loader memoised (one graph
    serves both runs). First K1 bf16 at F=64 and F=25 and K2 bf16 at F=64
    on the graph's plan against their plain versions (tables past the
    card's L2), timed as phase 3 times them, with the bound and the time
    if every gathered row came from device memory. The engine's op
    constructor hands GCN's engine that plan, which it asks for with the
    same arguments (bf16, the static norms); GAT's engine builds its own
    plan without values. `cli.build_engine` is wrapped only to keep the
    engine it builds, for the step's timing. Then amazon-gcn and amazon-gat
    for 3 epochs each, the counts at 0 just before each run and read just
    after: losses finite (GCN's falling), kernel "auto" picked hyb, K1
    (GCN) or K2 (GAT) launched, by table width at 64 and 25 (32 as padded),
    2 each a step, and the peak of notes["hbm"] within the card's memory.
    `graph`: (graph, layers, the loader's seconds) from amazon_graph, the
    loader's result on amazon-gcn's flags. Returns what the kernels line
    needs."""
    from dorylus_tpu_torch import cli
    from dorylus_tpu_torch.engine import engine as engine_mod
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
    from dorylus_tpu_torch.tools import reference_configs

    g, layers, seconds = graph
    graph_s = seconds["graph"] + seconds["reorder"]
    graphs = {graph_key(cli.parse_args(reference_configs.argv("amazon-gcn"))):
              (g, layers, None, seconds)}
    load_graph, build_engine, make_op = cli.load_graph, cli.build_engine, engine_mod.HybSpMM
    load_graph_once = memoised_loader(load_graph, graphs)
    v = g.num_vertices
    print(f"phase 10 amazon graph (SCALE {reference_configs.CONFIGS['amazon-gcn'].scale}): "
          f"V={v} E={g.num_edges} layers {layers.dims}, generated and reordered in "
          f"{graph_s:.1f} s (in a process of its own, beside phases 8-3)", flush=True)
    check(v == 1_131_610 and g.num_edges > 8_000_000 and list(layers.dims) == [300, 64, 25],
          f"phase 10: the Amazon graph has V={v}, E={g.num_edges}, layers {layers.dims}")
    t0 = time.perf_counter()
    op = HybSpMM(g.src, g.dst, v, v, gather_dtype=torch.bfloat16, static_val=g.edge_norm,
                 device="cuda")
    plan_s = time.perf_counter() - t0
    print(f"phase 10 plans (bf16, static norms): fwd {len(op.fwd['buckets'])} buckets, top "
          f"{op.fwd['top'] is not None}, {live_slots(op.fwd)} live slots ({plan_s:.1f} s)",
          flush=True)
    csr = csr_pattern(g.src, g.dst, v)
    csr["norm"] = torch.tensor(g.edge_norm, device="cuda")
    csr["ones"] = torch.ones_like(csr["norm"])
    results = [compare("amazon", op, 64, seed=640, timed=True, csr=csr),
               compare("amazon", op, 25, seed=250, timed=True, csr=csr),
               compare_mask("amazon", op, 64, seed=642, timed=True, csr=csr)]
    del csr
    torch.cuda.empty_cache()
    live = live_slots(op.fwd)
    for r in results:
        # every gathered row from device memory: the padded table rows
        # (16-byte multiples) once per live slot, the slots, the output
        row_bytes = -(-r["F"] * 2 // 16) * 16
        slot_bytes = 6 if r["kernel"] == "K1" else 4
        r["rows_from_hbm_bytes"] = live * (row_bytes + slot_bytes) + v * r["F"] * 4
        r["rows_from_hbm_ms"] = 1e3 * r["rows_from_hbm_bytes"] / HBM_BYTES_PER_S
        print(f"phase 10 {r['kernel']} bf16 F={r['F']}: pass {r['fwd_ms']:.4f} ms, kernel "
              f"{r['fwd_kernel_ms']:.4f}, plain {r['fwd_plain_ms']:.3f}, sparse.mm "
              f"{r.get('library_ms')}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_bytes'] / 1e9:.3f} GB once), every row from device memory "
              f"{r['rows_from_hbm_ms']:.4f} ms ({r['rows_from_hbm_bytes'] / 1e9:.3f} GB)",
              flush=True)

    def op_once(src, dst, num_in, num_out, **kw):
        # the plan above where the engine asks for that very plan (GCN's);
        # GAT's engine builds its own, without values
        if (src is g.src and dst is g.dst and kw.get("gather_dtype") is torch.bfloat16
                and kw.get("static_val") is g.edge_norm):
            return op
        return make_op(src, dst, num_in, num_out, **kw)

    built = []

    def build_engine_kept(args, graph=None, layers=None):
        built.append(build_engine(args, graph, layers))
        return built[-1]

    total = torch.cuda.get_device_properties(0).total_memory
    out = {"graph_s": graph_s, "plan_s": plan_s, "results": results, "launches": {},
           "records": {}, "steps": {}}
    cli.load_graph, cli.build_engine, engine_mod.HybSpMM = (load_graph_once,
                                                             build_engine_kept, op_once)
    try:
        for name, slot in (("amazon-gcn", "K1"), ("amazon-gat", "K2")):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            restore = width_counter()
            rec = reference_configs.run(name, epochs=3)
            torch.cuda.synchronize()
            widths, counts = restore(), launch_counts()
            print(f"phase 10 {name}: " + json.dumps(rec), flush=True)
            losses = rec["losses"]
            check(len(losses) == 3 and all(np.isfinite(losses))
                  and (slot == "K2" or losses[-1] < losses[0]),
                  f"phase 10 {name}: losses {losses}")
            check(rec["kernel"] == "hyb" and counts[slot] > 0,
                  f"phase 10 {name}: kernel {rec['kernel']}, launches {json.dumps(counts)}")
            check(set(widths.get(slot, {})) == {"64", "32"},
                  f"phase 10 {name}: {slot} launches by width {widths}")
            check(0 < rec["hbm_peak_bytes"] <= total,
                  f"phase 10 {name}: notes hbm peak {rec['hbm_peak_bytes']} of {total} bytes")
            eng = built.pop()
            # notes["hbm"]'s peak of 3 more epochs of the same engine, eager
            # and through the epoch's CUDA graphs (the run above includes
            # the engine's build)
            hbm = {}
            for graphs in (False, True):
                eng._graphs = None
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                rep = eng.run(3, graphs=graphs)
                hbm["graph" if graphs else "eager"] = rep.notes["hbm"]["peak_bytes_in_use"]
            print(f"phase 10 {name}: notes hbm peak bytes of 3 epochs {json.dumps(hbm)}",
                  flush=True)
            lr = eng.cfg.learning_rate
            step_ms = cuda_ms(lambda: eng._train_epoch(lr), 5)
            restore = width_counter()
            per_step = step_launches(lambda: eng._train_epoch(lr))
            step_widths = restore()
            print(f"phase 10 {name}: train step {step_ms:.3f} ms, launches per step "
                  f"{json.dumps(per_step)}, by table width {json.dumps(step_widths)}",
                  flush=True)
            check(step_widths == {slot: {"64": 2, "32": 2}},
                  f"phase 10 {name}: {slot} launches by width a step {step_widths}, want 2 at "
                  "64 and 2 at 32 (25 padded)")
            del eng
            torch.cuda.empty_cache()
            out["launches"][slot] = widths[slot]
            out["records"][name] = rec
            out["steps"][name] = {"step_ms": step_ms, "launches_per_step": per_step,
                                  "widths_per_step": step_widths, "hbm_peak_bytes": hbm}
    finally:
        cli.load_graph, cli.build_engine, engine_mod.HybSpMM = (load_graph, build_engine,
                                                                 make_op)
    del op, g, graphs
    torch.cuda.empty_cache()
    return out


def collective_capture(device, replays: int = 3) -> list:
    """multihost.all_to_all_rows and a dist.all_reduce on this rank's world
    captured in one CUDA graph (first run eagerly on a side stream, which
    creates the communicator, as the engine's first epoch does), replayed
    with new inputs copied into the captured buffers: whether each
    replay's results equal the same collectives run eagerly."""
    import torch.distributed as dist

    from dorylus_tpu_torch.parallel import multihost

    world = dist.get_world_size()
    x = torch.zeros((8 * world, 16), device=device)
    y = torch.zeros(1000, device=device)

    def body():
        out = multihost.all_to_all_rows(x, [8] * world, [8] * world)
        dist.all_reduce(y)
        return out

    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body()
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = body()
    gen = torch.Generator(device=device).manual_seed(dist.get_rank())
    exact = []
    for _ in range(replays):
        a = torch.randn(tuple(x.shape), generator=gen, device=device)
        b = torch.randn(1000, generator=gen, device=device)
        x.copy_(a)
        y.copy_(b)
        graph.replay()
        want_y = b.clone()
        dist.all_reduce(want_y)
        want = multihost.all_to_all_rows(a, [8] * world, [8] * world)
        exact.append(bool(torch.equal(got, want) and torch.equal(y, want_y)))
    return exact


def weak_rank(rank: int, world: int, device, shard_dir: str, dims: list, cfg,
              opts: dict) -> dict:
    """Phase 13's rank: tools/weak_scaling.py's `_rank` (its engine's
    epochs replayed from the warm-up run on), then the same configuration
    from the same init run eagerly (`run(graphs=False)`; then once more,
    warm, for its epoch ms), and this rank's collectives captured in a
    CUDA graph (`collective_capture`)."""
    from pathlib import Path

    from dorylus_tpu_torch.common.config import LayerConfig
    from dorylus_tpu_torch.graph.partition import load_shard
    from dorylus_tpu_torch.parallel.train_step import ShardedEngine
    from dorylus_tpu_torch.tools import weak_scaling as ws

    out = ws._rank(rank, world, device, shard_dir, dims, cfg, opts)
    shard, meta = load_shard(Path(shard_dir) / f"shard_{rank}.npz")
    eng = ShardedEngine((shard, meta), LayerConfig(list(dims)), cfg, device=device)
    out["eager_losses"] = [e.loss for e in eng.run(graphs=False).epochs]
    n0 = len(eng.report.epochs)
    # a second eager run, warm, as the tool's measured runs are
    out["eager_epoch_ms"] = [e.time_ms for e in eng.run(graphs=False).epochs[n0:]]
    del eng
    out["collective_capture"] = collective_capture(device)
    return out


def weak_scaling_phase() -> dict:
    """13. tools/weak_scaling.py's device mode at the JAX package's r5
    config (hyb GCN, 262,144 base vertices, degree 16, 64-32-8, clustered,
    cut 0.1, 10 epochs, 3 repeats, --overlap both --decompose, shards 1 2
    4): one NCCL rank a card, counts above the card count skipped. The
    n = 1 record against a one-device Engine on the same graph and config
    (loss rtol 1e-4), K1 launched in its rank's window; the rank's engine
    replays its epochs (`epoch_timing` "replayed"), equal bit for bit to
    the same configuration run eagerly from the same init, and its
    collectives replay exactly from one CUDA graph (`weak_rank`); its
    replayed epoch beside the Engine's and its eager one."""
    from dorylus_tpu_torch.engine.engine import Engine
    from dorylus_tpu_torch.tools import switch_points
    from dorylus_tpu_torch.tools import weak_scaling as ws

    t0 = time.perf_counter()
    args = ws.build_parser().parse_args(
        ["--kernel", "hyb", "--model", "gcn", "--base-vertices", "262144", "--degree", "16",
         "--feature-dim", "64", "--classes", "8", "--graph", "clustered", "--cut", "0.1",
         "--epochs", "10", "--repeats", "3", "--overlap", "both", "--decompose",
         "--shards", "1", "2", "4"])
    lines = []

    def out(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    # one graph a shard count for the tool's ranks and the Engine here (as
    # phase 10 memoises the command line's loader)
    graphs, make_graph = {}, ws.make_graph

    def memo_graph(a, n: int):
        if n not in graphs:
            graphs[n] = make_graph(a, n)
        return graphs[n]

    ws.make_graph, tool_rank, ws._rank = memo_graph, ws._rank, weak_rank
    try:
        summary, by_n = ws.sweep(args, out=out, timeout_s=300)
    finally:
        ws.make_graph, ws._rank = make_graph, tool_rank
    sweep_s = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    ran = [n for n in args.shards if n <= cards]
    for n in args.shards:
        if n > cards:
            check(f"# skipping {n} shards (only {cards} devices)" in lines,
                  f"weak_scaling: no skip line for {n} shards on {cards} card(s)")
    check((summary["mode"], summary["backend"], summary["epoch_timing"])
          == ("device", "nccl", "replayed"),
          f"weak_scaling: mode {summary['mode']}, backend {summary['backend']}, epochs "
          f"{summary['epoch_timing']}")
    recs = summary["weak_scaling"]
    check([r["shards"] for r in recs] == ran, f"weak_scaling ran {[r['shards'] for r in recs]}")
    layers, cfg = ws.make_config(args)
    for rec in recs:
        n = rec["shards"]
        stages = {f"{k}_l{l}_ms" for l in range(layers.num_layers)
                  for k in (("halo", "aggregate") if n > 1 else ("aggregate",))}
        check(all(r["backend"] == "nccl" for r in by_n[n]),
              f"weak_scaling {n}: backends {[r['backend'] for r in by_n[n]]}")
        check(np.isfinite(rec["epoch_ms"]) and rec["epoch_ms"] > 0
              and len(rec["edges_per_s_runs"]) == 3,
              f"weak_scaling {n}: epoch_ms {rec['epoch_ms']}, runs {rec['edges_per_s_runs']}")
        check(set(rec["stages_ms"]) == stages | {"forward_ms", "loss_and_grad_ms"},
              f"weak_scaling {n}: stages {sorted(rec['stages_ms'])}")
        check(n == 1 or {"serial", "overlap_speedup", "halo"} <= set(rec),
              f"weak_scaling {n}: keys {sorted(rec)}")
    g = graphs[1]
    rec, ranks = recs[0], by_n[1]
    check(rec["edges"] == g.num_edges, f"weak_scaling: {rec['edges']} edges, the graph "
          f"{g.num_edges}")
    # at n = 1 the engine runs the combined plan: K1, no K8-K10
    launches = ranks[0]["launches"]
    check(launches.get("hyb_static_pass", 0) > 0,
          f"weak_scaling: the rank launched no K1 ({launches})")
    for r, res in enumerate(ranks):
        check(res["eager_losses"] == res["losses"],
              f"weak_scaling: rank {r}'s replayed losses {res['losses']} against its eager "
              f"run's {res['eager_losses']}")
        check(res["collective_capture"] == [True] * 3,
              f"weak_scaling: rank {r}'s captured collectives {res['collective_capture']}")
    eager_ms = float(np.mean(ranks[0]["eager_epoch_ms"]))
    eng = Engine(g, layers, cfg, device="cuda")
    single = [e.loss for e in eng.run().epochs]
    gap = rel_gap(ranks[0]["losses"], single)
    check(all(np.isfinite(single)) and gap <= 1e-4,
          f"weak_scaling: the NCCL rank's losses {ranks[0]['losses']} against one "
          f"device's {single}: rtol {gap:.3e} > 1e-4")
    replayed = switch_points.warm_ms(eng, cfg.learning_rate)
    del eng
    torch.cuda.empty_cache()
    ranges = fused_ranges_phase(g)
    seconds = time.perf_counter() - t0
    print(f"weak_scaling n=1 over NCCL: losses within rtol {gap:.3e} of Engine's; the rank's "
          f"launches {json.dumps(launches)}; replayed == eager bit for bit; all_to_all_rows "
          f"and all_reduce captured in one graph, 3 replays exact; ShardedEngine replayed "
          f"epoch {rec['epoch_ms']} ms (runs {rec['edges_per_s_runs']} edges/s) beside "
          f"Engine's replayed warm epoch {float(np.median(replayed)):.3f} ms "
          f"({json.dumps(replayed)}), the rank's warm eager epoch {eager_ms:.3f} ms and the "
          f"uncaptured step's 1.82-2.62 ms (PERF.md section 6); phase 13 {seconds:.1f} s (the "
          f"tool's sweep {sweep_s:.1f} s)", flush=True)
    return {"summary": summary, "engine_replayed_ms": replayed, "launches": launches,
            "loss_rtol": gap, "seconds": seconds, "sweep_s": sweep_s,
            "rank_eager_epoch_ms": ranks[0]["eager_epoch_ms"], "k8_ranges": ranges}


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU to run on")
    try:
        from dorylus_tpu_torch import bench, native
        from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
        from dorylus_tpu_torch.engine.batch import build_batch
        from dorylus_tpu_torch.engine.engine import (Engine, _max_agg_width, reuse_payoff,
                                                     resolve_reuse_budget)
        from dorylus_tpu_torch.graph.graph import Graph, build_graph, synthetic_graph
        from dorylus_tpu_torch.graph.partition import partition_graph, shard_edges
        from dorylus_tpu_torch.graph.reorder import apply_order, degree_order
        from dorylus_tpu_torch.graph.reuse import mine_reuse
        from dorylus_tpu_torch.ops import (cuda_build, degree_spmm, hyb_sharded, hyb_spmm,
                                           reuse_spmm, spmm)
        from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
        from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
        from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
        from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
        from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM
        from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
        from dorylus_tpu_torch.ops.spmm import EdgeSpMM
        from dorylus_tpu_torch.parallel import halo
        from dorylus_tpu_torch.tools import probe_prims
        from dorylus_tpu_torch.tools.switch_points import powerlaw_edges
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
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    check(clk.returncode == 0, f"nvidia-smi clocks failed: {clk.stderr.strip()}")
    sm_hz = 1e6 * float(clk.stdout.strip().splitlines()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SM clock (max, nvidia-smi): {sm_hz / 1e6:.0f} MHz, {n_sms} SMs", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)

    # 2. build the seven libraries at once; the host's pair miner
    t0 = time.perf_counter()
    sources = [hyb_spmm._CSRC, spmm._CSRC, hyb_spmm._DYN_CSRC, reuse_spmm._CSRC,
               hyb_sharded._CSRC, halo._CSRC, probe_prims._CSRC]
    try:
        info = cuda_build.compile_sources(sources)
        hyb_spmm.build_kernel()
        hyb_spmm.build_dyn_kernel()
        spmm.build_kernel()
        reuse_spmm.build_kernel()
        hyb_sharded.build_kernel()
        halo.build_kernel()
        probe_prims.build_kernel()
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

    # 10's graph: generated and reordered in a process of its own meanwhile
    graph_dir = tempfile.mkdtemp(prefix="dorylus_smoke_amazon_")
    graph_path = f"{graph_dir}/graph.npz"
    graph_proc = multiprocessing.get_context("spawn").Process(
        target=amazon_graph_worker, args=(graph_path,), daemon=True)
    graph_proc.start()

    # 3, 3b, 3d. K1, K2 and K7 vs plain
    t0 = time.perf_counter()
    g = build_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"], seed=1)
    g = apply_order(g, degree_order(g, ascending=True))
    v = g.num_vertices
    print(f"reddit-shaped graph: V={v} E={g.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    layers = LayerConfig([REDDIT["feat"], 128, REDDIT["classes"]])

    # 8. the stage profiler, before any torch.profiler session in this process
    stamp("phase 8")
    stages, stage_engines = stage_phase(g, layers)

    # 11. the epoch's CUDA graphs against the eager loop, and their warm
    # epochs, also before any torch.profiler session
    stamp("phase 11")
    graph_res, graph_eng = graph_phase(stage_engines)

    # 11c. the sharded engine's epoch graphs with no group, against its eager
    # loop and phase 11's Engine; both engines' second run captures nothing
    stamp("phase 11c")
    sharded_graph_res = sharded_graph_phase(g, layers, graph_res, graph_eng)

    # 12. the port's benchmark on this graph and on the plans phase 3 checks
    # (3c its CSR op, 3e its bf16 degree plan), also before any
    # torch.profiler session
    stamp("phase 12")
    t0 = time.perf_counter()
    ops = {"bf16": HybSpMM(g.src, g.dst, v, v, gather_dtype=torch.bfloat16,
                           static_val=g.edge_norm, dynamic=True, device="cuda"),
           "f32": HybSpMM(g.src, g.dst, v, v, static_val=g.edge_norm, dynamic=True,
                          device="cuda"),
           "degree": DegreeSpMM(g.src, g.dst, v, v, block=16, gather_dtype=torch.bfloat16,
                                static_val=g.edge_norm, device="cuda"),
           "edge": EdgeSpMM(g.src, g.dst, v, v, device="cuda")}
    print(f"phase 12 plans (hyb bf16 and f32 with the slot->edge maps, degree bf16, the "
          f"edge CSR op): {time.perf_counter() - t0:.1f} s", flush=True)
    bench_cells, bench_epochs, bench_counts = bench_phase(g, ops)

    # 12c. the card's switch points, also before any torch.profiler session
    stamp("phase 12c")
    t0 = time.perf_counter()
    sg = partition_graph(g, RANKS)
    print(f"{RANKS}-way range partition: vp {sg.vp}, max_h {sg.max_h}, edges per shard "
          f"{[s.num_edges for s in sg.shards]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    gb = build_graph(450_000, 16, REDDIT["feat"], REDDIT["classes"], seed=2)
    print(f"450k-vertex graph: V={gb.num_vertices} E={gb.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    switch_res = switch_phase(g, gb, sg, layers, ops)

    # 3g. K8, K9, K10 vs plain on rank 0's shard of the 4-way partition
    stamp("phase 3g, 3h")
    shard0 = sg.shards[0]
    ne0 = shard0.num_edges
    csr0 = csr_pattern(shard0.src[:ne0], shard0.dst[:ne0], sg.vp)
    csr0["norm"] = torch.tensor(shard0.edge_val[:ne0], device="cuda")
    csr0["ones"] = torch.ones_like(csr0["norm"])
    csr0["src_rows"] = int(np.unique(shard0.src[:ne0]).size)
    # the transpose (table rows x vp) for the fused backward's yardstick
    order0 = np.argsort(shard0.src[:ne0], kind="stable")
    csr0["t"] = csr_pattern(shard0.dst[:ne0][order0], shard0.src[:ne0][order0],
                            sg.vp + RANKS * sg.max_h)
    csr0["t"]["norm"] = csr0["norm"][torch.as_tensor(order0, device="cuda")]
    csr0["t"]["ones"] = csr0["ones"]
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

    # 3h. the sharded degree op on the same shard: its three plans, the
    # interior and boundary hyb plans, the pair against the combined plan
    sharded_degree_results = []
    deg_ops = {}
    for edges in ("combined", "interior", "boundary"):
        es, ed, ev = shard_edges(shard0, edges)
        csr_e = csr_pattern(es, ed, sg.vp)
        csr_e["norm"] = torch.tensor(ev, device="cuda")
        csr_e["src_rows"] = int(np.unique(es).size)
        for gd in (torch.bfloat16, None):
            t0 = time.perf_counter()
            dop = ShardedDegreeSpMM(shard0, RANKS, edges=edges, static_vals=True,
                                    gather_dtype=gd, device="cuda")
            print(f"sharded degree plans ({edges}, {gd}): {dop.num_edges} edges, table "
                  f"{dop.num_in} rows ({csr_e['src_rows']} read), "
                  f"{dop.fwd['part']['rows'].shape[0]} block rows "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            deg_ops[edges, gd] = dop
            for f in (128, 41):
                sharded_degree_results.append(compare_degree(
                    f"reddit_shard0_{edges}", dop, f, seed=f + 30,
                    timed=gd is torch.bfloat16 or f == 128, csr=csr_e, key="degree_sharded"))
            if edges != "combined":
                hop_e = ShardedHybSpMM(shard0, RANKS, edges=edges, static_vals=True,
                                       gather_dtype=gd, device="cuda")
                for f in (128, 41):
                    compare_hyb_split(f"reddit_shard0_{edges}", hop_e, f, seed=f + 31)
                del hop_e
        del csr_e
    gen = torch.Generator(device="cuda").manual_seed(33)
    pair_vs_combined = {"case": "reddit_shard0 interior+boundary vs combined", "F": 128}
    h0, gh0 = randn(gen, sg.vp, 128), randn(gen, RANKS * sg.max_h, 128)
    t0_ = torch.cat([h0, gh0])
    for gd, dtype in ((None, "float32"), (torch.bfloat16, "bfloat16")):
        op_c, op_i, op_b = (deg_ops[e, gd] for e in ("combined", "interior", "boundary"))
        pair_vs_combined["dtype"] = dtype
        close(pair_vs_combined, None, f"{dtype}_pair", op_i.apply_static(h0)
              + op_b.apply_static(gh0), op_c.apply_static(t0_), dtype)
        pair_vs_combined[f"{dtype}_pair_ms"] = cuda_ms(
            lambda: op_i.apply_static(h0) + op_b.apply_static(gh0), 20)
        pair_vs_combined[f"{dtype}_combined_ms"] = cuda_ms(lambda: op_c.apply_static(t0_), 20)
    print("compare " + json.dumps(pair_vs_combined), flush=True)
    del deg_ops, h0, gh0, t0_
    torch.cuda.empty_cache()
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
    # K9 and K10 at F = 64 (phase 9's exchange width: 128 split 2 ways) on
    # rank 0's plan of the 2-way partition (phase 9's graph shards)
    t0 = time.perf_counter()
    sg2 = partition_graph(g, 2)
    print(f"2-way range partition: vp {sg2.vp}, max_h {sg2.max_h}, edges per shard "
          f"{[s.num_edges for s in sg2.shards]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    cnt2 = np.stack([halo.ghost_counts(s, 2, sg2.vp, sg2.max_h) for s in sg2.shards], axis=1)
    plan2_0 = halo.HaloPlan(sg2.shards[0], 2, "ragged", "cuda", counts=(cnt2[0], cnt2[:, 0]))
    for dtype in ("float32", "bfloat16"):
        halo_results.append(compare_halo("reddit2_shard0", plan2_0, 64, dtype, seed=64,
                                         timed=True))
    del plan2_0
    torch.cuda.empty_cache()

    stamp("phase 3, 3b, 3d")
    csr = csr_pattern(g.src, g.dst, v)
    csr["norm"] = torch.tensor(g.edge_norm, device="cuda")
    csr["ones"] = torch.ones_like(csr["norm"])
    # the transposed CSR, K7's dh yardstick: src-sorted edges, values val[order]
    order = np.argsort(g.src, kind="stable")
    tcsr = csr_pattern(g.dst[order], g.src[order], v)
    csr.update(t_row_ptr=tcsr["row_ptr"], t_col=tcsr["col"],
               order=torch.as_tensor(order, device="cuda"))
    del tcsr
    results = []
    for gd in (torch.bfloat16, None):
        # Phase 12's static plans with the slot->edge maps: K1 reads their
        # values, K2 only their live counts, K7 the per-edge values through s2e.
        op = ops.pop("bf16" if gd is torch.bfloat16 else "f32")
        print(f"plans ({gd}): fwd {len(op.fwd['buckets'])} buckets, top "
              f"{op.fwd['top'] is not None}, layout "
              f"{'n_iso' if 'n_iso' in op.fwd else 'inv'}; bwd layout "
              f"{'n_iso' if 'n_iso' in op.bwd else 'inv'}", flush=True)
        for f in (128, 41):
            # timed at the main path's shapes (bf16, both widths) and one f32
            timed = gd is torch.bfloat16 or f == 128
            results.append(compare("reddit", op, f, seed=f, timed=timed, csr=csr))
            results.append(compare_mask("reddit", op, f, seed=f + 2, timed=timed, csr=csr))
            results.append(compare_dyn("reddit", op, f, seed=f + 4, timed=timed, csr=csr))
        # F = 64: the width tensor parallelism aggregates at (phase 9)
        results.append(compare("reddit", op, 64, seed=64, timed=True, csr=csr))
        results.append(compare_mask("reddit", op, 64, seed=66, timed=True, csr=csr))
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

    # 10. the Amazon config past the L2, through the reference-config tool
    # (here, while torch.profiler's kernel-only readings agree with the pass
    # times: late in the script its sessions lose about half the device
    # events of a call at this size)
    stamp("phase 10")
    amazon = amazon_phase(amazon_graph(graph_proc, graph_path))
    shutil.rmtree(graph_dir, ignore_errors=True)
    # 12b's graph, mining and plans: made in a process of its own meanwhile
    largev_dir = tempfile.mkdtemp(prefix="dorylus_smoke_largev_")
    largev_path = f"{largev_dir}/largev.npz"
    largev_proc = multiprocessing.get_context("spawn").Process(
        target=bench.largev_worker, args=(largev_path,), daemon=True)
    largev_proc.start()

    # 3c. K3, K4, K5 vs plain
    stamp("phase 3c")
    eop = ops.pop("edge")  # phase 12's
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
    stamp("phase 3e")
    degree_results = []
    for gd in (torch.bfloat16, None):
        t0 = time.perf_counter()
        dop = (ops.pop("degree") if gd is torch.bfloat16  # phase 12's
               else DegreeSpMM(g.src, g.dst, v, v, gather_dtype=gd, static_val=g.edge_norm,
                               device="cuda"))
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
    stamp("phase 3f")
    t0 = time.perf_counter()
    cg = bench.community_graph(REDDIT["v"], REDDIT["deg"], REDDIT["feat"], REDDIT["classes"],
                               **bench.COMMUNITY)
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
    reuse_results = [compare_reuse(rop, hop, f, gd, seed=13 + f)
                     for gd in (torch.bfloat16, None) for f in (128, 41)]
    ref_op = HybSpMM(psrc, pdst, 20_000, 20_000, max_width=8, static_val=pval,
                     dynamic=True, device="cuda")
    refuses_bad_input(ref_op, peop, rop, hub_fop)
    del rop, hop, ref_op, peop, levels2, hub_fop, csr
    torch.cuda.empty_cache()

    # 3i. the sharded reuse op on rank 0's shard of the community graph
    stamp("phase 3i")
    t0 = time.perf_counter()
    sgc = partition_graph(cg, RANKS)
    cshard = sgc.shards[0]
    ctable = sgc.vp + RANKS * sgc.max_h
    print(f"community graph, {RANKS}-way range partition: vp {sgc.vp}, max_h {sgc.max_h}, "
          f"edges per shard {[s_.num_edges for s_ in sgc.shards]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cap_s, on = resolve_reuse_budget(reuse_cfg, ctable, _max_agg_width(layers, reuse_cfg, ctable))
    check(on, "the sharded pair budget turned reuse off")
    # the ghosts' factors as each owner holds them (the engine's ranks
    # exchange them; here one process holds every shard)
    f_loc = [np.sqrt(s_.self_val) for s_ in sgc.shards]
    f_ghost = np.concatenate([f_loc[q][sgc.shards[q].send_idx[0]] for q in range(RANKS)])
    srop = ShardedReuseSpMM(cshard, RANKS, rank1_factor=np.concatenate([f_loc[0], f_ghost]),
                            gather_dtype=torch.bfloat16, max_pairs=cap_s, device="cuda")
    shop = ShardedHybSpMM(cshard, RANKS, gather_dtype=torch.bfloat16, device="cuda")
    st = srop.plan_fwd.stats
    sharded_reuse_info = {
        "miner": srop.miner, "mine_s": list(srop.mine_seconds), "cap": cap_s,
        "fwd_pairs": srop.plan_fwd.num_pairs, "bwd_pairs": srop.plan_bwd.num_pairs,
        "rows_before": st["rows_before"], "rows_after": st["rows_after"],
        "row_cut": st["row_reduction"], "table_rows": ctable, "edges": cshard.num_edges}
    print("sharded reuse op, community shard 0: " + json.dumps(sharded_reuse_info), flush=True)
    check(srop.num_pairs > 0 and srop.plan_bwd.num_pairs > 0, "the shard mined no pairs")
    for case, lv, size, base in (
            ("community_shard0_fwd", list(srop.lvl_fwd), srop.fwd_table_size, srop.num_in),
            ("community_shard0_bwd", list(srop.lvl_bwd), srop.bwd_table_size, srop.num_out)):
        for dtype in ("float32", "bfloat16"):
            for f in (128, 41):
                pair_results.append(compare_pairs(case, lv, size, base, f, dtype, seed=17 + f))
    sharded_reuse_results = [
        compare_reuse(srop, shop, f, gd, seed=19 + f, case="community_shard0",
                      key="reuse_sharded")
        for gd in (torch.bfloat16, None) for f in (128, 41)]
    gen = torch.Generator(device="cuda").manual_seed(23)
    tb = randn(gen, ctable, 128)
    rank1 = {"case": "community_shard0 apply_static", "F": 128}
    close(rank1, None, "rank1", srop.apply_static(tb),
          shop.apply_unit(tb * srop.f_in[:, None]) * srop.f_out[:, None], "bfloat16")
    print("compare " + json.dumps(rank1), flush=True)
    del srop, shop, tb
    torch.cuda.empty_cache()

    stamp("phase 3j")
    # 3j. the primitive probes: a fast first check, then the probe's main
    # path with its launch counts set to 0 just before. `measure` holds each
    # timed launch (100,000 ops a stream, the card's grid, both P3 tables)
    # against its plain version on the same inputs: the errors of the
    # `kernels` line are those, at the shape that is timed and counted.
    print("probes vs plain at 2,000 ops a stream, max abs err: "
          + json.dumps(probe_prims.check_against_plain("cuda")), flush=True)
    for k in probe_prims.LAUNCHES:
        probe_prims.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    # P3 on tables of K1's size (60 MB: the bf16 Reddit table) and K3's (119
    # MB: the f32 F=128 one), beside 32 MB (in the L2) and 1 GB (device memory)
    probe_res = probe_prims.measure("cuda", n_ops=100_000, dma_rows=probe_prims.DMA_ROWS)
    probe_launches = dict(probe_prims.LAUNCHES)
    probe_err = {k: probe_res[k]["max_abs_err"] for k in probe_launches}
    print(f"probes ({time.perf_counter() - t0:.1f} s): " + json.dumps(probe_res), flush=True)
    # The library yardsticks, timed here and used nowhere in the port, on the
    # tensors `measure` ran on: P1's function is one `embedding_bag` (a bag a
    # stream, summed), P2's one `bincount` over idx + stream * blocks (spread
    # over the row-block as the scratch is), P3's one `index_select` of each
    # stream's last 16 rows. No single call sums P4's cycled gathers.
    inp, blocks = probe_prims.card_inputs("cuda")
    ptab, pidx = inp.tiles(blocks, probe_res["n_ops"])
    bags = pidx.long()
    flat = (bags + blocks * torch.arange(len(pidx), device="cuda")[:, None]).flatten()

    def p1_library():
        return torch.nn.functional.embedding_bag(bags, ptab.view(blocks, -1), mode="sum")

    def p2_library():
        return torch.bincount(flat, minlength=len(pidx) * blocks)

    # (one serial f32 chain a bag: 1e-3 here, where the kernel holds 1e-4)
    ref = probe_prims.dyn_load_plain(ptab, pidx)
    lib_err = float((p1_library().view(-1, 8, 128) - ref).abs().max())
    check(lib_err <= 1e-3 * float(ref.abs().max()),
          f"P1: embedding_bag differs from the plain version by {lib_err:.3e}")
    del ref
    check(torch.equal(p2_library().view(-1, blocks).float(),
                      probe_prims.dyn_rmw_plain(pidx, blocks)[:, :, 0, 0]),
          "P2: bincount differs from the plain version")
    probe_lib = {"P1": library_ms(p1_library, "embedding_bag"),
                 "P2": library_ms(p2_library, "bincount"), "P4": None}
    del ptab, pidx, bags, flat
    ptab, pidx = inp.copies(65_536, probe_res["n_ops"])
    last = pidx[:, -probe_prims.DEPTH:].flatten()  # op i sits in slot i % 16: in order here
    check(probe_res["n_ops"] % probe_prims.DEPTH == 0, "P3: the ring's slots are rotated")
    check(torch.equal(torch.index_select(ptab, 0, last).view(-1, probe_prims.DEPTH, 128),
                      probe_prims.row_copy_plain(ptab, pidx)),
          "P3: index_select differs from the plain version")
    probe_lib["P3"] = library_ms(lambda: torch.index_select(ptab, 0, last), "index_select")
    print("probe library calls, ms: " + json.dumps(probe_lib), flush=True)
    del ptab, pidx, last, inp
    torch.cuda.empty_cache()

    # 4. main path, GCN
    stamp("phase 4, 4b")
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
    stamp("phase 4c")
    edge_counts = {}
    edge_times = {}
    edge_steps = {}
    hyb_f32_losses = {}
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        cfg = TrainConfig(epochs=3, eval_every=1, model=model, kernel="xla",
                          learning_rate=lr, reuse="off")
        eng, rep_x, counts = train(g, layers, cfg, f"reddit-config {model} xla")
        edge_times[model] = {
            "warm_epoch_ms": float(np.mean([e.time_ms for e in rep_x.epochs][1:])),
            "step_ms": cuda_ms(lambda: eng._train_epoch(lr), 5)}
        edge_steps[model] = step_launches(lambda: eng._train_epoch(lr))
        print(f"reddit-config {model} xla f32: {json.dumps(edge_times[model])}, launches per "
              f"train step {json.dumps(edge_steps[model])}", flush=True)
        del eng
        torch.cuda.empty_cache()
        # GCN: the forward and dh alone (its norms need no gradient); GAT: the
        # forward, and dh with the value gradient in one launch
        for k in ("K3",) + (("K3_dh_dval", "K5") if model == "gat" else ("K3_dh",)):
            check(counts[k] > 0, f"{model} xla: no {k} launch")
        check(counts["K4"] == 0 and (model == "gat" or counts["K3_dh_dval"] == 0),
              f"{model} xla: launches {json.dumps(counts)}")
        for k in ("K3", "K3_dh", "K3_dh_dval", "K4", "K5"):
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

    stamp("phase 4g")
    # 4g. the edgewise path past 400k vertices: kernel="auto" resolves to
    # xla under 8M edges, and the engine takes JAX's dst-blocked branch
    check(gb.num_vertices > 400_000 and gb.num_edges < 8_000_000,
          f"the dst-blocked graph has V={gb.num_vertices}, E={gb.num_edges}")
    eng, rep, counts = train(gb, layers, TrainConfig(epochs=2, eval_every=1, kernel="auto",
                                                     reuse="off"), "450k-vertex GCN auto")
    losses = [e.loss for e in rep.epochs]
    check(eng.kernel_selected == "xla+dst_blocked",
          f"450k-vertex GCN auto: kernel {eng.kernel_selected}, want xla+dst_blocked")
    check(losses[-1] < losses[0], f"450k-vertex GCN auto: losses {losses} did not fall")
    check(counts["K3"] > 0 and counts["K3_dh"] > 0,
          f"450k-vertex GCN auto: launches {json.dumps(counts)}")
    blocked_times = {"vertices": gb.num_vertices, "edges": gb.num_edges,
                     "kernel": eng.kernel_selected, "losses": losses,
                     "step_ms": cuda_ms(lambda: eng._train_epoch(0.01), 3),
                     "launches_per_step": step_launches(lambda: eng._train_epoch(0.01))}
    print(f"450k-vertex GCN auto: {json.dumps(blocked_times)}", flush=True)
    del eng, gb
    torch.cuda.empty_cache()

    # 4d. main path, kernel="degree"
    stamp("phase 4d")
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
    stamp("phase 4e")
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

    # 12b. the bench's reuse cells, its baseline and its record
    stamp("phase 12b")
    bench_rec = bench_reuse_phase(largev_proc, largev_path, g, cg, bench_cells, bench_epochs,
                                  card)
    shutil.rmtree(largev_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    stamp("phase 4f")
    # 4f. main path, dynamic values: GCN on ops without static values, then
    # the same with the edge values requiring a gradient (a model that learns
    # its edge weights): its backward takes K7's fused dh + dval pass
    batch = build_batch(g, "cuda")  # with the COO arrays: apply reads edge_val
    learned = batch._replace(edge_val=batch.edge_val.clone().requires_grad_(True))
    dyn_counts = {"K7": 0, "K7_dh": 0, "K7_dh_dval": 0}
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
        for vals, b in (("", batch), (" learned values", learned)):
            if kind_ == "hyb-static" and vals:
                continue
            label = kind_ + vals
            reset_counts()
            losses, step_ms, counts, per_step = gcn_steps(layers, op, b, steps=3)
            print(f"reddit-config GCN, {label} op: losses {json.dumps(losses)} train step "
                  f"{step_ms:.3f} ms, launches per train step {json.dumps(per_step)}",
                  flush=True)
            dyn_times[label] = {"step_ms": step_ms, "launches_per_step": per_step}
            check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"{label}: losses {losses} not finite and falling")
            if kind_ == "hyb-static":
                static_l = np.array(losses)
                continue
            # one launch a dynamic pass: two forwards and two backward passes a step
            want = ({"K7": 2, "K7_dh_dval": 2} if vals else {"K7": 2, "K7_dh": 2})
            got = {k: per_step.get(k, 0) for k in dyn_counts}
            check(got == {k: want.get(k, 0) for k in dyn_counts},
                  f"{label}: K7 launches a step {got}, want {want}")
            for k in dyn_counts:
                dyn_counts[k] += counts[k]
            gap = float(np.max(np.abs(np.array(losses) - static_l) / np.abs(static_l)))
            print(f"  {label} vs hyb-static max relative loss gap {gap:.3e}", flush=True)
            check(gap <= 1e-4, f"{label}: losses differ from the static path by {gap:.3e}")
        del op
        torch.cuda.empty_cache()
    del batch, learned

    # 5, 5b, 5c. card vs CPU on small graphs
    stamp("phase 5, 5b, 5c")
    gp = synthetic_graph(2000, 8, REDDIT["feat"], REDDIT["classes"], seed=8888)
    cfg = TrainConfig(epochs=5, eval_every=1, kernel="hyb", reuse="off")
    gpu_l = [e.loss for e in Engine(gp, layers, cfg, device="cuda").run().epochs]
    cpu_l = [e.loss for e in Engine(gp, layers, cfg, device="cpu").run().epochs]
    gap = float(np.max(np.abs(np.array(gpu_l) - np.array(cpu_l))))
    print(f"planted graph card vs CPU: max loss gap {gap:.3e} over 5 epochs "
          f"(gpu {gpu_l[0]:.5f} -> {gpu_l[-1]:.5f})", flush=True)
    check(gap <= 1e-3, f"card and CPU trajectories differ by {gap:.3e} > 1e-3")
    gs = bench.community_graph(4000, 20, REDDIT["feat"], REDDIT["classes"], comm=40, core=30,
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
        cfg = TrainConfig(epochs=3 if graph is gs else 5, eval_every=1, model=model,
                          kernel=kernel, reuse=reuse, reuse_passes=2,
                          learning_rate=0.005 if model == "gat" else 0.01)
        rgap = planted_pair(graph, layers, cfg, f"{model} {kernel} reuse={reuse}")
        check(rgap <= 1e-5, f"{model} {kernel} reuse={reuse}: card and CPU differ by "
                            f"{rgap:.3e} relative > 1e-5")
    # reuse="auto" (the default) on the community graph at the default
    # horizon: the branch the card's gate predicts, 3 epochs bit for bit
    # with the explicit setting of that branch
    for model, lr in (("gcn", 0.01), ("gat", 0.005)):
        cfg = TrainConfig(eval_every=1, model=model, kernel="hyb", learning_rate=lr)
        worth = reuse_payoff(cfg, gs.num_vertices, gs.num_edges)[0]
        eng = Engine(gs, layers, cfg, device="cuda")
        took = "pairs" if isinstance(eng.model.spmm_op, ReuseSpMM) else "off"
        check(worth or took == "off", f"reuse auto {model}: the gate is shut and it mined")
        auto_l = [e.loss for e in eng.run(3).epochs]
        want_l = [e.loss for e in Engine(gs, layers, dataclasses.replace(cfg, reuse=took),
                                         device="cuda").run(3).epochs]
        print(f"reuse auto {model} on the 4,000-vertex community graph at {cfg.epochs} "
              f"epochs: the gate {'opens' if worth else 'is shut'}, took {took}; losses "
              f"{json.dumps(auto_l)}", flush=True)
        check(auto_l == want_l, f"reuse auto {model}: losses {auto_l}, reuse={took} {want_l}")
        del eng

    # 11b. a traced replayed group; the graph path on the other kernels
    stamp("phase 11b")
    graph_res.update(graph_phase_b(graph_eng, gs, layers))
    del graph_eng
    torch.cuda.empty_cache()

    # 6, 6b, 6c. the sharded engine: 4 ranks on the card
    stamp("phase 6, 6d, 6f, 9, 6e, 6b, 6c")
    torch.cuda.empty_cache()
    sharded = sharded_phases(sg, sg2, sgc, layers, hyb_f32_losses, sources)

    # 7. the command line: checkpoints, resume, staleness, infer, --shards
    stamp("phase 7")
    del g, cg
    torch.cuda.empty_cache()
    cli_times = cli_phases(card)

    # 13. the weak-scaling harness's device mode: the port's NCCL group
    stamp("phase 13")
    torch.cuda.empty_cache()
    weak = weak_scaling_phase()

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
    # This slice's paths: rank 0's combined degree plan (6d's combined run and
    # the pair's two halves run the same pass), its reuse pass (6e).
    ks = pick(sharded_degree_results, case="reddit_shard0_combined", dtype="bfloat16", F=128)
    ksr = pick(sharded_reuse_results, dtype="bfloat16", F=128)
    # Phase 9's widths: GCN under TP gathers f32 tables at F = 64 (K1), GAT
    # bf16 ones (K2, its first layer); the exchange runs in f32 at 64.
    k1t = pick(results, kernel="K1", case="reddit", dtype="float32", F=64)
    k2t = pick(results, kernel="K2", case="reddit", dtype="bfloat16", F=64)
    kht = pick(halo_results, case="reddit2_shard0", dtype="float32", F=64)
    # Phase 10's widths on the Amazon plan: F = 64 and 25 (32 as padded)
    ka64, ka25, km64 = (pick(amazon["results"], kernel=k, F=f)
                        for k, f in (("K1", 64), ("K1", 25), ("K2", 64)))
    # phase 8's brackets beside phase 3's passes at the same width and dtype
    # (GAT's bracket is K2's pass and the row scale)
    beside = {}
    for model, slot in (("gcn", "K1"), ("gat", "K2")):
        for l, f in enumerate(stages[model]["widths"]):
            row = pick(results, kernel=slot, case="reddit", dtype="bfloat16", F=f)
            beside[f"{model} aggregate_l{l} F={f}"] = {
                "bracket_ms": stages[model]["stages_ms"][f"aggregate_l{l}_ms"],
                f"{slot}_pass_ms": row["fwd_ms"]}
    print("phase 8 aggregate brackets beside phase 3's passes: " + json.dumps(beside),
          flush=True)

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
        # K3's dh alone over the src CSR (GCN's backward)
        "K3_dh": ("csr_spmm_dh", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:74",
                  edge_counts["K3_dh"], ke["K3_bwd_ms"], ke["K3_bwd_plain_ms"], ke["K3_dh"]),
        # dh and the value gradient in one pass (GAT's backward); its
        # library time is two calls, sparse.mm + sampled_addmm
        "K3_dh_dval": ("csr_spmm_dval", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:74",
                       edge_counts["K3_dh_dval"], ke["K3_dh_dval_ms"],
                       ke["K3_dh_dval_plain_ms"], ke["K3_dh_dval"]),
        # K4's value gradient: the main path runs it inside K3's dh pass (the
        # row above); its launches are those, its times K4 alone's
        "K4": ("sddmm", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:74",
               edge_counts["K4"] + edge_counts["K3_dh_dval"], ke["K4_ms"], ke["K4_plain_ms"],
               ke["K4"]),
        "K5": ("segment_sum", "edge_spmm.cu", "dorylus_tpu/ops/spmm.py:185",
               edge_counts["K5"], ke["K5_vec_ms"], ke["K5_vec_plain_ms"], ke["K5"]),
        "K6": ("pair_build", "pair_build.cu", "dorylus_tpu/ops/reuse_spmm.py:37",
               reuse_counts["K6"], k6["ms"], k6["plain_ms"], k6),
        # K7's three passes, launches from 4f: the forward and dh alone of the
        # dynamic ops' steps, dh + dval of the steps with learned edge values
        "K7": ("hyb_dynamic_pass", "dyn_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:476",
               dyn_counts["K7"], k7["fwd_ms"], k7["fwd_plain_ms"], k7),
        "K7_dh": ("hyb_dynamic_pass_dh", "dyn_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:488",
                  dyn_counts["K7_dh"], k7["dh_ms"], k7["dh_plain_ms"], k7["dh"]),
        "K8": ("fused_pass", "fused_spmm.cu", "dorylus_tpu/ops/hyb_sharded.py:501",
               sharded["launches"]["K8"], k8["fwd_ms"], k8["fwd_plain_ms"], k8),
        # the fused plan's backward (JAX `_fused_bwd_pass`): K1 over the
        # transpose plan into one buffer, its launches those of the fused runs
        "K8 backward": ("fused_bwd_pass", "hyb_spmm.cu", "dorylus_tpu/ops/hyb_sharded.py:508",
                        sharded["launches"]["K1"], k8["bwd_ms"], k8["bwd_plain_ms"],
                        k8["bwd"]),
        "K9": ("halo_row_gather", "halo.cu", "dorylus_tpu/parallel/halo.py:118",
               sharded["launches"]["K9"], kh["K9_ms"], kh["K9_plain_ms"], kh["K9"]),
        "K10": ("halo_segsum", "halo.cu", "dorylus_tpu/parallel/halo.py:132",
                sharded["launches"]["K10"], kh["K10_ms"], kh["K10_plain_ms"], kh["K10"]),
        # the same kernels at tensor parallelism's width (phase 9's launches)
        "K1 F=64": ("hyb_static_pass_f64_tp", "hyb_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:392",
                    sharded["launches"]["K1_tp"], k1t["fwd_ms"], k1t["fwd_plain_ms"], k1t),
        "K2 F=64": ("hyb_mask_pass_f64_tp", "hyb_spmm.cu", "dorylus_tpu/ops/hyb_spmm.py:508",
                    sharded["launches"]["K2_tp"], k2t["fwd_ms"], k2t["fwd_plain_ms"], k2t),
        "K9 F=64": ("halo_row_gather_f64_tp", "halo.cu", "dorylus_tpu/parallel/halo.py:118",
                    sharded["launches"]["K9_tp"], kht["K9_ms"], kht["K9_plain_ms"], kht["K9"]),
        "K10 F=64": ("halo_segsum_f64_tp", "halo.cu", "dorylus_tpu/parallel/halo.py:132",
                     sharded["launches"]["K10_tp"], kht["K10_ms"], kht["K10_plain_ms"],
                     kht["K10"]),
        # the same kernels on the Amazon plan, tables past the L2 (phase 10's
        # launches at each width)
        "K1 amazon F=64": ("hyb_static_pass_amazon_f64", "hyb_spmm.cu",
                           "dorylus_tpu/ops/hyb_spmm.py:392", amazon["launches"]["K1"]["64"],
                           ka64["fwd_ms"], ka64["fwd_plain_ms"], ka64),
        "K1 amazon F=25": ("hyb_static_pass_amazon_f25", "hyb_spmm.cu",
                           "dorylus_tpu/ops/hyb_spmm.py:392", amazon["launches"]["K1"]["32"],
                           ka25["fwd_ms"], ka25["fwd_plain_ms"], ka25),
        "K2 amazon F=64": ("hyb_mask_pass_amazon_f64", "hyb_spmm.cu",
                           "dorylus_tpu/ops/hyb_spmm.py:508", amazon["launches"]["K2"]["64"],
                           km64["fwd_ms"], km64["fwd_plain_ms"], km64),
        "degree": ("degree_pass", "hyb_spmm.cu", "dorylus_tpu/ops/degree_spmm.py:132",
                   degree_counts, kd["static_fwd_ms"], kd["static_fwd_plain_ms"], kd),
        "reuse": ("reuse_unit_pass", "hyb_spmm.cu", "dorylus_tpu/ops/reuse_spmm.py:47",
                  reuse_counts["K2"], kr["fwd_ms"], kr["fwd_plain_ms"], kr),
        "K7_dh_dval": ("hyb_dynamic_pass_bwd", "dyn_spmm.cu",
                       "dorylus_tpu/ops/hyb_spmm.py:488", dyn_counts["K7_dh_dval"],
                       k7["bwd_ms"], k7["bwd_plain_ms"], k7["bwd"]),
        "degree_sharded": ("sharded_degree_pass", "hyb_spmm.cu",
                           "dorylus_tpu/ops/degree_sharded.py:72",
                           sharded["launches"]["degree"], ks["static_fwd_ms"],
                           ks["static_fwd_plain_ms"], ks),
        "reuse_sharded": ("sharded_reuse_pass", "hyb_spmm.cu",
                          "dorylus_tpu/ops/reuse_sharded.py:120",
                          sharded["launches"]["K2_reuse"], ksr["fwd_ms"], ksr["fwd_plain_ms"],
                          ksr),
    }
    kernels = []

    def add(key, name, source, replaces, launches, ms, plain_ms, row):
        kernels.append({"name": name, "route": "cuda", "source": src_dir + source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": {**MAX_ERR, **probe_err}[key.split()[0]],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": lib(row)})

    for k, fields in entry.items():
        add(k, *fields)
    # K5, K9 and K10: beside the pass ms, the kernel's own device ms and the
    # host's microseconds to enqueue one pass; K6: its launches' device ms
    for k in kernels:
        for name, row, key in (("segment_sum", ke, "K5_vec"), ("halo_row_gather", kh, "K9"),
                               ("halo_segsum", kh, "K10"), ("halo_row_gather_f64_tp", kht, "K9"),
                               ("halo_segsum_f64_tp", kht, "K10")):
            if k["name"] == name:
                k.update(kernel_ms=row[f"{key}_kernel_ms"], host_us=row[f"{key}_host_us"])
        for name, row in (("hyb_static_pass_f64_tp", k1t), ("hyb_mask_pass_f64_tp", k2t),
                          ("hyb_static_pass_amazon_f64", ka64),
                          ("hyb_static_pass_amazon_f25", ka25),
                          ("hyb_mask_pass_amazon_f64", km64)):
            if k["name"] == name:
                k["kernel_ms"] = row["fwd_kernel_ms"]
        if k["name"] == "pair_build":
            k["kernel_ms"] = k6["kernel_ms"]
        if k["name"] == "fused_bwd_pass":
            k["kernel_ms"] = k8["bwd_kernel_ms"]
        if k["name"] == "fused_pass":
            # the two ranges the engines launch (phase 13's r5 shard: the
            # pass ms of each, both, one launch; each range's kernel ms),
            # and phase 6's launches of K8 and of its pure range a step
            timed = next(r for r in weak["k8_ranges"] if "pure_ms" in r)
            k["ranges"] = dict(
                {key: timed[key] for key in (
                    "case", "F", "dtype", "n_pure", "pure_edges", "mixed_edges", "pure_ms",
                    "mixed_ms", "both_ms", "one_launch_ms", "plain_ms", "pure_kernel_ms",
                    "mixed_kernel_ms")},
                phase6_launches_per_step={
                    label: [{key: r.get(key, 0) for key in ("K8", "K8_pure")}
                            for r in sharded["timings"][label]["launches_per_step"]]
                    for label in ("gcn fused", "gat fused")})
    # The probes, on the grid that fills the card, bound by what each uses:
    # P1 reads a 4 KB tile from shared memory per op and block (one f32 add
    # per element), P2 reads and writes it; P3 moves each row it copies
    # once from device memory; P4 runs 128 warp shuffles per op and warp
    # (one add per gathered element).
    n_ops, tiles = probe_res["n_ops"], 8 * 128
    p1, p2, p4 = (probe_res[k]["card"] for k in ("P1", "P2", "P4"))
    p3_tab = probe_res["P3"]["tables"]["65536"]
    p3 = p3_tab["card"]
    probe_rows = {
        "P1": ("probe_dyn_load", ":66", p1, probe_res["P1"]["plain_ms"], probe_bound(
            p1["streams"] * n_ops * tiles * 4, 0, p1["streams"] * n_ops * tiles, sm_hz, n_sms)),
        "P2": ("probe_dyn_rmw", ":76", p2, probe_res["P2"]["plain_ms"], probe_bound(
            2 * p2["streams"] * n_ops * tiles * 4, 0, p2["streams"] * n_ops * tiles, sm_hz,
            n_sms)),
        "P3": ("probe_row_copy", ":123", p3, p3_tab["plain_ms"], bound(
            min(p3_tab["table_bytes"], p3["streams"] * n_ops * 512)
            + p3["streams"] * (n_ops * 4 + 16 * 512), 0)),
        "P4": ("probe_lane_gather", ":154", p4, probe_res["P4"]["plain_ms"], probe_bound(
            0, p4["streams"] * n_ops * 128, p4["streams"] * n_ops * tiles, sm_hz, n_sms)),
    }
    for k, (name, line, card_row, plain_ms, row) in probe_rows.items():
        add(k, name, "probe_prims.cu", "tools/probe_pallas_prims.py" + line, probe_launches[k],
            card_row["ms"], plain_ms, dict(row, library_ms=probe_lib[k]))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on its main path")
    print("timings " + json.dumps({"gcn_hyb_bf16": gcn_times, "gat_hyb_bf16": gat_times,
                                   "epoch_graphs": graph_res,
                                   "sharded_epoch_graphs": sharded_graph_res,
                                   "xla_f32": edge_times,
                                   "xla_dst_blocked_450k": blocked_times,
                                   "xla_f32_launches_per_step": edge_steps,
                                   "degree_bf16": degree_times,
                                   "community_bf16": reuse_times,
                                   "gcn_value_ops_bf16": dyn_times,
                                   "sharded_4_ranks": sharded["timings"],
                                   "sharded_reuse_shard0": sharded_reuse_info,
                                   "degree_pair_vs_combined_shard0": pair_vs_combined,
                                   "bench": bench_rec, "bench_launches": bench_counts,
                                   "switch_points": switch_res,
                                   "cli_seconds": cli_times,
                                   "weak_scaling_r5": weak,
                                   "amazon_0.12": {k: amazon[k] for k in ("graph_s", "plan_s",
                                                                           "steps")},
                                   "stages_1_device": stages}),
          flush=True)
    stamp("done")
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:]:
        fail(f"usage: python3 chip_smoke.py (got {sys.argv[1:]})")
    main()
