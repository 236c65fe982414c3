"""Per-stage profiling and cost accounting (port of
dorylus_tpu/engine/profiling.py: the same functions, returning dicts with
the same keys).

The reference reports per-stage times (Aggregation / ApplyVertex / Scatter
/ ApplyEdge, forward and backward per layer, engine/utils.cpp:139-291) and
a dollar cost (calculate-price.py). Here each stage is a bracket around the
call the model makes for it, timed alone:

  * aggregate_l{l}_ms: the aggregation pass layer l runs, at the width and
    through the entry the model uses (GCN `apply_static` at its aggregation
    width on static values, else `apply` with the batch's edge values; GAT
    `apply_dst` at its output width; the edgewise CSR op without a slot
    op); aggregate_l{l}_bwd_ms its backward (autograd of a sum of squares:
    the transposed pass the training backward runs);
  * dense_l{l}_ms: the (V, fin) @ (fin, fout) layer matmul, tanh on GCN
    hidden layers;
  * forward_ms, loss_and_grad_ms: the model's forward, and its loss with
    the gradients of every parameter;
  * sharded (`profile_stages_sharded`): halo_l{l}_ms, the exchange alone
    (only with more than one graph shard), and aggregate_l{l}_ms on a
    stand-in ghost table gathered locally, so that it holds no collective.

The JAX package aggregates past a TPU gather-table cliff at another width
(`past_agg_cliff`); the port's models do not (ROADMAP "Not to port"), and
the brackets follow the port's models (`agg_width`). Under tensor
parallelism the brackets time the F/m slice a rank aggregates and
exchanges (JAX times the full width there).

Timing: one untimed call, then `iters` calls between two CUDA events on the
card, or the host clock around them, ended by a synchronising read, on the
CPU. Take the brackets before any torch.profiler session in the process: a
session slows every later launch of the process on the host by 3-8 µs a
launch (H100, PERF.md §6, PR 9).

Cost: GPU-seconds (the run's seconds times the number of ranks) times an
hourly price per GPU. The report keeps JAX's keys so its readers work
unchanged: `chip_seconds` means GPU-seconds here and
`price_per_chip_hour_usd` the price per GPU-hour.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from dorylus_tpu_torch.models.base import GraphBatch
from dorylus_tpu_torch.ops.spmm import aggregate, spmm_edgewise

# An assumed on-demand price per GPU-hour, used only for the report's cost
# estimate: set your own through report_cost(price_per_gpu_hour=...).
DEFAULT_GPU_USD_PER_HOUR = 3.00


def _read(out) -> None:
    """A synchronising read of a bracket's result (a tensor, or a tuple of
    them)."""
    t = out[0] if isinstance(out, (tuple, list)) else out
    float(t.reshape(-1)[0])


def time_ms(fn: Callable, iters: int, device: torch.device) -> float:
    """ms per call of fn(): one untimed call, then `iters` calls between
    CUDA events on the card, or the host clock around them on the CPU."""
    _read(fn())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
        end.synchronize()
        _read(out)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _read(out)
    return 1e3 * (time.perf_counter() - t0) / iters


def _cols(x: torch.Tensor, f: int) -> torch.Tensor:
    """x's first f columns, zero-padded to f (JAX's stand-in input)."""
    if x.shape[1] >= f:
        return x[:, :f].contiguous()
    return torch.nn.functional.pad(x, (0, f - x.shape[1]))


def _is_gat(model) -> bool:
    return type(model).__name__ == "GAT"


def model_aggregate(model, batch: GraphBatch) -> Callable[[torch.Tensor], torch.Tensor]:
    """The aggregation a single-device model runs, as a function of the
    table h: the entry and values the model uses (JAX `_model_agg`), with
    h[:, 0] standing in for GAT's attention column."""
    op = model.spmm_op
    if op is None:
        return lambda h: aggregate(h, batch.src, batch.dst, batch.edge_val, batch.self_val,
                                   op=model.edge_op)
    if _is_gat(model):
        return lambda h: op.apply_dst(h, h[:, 0])
    if op.has_static_vals:
        return op.apply_static
    return lambda h: op.apply(h, batch.edge_val.to(h.dtype))


def agg_brackets(model, batch: GraphBatch) -> list:
    """Per layer: (width, forward, backward), each bracket a function of no
    argument that runs the layer's aggregation (the backward: autograd of
    the sum of squares of its output) on the batch's first `width` feature
    columns."""
    agg = model_aggregate(model, batch)
    out = []
    for l in range(model.layers.num_layers):
        f = model.agg_width(l)
        hh = _cols(batch.x, f)
        hg = hh.clone().requires_grad_(True)

        def bwd(hg=hg):
            o = agg(hg)
            return torch.autograd.grad((o.float() * o.float()).sum(), hg)[0]

        out.append((f, lambda hh=hh: agg(hh), bwd))
    return out


def profile_stages(model, params: Dict[str, torch.Tensor], batch: GraphBatch,
                   iters: int = 5) -> Dict[str, float]:
    """Stage times in ms (JAX `profile_stages`): aggregate_l*_ms and
    aggregate_l*_bwd_ms, dense_l*_ms, forward_ms, loss_and_grad_ms. The
    forward and the loss run on `params` (the model's own, or any tensors
    of the same names) in f32, as JAX's brackets do."""
    device = batch.x.device
    out: Dict[str, float] = {}
    gat = _is_gat(model)
    last = model.layers.num_layers - 1
    for l, (f, fwd, bwd) in enumerate(agg_brackets(model, batch)):
        w = params[f"w{l}"].detach()
        hin = _cols(batch.x, w.shape[0])

        def dense(hin=hin, w=w, act=not gat and l < last):
            z = torch.matmul(hin, w)
            return torch.tanh(z) if act else z

        with torch.no_grad():
            out[f"aggregate_l{l}_ms"] = time_ms(fwd, iters, device)
        out[f"aggregate_l{l}_bwd_ms"] = time_ms(bwd, iters, device)
        out[f"dense_l{l}_ms"] = time_ms(dense, iters, device)
    names = list(params)

    def forward():
        with torch.no_grad():
            return torch.func.functional_call(model, params, (batch,))

    def loss_and_grad():
        return torch.autograd.grad(model.loss(batch, params=params),
                                   [params[k] for k in names])

    out["forward_ms"] = time_ms(forward, iters, device)
    out["loss_and_grad_ms"] = time_ms(loss_and_grad, iters, device)
    return out


def _sharded_aggregate(eng) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The aggregation a rank's model runs on the engine's plan (the fused
    op, the (interior, boundary) pair, the edgewise split, or the combined
    op or edge op), as a function of (local rows h, ghost rows)."""
    model, batch, vp = eng.model, eng.batch, eng.meta.vp
    gat = _is_gat(model)
    split, op = model.spmm_split, model.spmm_op
    if getattr(split, "fused", False):
        if gat:
            return lambda h, gh: split.apply_dst_fused(h, gh, h[:, 0])
        return split.apply_static_fused
    if split is not None:
        op_i, op_b = split
        if gat:
            return lambda h, gh: op_i.apply_dst(h, h[:, 0]) + op_b.apply_dst(gh, h[:, 0])
        return lambda h, gh: op_i.apply_static(h) + op_b.apply_static(gh)
    if model.edge_split is not None:
        eop_i, eop_b = model.edge_split
        return lambda h, gh: (
            spmm_edgewise(h, batch.src_int, batch.dst_int, batch.val_int, vp, op=eop_i)
            + spmm_edgewise(gh, batch.src_bnd, batch.dst_bnd, batch.val_bnd, vp, op=eop_b))
    if op is None:
        return lambda h, gh: spmm_edgewise(torch.cat([h, gh]), batch.src, batch.dst,
                                           batch.edge_val, vp, op=model.edge_op)
    if gat:
        return lambda h, gh: op.apply_dst(torch.cat([h, gh]), h[:, 0])
    if op.has_static_vals:
        return lambda h, gh: op.apply_static(torch.cat([h, gh]))
    return lambda h, gh: op.apply(torch.cat([h, gh]), batch.edge_val.to(h.dtype))


def profile_stages_sharded(eng, iters: int = 5) -> Dict[str, float]:
    """Stage times in ms of a ShardedEngine (JAX `profile_stages_sharded`):
    halo_l*_ms (with more than one graph shard), aggregate_l*_ms,
    forward_ms and loss_and_grad_ms, each at the width the rank's model
    aggregates layer l at (the F/m slice under tensor parallelism), on the
    plan the engine trains on. The aggregate bracket gathers a stand-in
    ghost table of the real one's shape from the local rows (JAX: h[send_idx
    % vp]), so it holds no collective and the halo line isolates the
    exchange.

    Every rank must call it at the same point: the halo, forward and loss
    brackets enter collectives. Each value is the maximum over the world's
    ranks, so every rank returns the same dict."""
    from dorylus_tpu_torch.parallel import multihost
    from dorylus_tpu_torch.parallel.halo import halo_recv

    model, batch, device = eng.model, eng.batch, eng.device
    vp = eng.meta.vp
    send = torch.as_tensor(np.asarray(eng.shard.send_idx, np.int64).reshape(-1) % vp,
                           device=device)
    agg = _sharded_aggregate(eng)
    out: Dict[str, float] = {}
    for l in range(model.layers.num_layers):
        h = _cols(batch.x, model.agg_width(l))
        with torch.no_grad():
            if eng.n > 1:
                out[f"halo_l{l}_ms"] = time_ms(lambda h=h: halo_recv(h, eng.halo_plan),
                                               iters, device)
            ghosts = h.index_select(0, send)
            out[f"aggregate_l{l}_ms"] = time_ms(lambda h=h, g=ghosts: agg(h, g), iters,
                                                device)
    params = eng.params
    names = list(params)

    def forward():
        with torch.no_grad():
            return model.forward(batch, halo=eng.halo)

    def loss_and_grad():
        return torch.autograd.grad(model.loss(batch, halo=eng.halo),
                                   [params[k] for k in names])

    out["forward_ms"] = time_ms(forward, iters, device)
    out["loss_and_grad_ms"] = time_ms(loss_and_grad, iters, device)
    keys = list(out)
    vals = torch.tensor([out[k] for k in keys], dtype=torch.float64, device=device)
    worst = multihost.all_gather_rows(vals).amax(dim=0).tolist()
    return dict(zip(keys, worst))


def stage_times(times: Dict[str, float], iters: int) -> Dict[str, Dict[str, float]]:
    """`RunReport.stage_times` in JAX's shape."""
    return {k: {"total_s": v / 1e3 * iters, "count": iters, "avg_ms": v}
            for k, v in times.items()}


def report_cost(total_time_s: float, n_gpus: int = 1,
                price_per_gpu_hour: float = DEFAULT_GPU_USD_PER_HOUR) -> dict:
    """GPU-seconds and a dollar estimate (calculate-price.py analog), under
    JAX's keys: `chip_seconds` is GPU-seconds, `price_per_chip_hour_usd`
    the price per GPU-hour."""
    gpu_s = total_time_s * n_gpus
    return {
        "chip_seconds": round(gpu_s, 2),
        "price_per_chip_hour_usd": price_per_gpu_hour,
        "estimated_cost_usd": round(gpu_s / 3600.0 * price_per_gpu_hour, 6),
    }


def report_memory(device: str | torch.device | None = None) -> dict | None:
    """The card's memory use (JAX `report_memory`): bytes_in_use and
    peak_bytes_in_use from PyTorch's allocator (`torch.cuda.memory_stats`:
    what this process's tensors hold now and at most since it started or
    the peak was reset), bytes_limit the card's memory
    (`torch.cuda.mem_get_info`). JAX's `largest_alloc_size` has no
    counterpart and is left out. None on the CPU, as JAX returns nothing
    there; device None means the current card when one is visible."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    st = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}
