"""Plain PyTorch reference of Dorylus's full-graph GCN and GAT training
steps: the normalisation, the aggregation forward and backward, the dense
layers, the activations, the softmax cross-entropy, Adam, and the eval
forward. Float32 throughout with TF32 off; the one rounding the
configuration states, a bfloat16 gather, is applied where it says: each
table an aggregation gathers (forward: the layer's input; backward: the
output's gradient) and GCN's edge values are rounded to bfloat16, each
edge's product of the two is rounded once to bfloat16 (the exact product of
two bfloat16 numbers, rounded), and the sums are float32.

It works everything out from the benchmark's inputs (edge lists, features,
labels, the split's ids, the initial weights) and imports nothing of the
program. The aggregation runs in blocks of edges (`index_select`, multiply,
`index_add_`), so that a graph of 10^8 edges fits.

Semantics (the Dorylus reference, src/graph-server and funcs/):
  GCN  S = D~^-1/2 (A + I) D~^-1/2 with D~ = in-degree + 1; per layer
       z = S (h W) when the layer shrinks (fin > fout), else (S h) W;
       h = tanh(z) on hidden layers, logits on the last.
  GAT  z = h W; e_v = LeakyReLU_0.01(<z_v, a>) of the destination;
       h_v = z_v + e_v * sum_{u->v} z_u; no hidden activation.
  loss = sum over train rows of -log softmax(logits)[label] / (V * 0.66).
  Adam lr_t = lr sqrt(1 - b2^t) / (1 - b1^t); m, v; w -= lr_t m / (sqrt(v) + eps).
  eval = the forward's logits on the validation rows, after each step.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

TRAIN_PORTION = 0.66
VAL_PORTION = 0.10
# Bytes of gathered rows one block of an aggregation holds.
BLOCK_BYTES = 1 << 30


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matmuls in full float32 (tf32=False) or in TF32 (the
    control), restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class RefGraph:
    """The edge lists on the device and the GCN normalisation."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, num_vertices: int,
                 device: torch.device):
        self.v = num_vertices
        self.src = torch.as_tensor(src, device=device).long()
        self.dst = torch.as_tensor(dst, device=device).long()
        deg = torch.bincount(self.dst, minlength=num_vertices).double() + 1.0
        inv_sqrt = deg.rsqrt()
        self.edge_norm = (inv_sqrt[self.src] * inv_sqrt[self.dst]).float()
        self.self_norm = (1.0 / deg).float()


def spmm(table: torch.Tensor, rows_in: torch.Tensor, rows_out: torch.Tensor,
         vals: torch.Tensor | None, n_out: int, dtype=None) -> torch.Tensor:
    """out[rows_out[e]] += vals[e] * table[rows_in[e]] in blocks, summed in
    float32. dtype (bfloat16): the table and the values rounded to it, and
    each product computed in it."""
    f = table.shape[1]
    out = torch.zeros((n_out, f), dtype=torch.float32, device=table.device)
    tb = table if dtype is None else table.to(dtype)
    vv = None if vals is None or dtype is None else vals.to(dtype)
    step = max(1, BLOCK_BYTES // (4 * f))
    for i in range(0, rows_in.shape[0], step):
        msg = tb.index_select(0, rows_in[i:i + step])
        if vals is not None:
            msg = msg * (vals if vv is None else vv)[i:i + step, None]
        out.index_add_(0, rows_out[i:i + step], msg.float())
    return out


class Aggregate(torch.autograd.Function):
    """sum over in-edges u -> v of val * h[u] (val 1 without values), at
    the gather's precision both ways: h in the forward, the output's
    gradient over the reversed edges in the backward."""

    @staticmethod
    def forward(ctx, h, graph: RefGraph, vals, dtype):
        ctx.graph, ctx.vals, ctx.dtype = graph, vals, dtype
        return spmm(h, graph.src, graph.dst, vals, graph.v, dtype)

    @staticmethod
    def backward(ctx, gout):
        g = ctx.graph
        return spmm(gout, g.dst, g.src, ctx.vals, g.v, ctx.dtype), None, None, None


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.01 * x)


def logits(model: str, params: dict, x: torch.Tensor, graph: RefGraph,
           gather_dtype) -> torch.Tensor:
    """The forward pass: (V, C) logits."""
    layers = sum(1 for k in params if k.startswith("w"))
    vals = None if model == "gat" else graph.edge_norm
    h = x
    for l in range(layers):
        w = params[f"w{l}"]
        if model == "gat":
            z = h @ w
            att = leaky_relu((z @ params[f"a{l}"])[:, 0])
            h = z + att[:, None] * Aggregate.apply(z, graph, None, gather_dtype)
            continue
        if w.shape[0] > w.shape[1]:
            hw = h @ w
            z = Aggregate.apply(hw, graph, vals, gather_dtype) + graph.self_norm[:, None] * hw
        else:
            z = (Aggregate.apply(h, graph, vals, gather_dtype) + graph.self_norm[:, None] * h) @ w
        h = torch.tanh(z) if l < layers - 1 else z
    return h


def row_nll(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(V,) -log softmax(out)[label]."""
    return -torch.log_softmax(out, dim=-1).gather(1, labels[:, None])[:, 0]


def split_masks(split_ids: np.ndarray, v: int) -> tuple[np.ndarray, np.ndarray]:
    """(train, val) boolean masks by original vertex id (Dorylus's split:
    the first 66% of ids train, the next 10% validate)."""
    train_end = int(v * TRAIN_PORTION)
    val_end = train_end + int(v * VAL_PORTION)
    return split_ids < train_end, (split_ids >= train_end) & (split_ids < val_end)


def train(model: str, src: np.ndarray, dst: np.ndarray, features: np.ndarray,
          labels: np.ndarray, split_ids: np.ndarray, weights: dict, *, steps: int,
          lr: float, beta1: float, beta2: float, eps: float, gather_dtype,
          device: torch.device, tf32: bool = False,
          train_mask: np.ndarray | None = None, denom: float | None = None) -> dict:
    """`steps` full-graph Adam steps from `weights`, each followed by the
    eval forward. Returns {"losses": [step loss], "grad1": {leaf: the
    first step's gradient}, "deltas": [{leaf: params after each step
    minus before the first}], "evals": [the eval forward's logits on the
    validation rows after each step], "eval0": the same before the first},
    tensors on the CPU. train_mask / denom replace the split's train rows
    and V * 0.66 (a fault planted for calibration)."""
    v = features.shape[0]
    graph = RefGraph(src, dst, v, device)
    x = torch.as_tensor(features, device=device).float()
    y = torch.as_tensor(labels, device=device).long()
    tr, va = split_masks(split_ids, v)
    if train_mask is not None:
        tr = train_mask
    tr = torch.as_tensor(tr, device=device).float()
    va = torch.as_tensor(va, device=device)
    den = float(np.float32(v * TRAIN_PORTION)) if denom is None else denom
    params = {k: w.to(device).float().clone().requires_grad_(True) for k, w in weights.items()}
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    s = {k: torch.zeros_like(p) for k, p in params.items()}
    out = {"losses": [], "deltas": [], "evals": []}

    def evaluate() -> torch.Tensor:
        with torch.no_grad():
            return logits(model, params, x, graph, gather_dtype)[va].cpu()

    with matmul_precision(tf32):
        out["eval0"] = evaluate()
        for t in range(1, steps + 1):
            loss = (row_nll(logits(model, params, x, graph, gather_dtype), y) * tr).sum() / den
            grads = torch.autograd.grad(loss, list(params.values()))
            out["losses"].append(float(loss.detach()))
            if t == 1:
                out["grad1"] = {k: g.detach().cpu() for k, g in zip(params, grads)}
            lr_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(beta1).add_(g, alpha=1.0 - beta1)
                    s[k].mul_(beta2).add_(g * g, alpha=1.0 - beta2)
                    p.sub_(lr_t * m[k] / (s[k].sqrt() + eps))
            out["deltas"].append({k: (p.detach() - start[k]).cpu() for k, p in params.items()})
            out["evals"].append(evaluate())
    return out
