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
  eval = the forward's logits on the validation rows, after each step, and
       their val stats: the rows whose first argmax is the label, the loss
       sum, -log softmax[label] clamped at 1e-30, and the rows.

`adam_step` is one step from a given state (parameters and moments) as a
given step t; `train` chains it from the seed's weights (the reference's
own trajectory), `follow` takes it from each state a run started a step
from (the one-step check).
"""

from __future__ import annotations

import contextlib
import copy
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


class Problem:
    """The inputs on the device as a step reads them: the graph, the
    features, the labels, the training rows (each weighted 1 / denom,
    denom = V * 0.66) and the validation rows."""

    def __init__(self, model: str, src: np.ndarray, dst: np.ndarray, features: np.ndarray,
                 labels: np.ndarray, split_ids: np.ndarray, *, gather_dtype,
                 device: torch.device):
        v = features.shape[0]
        self.model, self.gather_dtype, self.device = model, gather_dtype, device
        self.graph = RefGraph(src, dst, v, device)
        self.x = torch.as_tensor(features, device=device).float()
        self.y = torch.as_tensor(labels, device=device).long()
        tr, va = split_masks(split_ids, v)
        self.train_rows = torch.as_tensor(tr, device=device).float()
        self.val_rows = torch.as_tensor(va, device=device)
        self.denom = float(np.float32(v * TRAIN_PORTION))

    def with_train_rows(self, train_mask: np.ndarray, denom: float) -> "Problem":
        """The same inputs with other training rows and denominator (a fault
        planted for calibration)."""
        other = copy.copy(self)
        other.train_rows = torch.as_tensor(train_mask, device=self.device).float()
        other.denom = denom
        return other

    def loss_and_grads(self, params: dict) -> tuple[float, dict]:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        out = logits(self.model, leaves, self.x, self.graph, self.gather_dtype)
        loss = (row_nll(out, self.y) * self.train_rows).sum() / self.denom
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), {k: g.detach() for k, g in zip(leaves, grads)}

    def evaluate(self, params: dict) -> torch.Tensor:
        """The eval forward's logits on the validation rows, on the CPU."""
        with torch.no_grad():
            p = {k: t.to(self.device) for k, t in params.items()}
            return logits(self.model, p, self.x, self.graph, self.gather_dtype)[self.val_rows].cpu()

    def val_stats(self, val_logits: torch.Tensor) -> torch.Tensor:
        """(correct, loss sum, rows) of the validation rows' logits, in
        float64, as the program's val stats are laid out: correct counts the
        rows whose first largest logit is the label's."""
        z = val_logits.double()
        y = self.y[self.val_rows].cpu()
        first = torch.where(z == z.amax(-1, keepdim=True), torch.arange(z.shape[1]),
                            z.shape[1]).amin(-1)
        p_true = torch.softmax(z, dim=-1).gather(1, y[:, None])[:, 0]
        return torch.stack([(first == y).sum().double(),
                            -torch.log(p_true.clamp_min(1e-30)).sum(),
                            torch.tensor(float(y.shape[0]), dtype=torch.float64)])


def adam_step(problem: Problem, state: dict, t: int, *, lr: float, beta1: float,
              beta2: float, eps: float, rate_step: int | None = None) -> dict:
    """One full-graph Adam step as step t, from `state` ({"params", "m",
    "v"}: leaf -> tensor, on any device; left as it is). Returns {"loss":
    the loss on the given parameters, "grad": the gradient, "state": the
    new parameters and moments, on the device}. rate_step: the step whose
    bias-corrected rate the update takes (t; another is a fault planted for
    calibration)."""
    params, m, v = ({k: x.to(problem.device).float().clone() for k, x in state[part].items()}
                    for part in ("params", "m", "v"))
    loss, grads = problem.loss_and_grads(params)
    r = t if rate_step is None else rate_step
    lr_t = lr * math.sqrt(1.0 - beta2 ** r) / (1.0 - beta1 ** r)
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m[k].mul_(beta1).add_(g, alpha=1.0 - beta1)
            v[k].mul_(beta2).add_(g * g, alpha=1.0 - beta2)
            p.sub_(lr_t * m[k] / (v[k].sqrt() + eps))
    return {"loss": loss, "grad": grads, "state": {"params": params, "m": m, "v": v}}


def on_cpu(state: dict) -> dict:
    return {part: {k: x.detach().to("cpu", copy=True) for k, x in leaves.items()}
            for part, leaves in state.items()}


def train(problem: Problem, weights: dict, *, steps: int, lr: float, beta1: float,
          beta2: float, eps: float, tf32: bool = False, stale_rate: bool = False,
          keep_moments: bool = False) -> dict:
    """`steps` full-graph Adam steps from `weights` (`adam_step` from each
    step's end, the first from the weights and zero moments), each followed
    by the eval forward. Returns {"losses": [step loss], "grad1": {leaf: the
    first step's gradient}, "evals": [the eval forward's logits on the
    validation rows after each step], "eval0": the same before the first,
    "states": [the state each step starts from, then the last's end]},
    tensors on the CPU. Faults planted for calibration: stale_rate, every
    step at step 1's rate; keep_moments, the moments each step after the
    first computes not kept (the next starts from the old ones)."""
    params = {k: w.float() for k, w in weights.items()}
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    state = {"params": params, "m": zeros, "v": zeros}
    out = {"losses": [], "evals": [], "states": [on_cpu(state)]}
    with matmul_precision(tf32):
        out["eval0"] = problem.evaluate(state["params"])
        for t in range(1, steps + 1):
            r = adam_step(problem, state, t, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                          rate_step=1 if stale_rate else t)
            if keep_moments and t > 1:
                r["state"].update(m=state["m"], v=state["v"])
            state = r["state"]
            out["losses"].append(r["loss"])
            if t == 1:
                out["grad1"] = {k: g.cpu() for k, g in r["grad"].items()}
            out["states"].append(on_cpu(state))
            out["evals"].append(problem.evaluate(state["params"]))
    return out


def follow(problem: Problem, states: list, *, lr: float, beta1: float, beta2: float,
           eps: float) -> dict:
    """The reference's step t from each state a run started step t from
    (states[t - 1]; states[t] holds the run's state after it), as the run's
    own count says, in float32: {"losses": [the loss on the run's
    parameters], "grad1": the first step's gradient, "after": [the state
    the step leaves: parameters and moments], "evals": [the eval forward's
    logits on the validation rows of the run's parameters after the step],
    "val_stats": [their `Problem.val_stats`]}, on the CPU."""
    out = {"losses": [], "after": [], "evals": [], "val_stats": []}
    with matmul_precision(False):
        for t in range(1, len(states)):
            r = adam_step(problem, states[t - 1], t, lr=lr, beta1=beta1, beta2=beta2, eps=eps)
            out["losses"].append(r["loss"])
            if t == 1:
                out["grad1"] = {k: g.cpu() for k, g in r["grad"].items()}
            out["after"].append(on_cpu(r["state"]))
            out["evals"].append(problem.evaluate(states[t]["params"]))
            out["val_stats"].append(problem.val_stats(out["evals"][-1]))
    return out
