"""GCN with Dorylus-exact semantics (port of dorylus_tpu/models/gcn.py,
the single-device path).

Forward per layer (reference: funcs/gcn/main.cpp forwardLayer :215-270):
    AH = S · H      (aggregation: HybSpMM static pass + self-loop term)
    Z  = AH · W     (f32 matmul)
    H  = tanh(Z)    (hidden layers; the last layer feeds softmax CE)
with (S·H)·W == S·(H·W) used to aggregate at the narrower width: a layer
that shrinks the feature dim transforms first.

The JAX model's regime rule `past_agg_cliff` (aggregate at the input width
past a TPU gather-table size cliff) is not ported: it models a TPU effect.
At the Reddit config it does not fire in JAX either, so both packages
order the layers the same way there. Tensor parallelism, the sharded
halo paths and the edgewise fallback are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu_torch._shared import load
from dorylus_tpu_torch.models.base import GraphBatch, Params
from dorylus_tpu_torch.ops.activations import masked_softmax_xent, row_softmax
from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM


class GCN(nn.Module):
    """Weights are parameters `w0`, `w1`, ... in the JAX (in, out) layout,
    so `load_state_dict(interop.params_from_numpy(jax_params, device))`
    carries the JAX package's weights over unchanged.

    spmm_op: the graph's static-value HybSpMM (the edgewise path, used by
    JAX when no op is bound, is ROADMAP.md queue 1 item 2)."""

    def __init__(self, layers: LayerConfig, spmm_op: HybSpMM,
                 optimize_order: bool = True):
        super().__init__()
        self.layers = layers
        self.spmm_op = spmm_op
        self.optimize_order = optimize_order
        dims = layers.dims
        for l in range(layers.num_layers):
            self.register_parameter(
                f"w{l}", nn.Parameter(torch.zeros(dims[l], dims[l + 1],
                                                  device=spmm_op.device)))

    def params(self) -> Params:
        return {f"w{l}": getattr(self, f"w{l}")
                for l in range(self.layers.num_layers)}

    def init_params(self, seed: int = 8888, exact_reference: bool = True) -> Params:
        """Per-layer xavier weights from a fresh minstd engine each, as
        WeightServer::initWeightsMasterGCN (the JAX package's initializer,
        models/init.py, shared)."""
        winit = load("models/init.py")
        dims = self.layers.dims
        with torch.no_grad():
            for l, p in enumerate(self.params().values()):
                w = winit.xavier(dims[l], dims[l + 1], seed=seed,
                                 exact=exact_reference or None)
                p.copy_(torch.from_numpy(w))
        return self.params()

    def _aggregate(self, h: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        out = self.spmm_op.apply_static(h)
        return out.to(h.dtype) + h * batch.self_val[:, None].to(h.dtype)

    def forward(self, batch: GraphBatch,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Logits (V, C)."""
        num_layers = self.layers.num_layers
        h = batch.x.to(compute_dtype)
        for l, w in enumerate(self.params().values()):
            w = w.to(compute_dtype)
            # Products in f32 on compute_dtype-rounded operands: JAX's dot
            # with preferred_element_type=float32.
            if self.optimize_order and w.shape[0] > w.shape[1]:
                z = self._aggregate(torch.matmul(h.float(), w.float()), batch)
            else:
                z = torch.matmul(self._aggregate(h, batch).float(), w.float())
            # Hidden activations return to compute_dtype; z is f32.
            h = torch.tanh(z).to(compute_dtype) if l < num_layers - 1 else z
        return h

    def loss(self, batch: GraphBatch,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        logits = self.forward(batch, compute_dtype)
        return masked_softmax_xent(logits, batch.onehot, batch.train_mask,
                                   batch.denom)

    def predict(self, batch: GraphBatch) -> torch.Tensor:
        return row_softmax(self.forward(batch))
