"""GCN with Dorylus-exact semantics (port of dorylus_tpu/models/gcn.py,
the single-device path).

Forward per layer (reference: funcs/gcn/main.cpp forwardLayer :215-270):
    AH = S · H      (aggregation + self-loop term)
    Z  = AH · W     (f32 matmul)
    H  = tanh(Z)    (hidden layers; the last layer feeds softmax CE)
with (S·H)·W == S·(H·W) used to aggregate at the narrower width: a layer
that shrinks the feature dim transforms first.

Aggregation runs on a slot-pass op with the aggregation protocol
(`HybSpMM` for kernel="hyb", `DegreeSpMM` for kernel="degree", `ReuseSpMM`
for reuse="pairs"): `apply_static` when the op has static values (the GCN
norms baked in, or ReuseSpMM's rank-1 factor), else `apply(h, edge_val)`
with the batch's per-edge values (JAX's branch for an op without static
values, `models/gcn.py:214-216`; a dynamic HybSpMM or a DegreeSpMM built
without them). With no such op bound it runs on the edgewise CSR op over
the batch's COO arrays (JAX: the `aggregate` fallback, kernel="xla"); past
400k vertices JAX's dst-blocked form of the same sum, which the port
routes to the same op.

The JAX model's regime rule `past_agg_cliff` (aggregate at the input width
past a TPU gather-table size cliff) is not ported: it models a TPU effect.
At the Reddit config it does not fire in JAX either, so both packages
order the layers the same way there. Tensor parallelism and the sharded
halo paths are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu_torch._shared import load
from dorylus_tpu_torch.models.base import GNN, GraphBatch, Params
from dorylus_tpu_torch.ops.spmm import EdgeSpMM, aggregate, spmm_dst_blocked


class GCN(GNN):
    """Weights are parameters `w0`, `w1`, ... in the JAX (in, out) layout.

    spmm_op: the graph's aggregation op (HybSpMM, DegreeSpMM or
    ReuseSpMM), or None for the edgewise path, which needs `edge_op` (the
    CSR structure of the batch's edges). blk_rows > 0 takes JAX's
    dst-blocked branch (same sum, same op)."""

    def __init__(self, layers: LayerConfig, spmm_op=None,
                 optimize_order: bool = True, edge_op: EdgeSpMM | None = None,
                 blk_rows: int = 0):
        super().__init__()
        if spmm_op is None and edge_op is None:
            raise ValueError("GCN needs an aggregation op (spmm_op) or an "
                             "EdgeSpMM (edge_op)")
        self.layers = layers
        self.spmm_op = spmm_op
        self.edge_op = edge_op
        self.optimize_order = optimize_order
        self.blk_rows = blk_rows
        device = (spmm_op or edge_op).device
        dims = layers.dims
        for l in range(layers.num_layers):
            self._add_param(f"w{l}", (dims[l], dims[l + 1]), device)

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
        if self.spmm_op is None:
            if self.blk_rows:
                out = spmm_dst_blocked(h, batch.src, batch.dst, batch.edge_val,
                                       h.shape[0], self.blk_rows, op=self.edge_op)
                return out + h * batch.self_val[:, None].to(h.dtype)
            return aggregate(h, batch.src, batch.dst, batch.edge_val,
                             batch.self_val, op=self.edge_op)
        if self.spmm_op.has_static_vals:
            out = self.spmm_op.apply_static(h)
        else:
            out = self.spmm_op.apply(h, batch.edge_val.to(h.dtype))
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
