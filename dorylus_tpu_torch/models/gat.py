"""GAT with Dorylus's (non-textbook) attention semantics (port of
dorylus_tpu/models/gat.py, the single-device, non-TP path).

Per layer l (no hidden activation, no per-neighbour softmax):
    Z    = H · W_l                    (f32 products)
    za_v = <z_v, a_l>                 (attention logit of the DESTINATION)
    AH_v = z_v + sum_{u->v} LeakyReLU(za_v) · z_u   (slope .01, self weight 1)
    H    = AH                         (hidden layers back in compute_dtype;
                                       the last layer keeps f32 logits)
Output: softmax(AH_last) row-wise; gradients from autograd, as JAX takes
them from jax.grad. The unused second attention vector of the reference
is not kept (as in JAX).

Aggregation:
  * kernel="hyb" / "degree" / reuse="pairs": the attention is a function
    of the destination only, so it factors out of each row's sum:
    `apply_dst(z, leaky(za))` on the op (HybSpMM, DegreeSpMM, ReuseSpMM)
    runs the unit-weight pass and scales rows; no per-edge value exists.
  * edgewise (kernel="xla"): att_e = leaky(take_sorted(za, dst)) · mask_e
    with the batch's {0,1} edge mask, then the CSR SpMM with per-edge
    values (its backward gives d(att) through the SDDMM kernel); past 400k
    vertices JAX's dst-blocked form of the same sum, routed to the same op.

Not ported: the `past_agg_cliff` regime branch (`models/gat.py:245-264`,
aggregate h at its input width and transform after). It models a TPU
gather cliff (ROADMAP.md "Not to port") and fires in JAX only with a bf16
gather table of V·F·2 B >= 64 MB (V >= ~819k at F = 41): neither at the
Reddit config nor at test sizes, so both packages take the same branch
there.
"""

from __future__ import annotations

import torch

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu_torch._shared import load
from dorylus_tpu_torch.models.base import GNN, GraphBatch, Params
from dorylus_tpu_torch.ops.activations import leaky_relu
from dorylus_tpu_torch.ops.spmm import (EdgeSpMM, spmm_dst_blocked,
                                        spmm_edgewise, take_sorted)


class GAT(GNN):
    """Parameters `w{l}` (in, out) and `a{l}` (out, 1), in the JAX names,
    layout and order (w0, a0, w1, a1, ...).

    spmm_op: an aggregation op with `apply_dst` (HybSpMM, DegreeSpMM or
    ReuseSpMM), or None for the edgewise path, which needs `edge_op`.
    blk_rows > 0 takes JAX's dst-blocked branch (same sum, same op)."""

    def __init__(self, layers: LayerConfig, spmm_op=None,
                 edge_op: EdgeSpMM | None = None, blk_rows: int = 0):
        super().__init__()
        if spmm_op is None and edge_op is None:
            raise ValueError("GAT needs an aggregation op (spmm_op) or an "
                             "EdgeSpMM (edge_op)")
        self.layers = layers
        self.spmm_op = spmm_op
        self.edge_op = edge_op
        self.blk_rows = blk_rows
        device = (spmm_op or edge_op).device
        dims = layers.dims
        for l in range(layers.num_layers):
            self._add_param(f"w{l}", (dims[l], dims[l + 1]), device)
            self._add_param(f"a{l}", (dims[l + 1], 1), device)

    def init_params(self, seed: int = 8888, exact_reference: bool = True) -> Params:
        """w: xavier; a: kaiming — initWeightsMasterGAT
        (weightserver.cpp:535-559), through the JAX package's initializer
        (models/init.py, shared)."""
        winit = load("models/init.py")
        dims = self.layers.dims
        with torch.no_grad():
            for l in range(self.layers.num_layers):
                w = winit.xavier(dims[l], dims[l + 1], seed=seed,
                                 exact=exact_reference or None)
                getattr(self, f"w{l}").copy_(torch.from_numpy(w))
                a = winit.kaiming_reference(dims[l + 1], 1, seed=seed)
                getattr(self, f"a{l}").copy_(torch.from_numpy(a))
        return self.params()

    def _aggregate(self, z: torch.Tensor, za: torch.Tensor, batch: GraphBatch,
                   edge_mask: torch.Tensor) -> torch.Tensor:
        if self.spmm_op is not None:
            return self.spmm_op.apply_dst(z, leaky_relu(za)).to(z.dtype)
        op, v = self.edge_op, z.shape[0]
        att = leaky_relu(take_sorted(za, batch.dst, v, op=op)) * edge_mask
        if self.blk_rows:
            return spmm_dst_blocked(z, batch.src, batch.dst, att, v,
                                    self.blk_rows, op=op)
        return spmm_edgewise(z, batch.src, batch.dst, att, v, op=op)

    def forward(self, batch: GraphBatch,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Logits (V, C)."""
        num_layers = self.layers.num_layers
        h = batch.x.to(compute_dtype)
        # The batch's edge values are GAT's {0,1} edge mask.
        edge_mask = batch.edge_val.to(compute_dtype)
        for l in range(num_layers):
            w = getattr(self, f"w{l}").to(compute_dtype)
            a = getattr(self, f"a{l}").to(compute_dtype)
            # f32 products on compute_dtype-rounded operands (JAX's dot
            # with preferred_element_type=float32); z stays f32.
            z = torch.matmul(h.float(), w.float())
            za = torch.matmul(z, a.float())[:, 0]
            h = z + self._aggregate(z, za, batch, edge_mask)
            if l < num_layers - 1:
                h = h.to(compute_dtype)
        return h
