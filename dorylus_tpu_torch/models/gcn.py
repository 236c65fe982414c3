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
order the layers the same way there; under a halo JAX's rule is off
(`halo is None` guards it), so the plain rule is JAX's own.

Sharded (`halo` given, parallel/halo.py `make_halo_fn`): with a combined
op (`spmm_op` a ShardedHybSpMM, or the edgewise op over the shard's edges)
`halo(x)` returns the feature table (local rows, then ghosts) and the
aggregation gathers from it (JAX `_agg_halo`). The three overlap paths
(JAX `_aggregate_split`) take the ghost rows alone and split the work
around the exchange, in one order: start the exchange of x
(`halo.start`), issue the work that reads x alone, finish the exchange
(`halo.finish`), issue the rest. So the interior work runs while the rows
are in flight, as XLA schedules JAX's (`dorylus_tpu/models/gcn.py:149-152`).
The backward mirrors it: the aggregation reads x through the join
`halo.start` returns, so the reverse exchange starts once the boundary
op's gradient gives the ghost rows' cotangent and finishes only after the
interior op's backward; the self term reads x itself and is made after
the join, so autograd (the ready node made last runs first) runs it in
between too, and x's gradient adds it after the join's sum: on the fused
plan and the degree pair the order of the exchange run whole, bit for bit.
The work that reads x alone: with the fused-overlap op (`spmm_split`,
ShardedHybSpMM edges="fused") K8's pure range (`pure_range`, the buckets
whose in-edges are all local), then `apply_static_fused(x, ghosts, pure)`
adds the mixed range (JAX's fused branch); with the (interior, boundary)
op pair (`spmm_split` a 2-tuple, the degree kernel's overlap plan) the
interior op over x, then the boundary op over the ghosts; with the
edgewise split (`edge_split`, two EdgeSpMM over the batch's `src_int ...
val_bnd`) the interior `aggregate`, then the boundary SpMM.

Tensor parallelism (`tp`, a FeatAxis of m > 1; JAX `_forward_tp`): each
rank of a feat group aggregates an F/m column slice of the table, the halo
exchanging those columns over the graph group, and the layer matmul's
partial products are summed over the feat group (`_psum_feat`), so z and
the loss are the same on every feat rank. The weight gradients are summed
over the world by the engine, which assembles each rank's W row block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dorylus_tpu_torch.common.config import LayerConfig
from dorylus_tpu_torch.models import init as winit
from dorylus_tpu_torch.models.base import (GNN, FeatAxis, GraphBatch, HaloFn, Params,
                                           check_divisible, check_edge_split, check_split,
                                           finish_halo, split_of, start_halo)
from dorylus_tpu_torch.ops.spmm import (EdgeSpMM, aggregate, spmm_dst_blocked,
                                        spmm_edgewise)


# The tensor-parallel autograd idioms (JAX models/gcn.py:56-106). A sum over
# the feat group whose output cotangent is the same on every feat rank must
# not be summed again in the backward (that over-counts gradients m-fold,
# which Adam's scale invariance hides from a loss trajectory):
#
#   * _complete_grad_feat: identity forward; the backward sums the cotangent
#     over the feat group. Wrap a feat-replicated value at each fork that
#     per-rank slices consume: its true cotangent is the sum of the ranks'
#     partial cotangents.
#   * _psum_feat: sum over the feat group forward; identity backward. Use it
#     to assemble partial products whose output cotangent is replicated (the
#     layer matmul z, the attention matvec za, the aggregation's blocks):
#     each rank's partial receives d(out), not m * d(out).
#
# The sums run in f32 (a bf16 cotangent is cast up and back).


def _feat_sum(t: torch.Tensor, group) -> torch.Tensor:
    from dorylus_tpu_torch.parallel import multihost  # the package imports the models

    out = t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    return multihost.all_reduce_sum(out, group).to(t.dtype)


class _CompleteGradFeat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _feat_sum(g, ctx.group), None


class _PsumFeat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return _feat_sum(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def _complete_grad_feat(x: torch.Tensor, group) -> torch.Tensor:
    return _CompleteGradFeat.apply(x, group)


def _psum_feat(x: torch.Tensor, group) -> torch.Tensor:
    return _PsumFeat.apply(x, group)


def self_term(h: torch.Tensor, self_val: torch.Tensor) -> torch.Tensor:
    """The self-loop term self_val[v] * h[v], in h's dtype."""
    return h * self_val[:, None].to(h.dtype)


def place_block(block: torch.Tensor, index: int, m: int) -> torch.Tensor:
    """block (V, F/m) at column block `index` of a (V, F) zero table (JAX's
    dynamic_update_slice into zeros): its backward slices the block out."""
    w = block.shape[1]
    return F.pad(block, (index * w, (m - 1 - index) * w))


class GCN(GNN):
    """Weights are parameters `w0`, `w1`, ... in the JAX (in, out) layout.

    spmm_op: the graph's aggregation op (HybSpMM, DegreeSpMM or
    ReuseSpMM), or None for the edgewise path, which needs `edge_op` (the
    CSR structure of the batch's edges). blk_rows > 0 takes JAX's
    dst-blocked branch (same sum, same op). spmm_split: the sharded
    engine's overlap op, the fused plan or an (interior, boundary) pair
    (in place of spmm_op); edge_split: the (interior, boundary) EdgeSpMM
    pair of the edgewise split (in place of edge_op). tp: the feat axis
    (tensor parallelism) when it has more than one slice, else None."""

    def __init__(self, layers: LayerConfig, spmm_op=None,
                 optimize_order: bool = True, edge_op: EdgeSpMM | None = None,
                 blk_rows: int = 0, spmm_split=None, edge_split=None,
                 tp: FeatAxis | None = None):
        super().__init__()
        if spmm_op is None and edge_op is None and spmm_split is None and edge_split is None:
            raise ValueError("GCN needs an aggregation op (spmm_op or "
                             "spmm_split) or an EdgeSpMM (edge_op or edge_split)")
        check_split(spmm_split)
        check_edge_split(edge_split)
        self.layers = layers
        self.spmm_op = spmm_op
        self.spmm_split = spmm_split
        self.edge_op = edge_op
        self.edge_split = edge_split
        self.optimize_order = optimize_order
        self.blk_rows = blk_rows
        self.tp = tp if tp is not None and tp.size > 1 else None
        if self.tp is not None and (spmm_split is not None or edge_split is not None):
            raise ValueError("tensor parallelism runs the combined plan: no overlap split")
        device = (spmm_op or edge_op or split_of(spmm_split, edge_split)).device
        dims = layers.dims
        for l in range(layers.num_layers):
            self._add_param(f"w{l}", (dims[l], dims[l + 1]), device)

    def init_params(self, seed: int = 8888, exact_reference: bool = True) -> Params:
        """Per-layer xavier weights from a fresh minstd engine each, as
        WeightServer::initWeightsMasterGCN (models/init.py, the port's copy
        of the JAX package's initializer)."""
        dims = self.layers.dims
        with torch.no_grad():
            for l, p in enumerate(self.params().values()):
                w = winit.xavier(dims[l], dims[l + 1], seed=seed,
                                 exact=exact_reference or None)
                p.copy_(torch.from_numpy(w))
        return self.params()

    def _aggregate(self, h: torch.Tensor, batch: GraphBatch,
                   halo: HaloFn | None = None) -> torch.Tensor:
        if halo is not None and (self.spmm_split is not None
                                 or self.edge_split is not None):
            return self._aggregate_split(h, batch, halo)
        table = halo(h) if halo is not None else h
        if self.spmm_op is None:
            if self.blk_rows:
                out = spmm_dst_blocked(table, batch.src, batch.dst, batch.edge_val,
                                       h.shape[0], self.blk_rows, op=self.edge_op)
                return out + self_term(h, batch.self_val)
            return aggregate(h, batch.src, batch.dst, batch.edge_val,
                             batch.self_val, h_table=table, op=self.edge_op)
        if self.spmm_op.has_static_vals:
            out = self.spmm_op.apply_static(table)
        else:
            out = self.spmm_op.apply(table, batch.edge_val.to(h.dtype))
        return out.to(h.dtype) + self_term(h, batch.self_val)

    def _aggregate_split(self, h: torch.Tensor, batch: GraphBatch,
                         halo: HaloFn) -> torch.Tensor:
        """The overlap paths: the exchange of h is in flight while the work
        that reads h alone is issued; the ghost rows arrive after it. The
        aggregation reads h through the join (hj), the self term h itself,
        made after the join (see the module docstring)."""
        hj, pending = start_halo(halo, h)
        if getattr(self.spmm_split, "fused", False):
            # The pure buckets gather h, the mixed ones h and the ghosts.
            op = self.spmm_split
            own = self_term(h, batch.self_val)
            pure = op.pure_range(hj, "static")
            out = op.apply_static_fused(hj, finish_halo(halo, pending), pure)
            return out.to(h.dtype) + own
        if self.spmm_split is not None:
            op_i, op_b = self.spmm_split
            own = self_term(h, batch.self_val)
            if op_i.has_static_vals:
                out_i = op_i.apply_static(hj)
                out_b = op_b.apply_static(finish_halo(halo, pending))
            else:
                out_i = op_i.apply(hj, batch.val_int.to(h.dtype))
                out_b = op_b.apply(finish_halo(halo, pending), batch.val_bnd.to(h.dtype))
            return (out_i + out_b).to(h.dtype) + own
        eop_i, eop_b = self.edge_split
        out_i = aggregate(hj, batch.src_int, batch.dst_int, batch.val_int,
                          batch.self_val, op=eop_i)
        out_b = spmm_edgewise(finish_halo(halo, pending), batch.src_bnd, batch.dst_bnd,
                              batch.val_bnd, h.shape[0], op=eop_b)
        return out_i + out_b

    def _forward_tp(self, batch: GraphBatch, compute_dtype: torch.dtype,
                    halo: HaloFn | None) -> torch.Tensor:
        """The tensor-parallel forward (JAX `_forward_tp`): per layer, this
        rank's column slice of h and the matching W row block; transform
        first when the layer shrinks and its output width divides m (the
        slice of hW is aggregated, the blocks psum-assembled), else aggregate
        the slice first; z is summed over the feat group. The slices are
        made contiguous: the gather kernels and K9's pack read whole rows."""
        m, fi, grp = self.tp
        num_layers = self.layers.num_layers
        h = batch.x.to(compute_dtype)
        for l, w in enumerate(self.params().values()):
            w = w.to(compute_dtype)
            check_divisible(h.shape[1], m, f"layer {l} input")
            blk = h.shape[1] // m
            h = _complete_grad_feat(h, grp)
            hs = h[:, fi * blk:(fi + 1) * blk].contiguous()
            ws = w[fi * blk:(fi + 1) * blk]
            if self.optimize_order and w.shape[0] > w.shape[1] and w.shape[1] % m == 0:
                hw = _psum_feat(torch.matmul(hs.float(), ws.float()), grp)
                blk_o = hw.shape[1] // m
                hws = _complete_grad_feat(hw, grp)[:, fi * blk_o:(fi + 1) * blk_o].contiguous()
                agg_s = self._aggregate(hws, batch, halo)
                z = _psum_feat(place_block(agg_s.to(hw.dtype), fi, m), grp)
            else:
                ah = self._aggregate(hs, batch, halo)
                z = _psum_feat(torch.matmul(ah.float(), ws.float()), grp)
            h = torch.tanh(z).to(compute_dtype) if l < num_layers - 1 else z
        return h

    def agg_width(self, l: int) -> int:
        """The width layer l aggregates (and exchanges) at: its output width
        when it transforms first, else its input width; under tensor
        parallelism the slice of it."""
        fin, fout = self.layers.dims[l], self.layers.dims[l + 1]
        m = 1 if self.tp is None else self.tp.size
        if self.optimize_order and fin > fout and fout % m == 0:
            return fout // m
        return fin // m

    def forward(self, batch: GraphBatch,
                compute_dtype: torch.dtype = torch.float32,
                halo: HaloFn | None = None) -> torch.Tensor:
        """Logits (V, C); on a shard, (vp, C) with `halo` the exchange."""
        if self.tp is not None:
            return self._forward_tp(batch, compute_dtype, halo)
        num_layers = self.layers.num_layers
        h = batch.x.to(compute_dtype)
        for l, w in enumerate(self.params().values()):
            w = w.to(compute_dtype)
            # Products in f32 on compute_dtype-rounded operands: JAX's dot
            # with preferred_element_type=float32.
            if self.optimize_order and w.shape[0] > w.shape[1]:
                z = self._aggregate(torch.matmul(h.float(), w.float()), batch, halo)
            else:
                z = torch.matmul(self._aggregate(h, batch, halo).float(), w.float())
            # Hidden activations return to compute_dtype; z is f32.
            h = torch.tanh(z).to(compute_dtype) if l < num_layers - 1 else z
        return h
