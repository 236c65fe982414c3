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

Sharded (`halo` given): on the three overlap paths the exchange of z is
started (`halo.start`), the work that reads z alone is issued, the
exchange is finished (`halo.finish`: the ghost z rows alone) and the rest
is issued, as in models/gcn.py. The attention vector leaky(za) is local,
so it is issued before the finish too. In the backward the aggregation and
the residual z + agg read z through the join `halo.start` returns, so the
reverse exchange finishes after the interior op's backward; za reads z
itself and is made after the join, so autograd (the ready node made last
runs first) runs the attention's gradient (leaky's, then z @ a's) beside
the reverse exchange as well, and z's gradient adds it after the join's
sum: on the fused plan the order of the exchange run whole, bit for bit.
With the fused-overlap op (`spmm_split`) the work beside the exchange is K8's pure range
(`pure_range`), then `apply_dst_fused(z, ghosts, leaky(za), pure)` adds the
mixed range (JAX's overlap branch); with the (interior, boundary) op pair
(`spmm_split` a 2-tuple, the degree kernel's overlap plan) two `apply_dst`
passes, interior over z beside the exchange and boundary over the ghosts
after it, both weighted by the same local leaky(za); with the edgewise
split (`edge_split`, two EdgeSpMM) two CSR SpMMs with att over `dst_int`
(beside the exchange) and `dst_bnd`. Autograd sums the two contributions
to d(att). Otherwise `halo(z)` returns the feature table and the combined
op or the edgewise op gathers from it.

Tensor parallelism (`tp`, a FeatAxis of m > 1; JAX `_forward_tp`): z is
the feat group's sum of this rank's slice of h times its W row block; the
attention matvec runs block-wise on column-masked z, so each rank's d(a)
covers its own rows and the engine's world sum assembles it; the
aggregation takes this rank's F/m slice of z where the layer width divides
m (the halo at F/m over the graph group), else the whole z on every rank
(the output layer at 41 with m = 2, and the edgewise path).

Not ported: the `past_agg_cliff` regime branch (`models/gat.py:245-264`,
aggregate h at its input width and transform after). It models a TPU
gather cliff (ROADMAP.md "Not to port") and fires in JAX only with a bf16
gather table of V·F·2 B >= 64 MB (V >= ~819k at F = 41): neither at the
Reddit config nor at test sizes, so both packages take the same branch
there.
"""

from __future__ import annotations

import torch

from dorylus_tpu_torch.common.config import LayerConfig
from dorylus_tpu_torch.models import init as winit
from dorylus_tpu_torch.models.base import (GNN, FeatAxis, GraphBatch, HaloFn, Params,
                                           check_divisible, check_edge_split, check_split,
                                           finish_halo, split_of, start_halo)
from dorylus_tpu_torch.models.gcn import _complete_grad_feat, _psum_feat, place_block
from dorylus_tpu_torch.ops.activations import leaky_relu
from dorylus_tpu_torch.ops.spmm import (EdgeSpMM, spmm_dst_blocked,
                                        spmm_edgewise, take_sorted)


class GAT(GNN):
    """Parameters `w{l}` (in, out) and `a{l}` (out, 1), in the JAX names,
    layout and order (w0, a0, w1, a1, ...).

    spmm_op: an aggregation op with `apply_dst` (HybSpMM, DegreeSpMM or
    ReuseSpMM), or None for the edgewise path, which needs `edge_op`.
    blk_rows > 0 takes JAX's dst-blocked branch (same sum, same op).
    spmm_split: the sharded engine's overlap op, the fused plan or an
    (interior, boundary) pair (in place of spmm_op); edge_split: the
    (interior, boundary) EdgeSpMM pair of the edgewise split (in place of
    edge_op). tp: the feat axis (tensor parallelism) when it has more than
    one slice, else None."""

    def __init__(self, layers: LayerConfig, spmm_op=None,
                 edge_op: EdgeSpMM | None = None, blk_rows: int = 0,
                 spmm_split=None, edge_split=None, tp: FeatAxis | None = None):
        super().__init__()
        if spmm_op is None and edge_op is None and spmm_split is None and edge_split is None:
            raise ValueError("GAT needs an aggregation op (spmm_op or "
                             "spmm_split) or an EdgeSpMM (edge_op or edge_split)")
        check_split(spmm_split)
        check_edge_split(edge_split)
        self.layers = layers
        self.spmm_op = spmm_op
        self.spmm_split = spmm_split
        self.edge_op = edge_op
        self.edge_split = edge_split
        self.blk_rows = blk_rows
        self.tp = tp if tp is not None and tp.size > 1 else None
        if self.tp is not None and (spmm_split is not None or edge_split is not None):
            raise ValueError("tensor parallelism runs the combined plan: no overlap split")
        device = (spmm_op or edge_op or split_of(spmm_split, edge_split)).device
        dims = layers.dims
        for l in range(layers.num_layers):
            self._add_param(f"w{l}", (dims[l], dims[l + 1]), device)
            self._add_param(f"a{l}", (dims[l + 1], 1), device)

    def init_params(self, seed: int = 8888, exact_reference: bool = True) -> Params:
        """w: xavier; a: kaiming — initWeightsMasterGAT
        (weightserver.cpp:535-559), through models/init.py (the port's
        copy of the JAX package's initializer)."""
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
                   edge_mask: torch.Tensor, halo: HaloFn | None = None,
                   pending=None) -> torch.Tensor:
        """pending: the exchange `start_halo` began from z, on the overlap
        paths (z is then the joined z)."""
        if pending is not None:
            return self._aggregate_split(z, za, batch, halo, pending)
        table = halo(z) if halo is not None else z
        if self.spmm_op is not None:
            return self.spmm_op.apply_dst(table, leaky_relu(za)).to(z.dtype)
        op, v = self.edge_op, z.shape[0]
        att = leaky_relu(take_sorted(za, batch.dst, v, op=op)) * edge_mask
        if self.blk_rows:
            return spmm_dst_blocked(table, batch.src, batch.dst, att, v,
                                    self.blk_rows, op=op)
        return spmm_edgewise(table, batch.src, batch.dst, att, v, op=op)

    def _aggregate_split(self, z: torch.Tensor, za: torch.Tensor, batch: GraphBatch,
                         halo: HaloFn, pending) -> torch.Tensor:
        """The overlap paths: the exchange of z is in flight while the work
        that reads z alone is issued; the ghost z rows arrive after it."""
        if getattr(self.spmm_split, "fused", False):
            op = self.spmm_split
            att_v = leaky_relu(za)
            pure = op.pure_range(z, "mask")
            return op.apply_dst_fused(z, finish_halo(halo, pending), att_v, pure).to(z.dtype)
        if self.spmm_split is not None:
            # Two dst-functional passes, both weighted by the local
            # attention vector.
            op_i, op_b = self.spmm_split
            att_v = leaky_relu(za)
            out_i = op_i.apply_dst(z, att_v)
            return (out_i + op_b.apply_dst(finish_halo(halo, pending), att_v)).to(z.dtype)
        eop_i, eop_b = self.edge_split
        v = z.shape[0]
        att_i = (leaky_relu(take_sorted(za, batch.dst_int, v, op=eop_i))
                 * batch.val_int.to(za.dtype))
        att_b = (leaky_relu(take_sorted(za, batch.dst_bnd, v, op=eop_b))
                 * batch.val_bnd.to(za.dtype))
        out_i = spmm_edgewise(z, batch.src_int, batch.dst_int, att_i, v, op=eop_i)
        return out_i + spmm_edgewise(finish_halo(halo, pending), batch.src_bnd,
                                     batch.dst_bnd, att_b, v, op=eop_b)

    def _forward_tp(self, batch: GraphBatch, compute_dtype: torch.dtype,
                    halo: HaloFn | None) -> torch.Tensor:
        """The tensor-parallel forward (JAX `_forward_tp`). One
        `_complete_grad_feat` fork of z serves both of its per-rank
        consumers (the masked matvec and the slice), so its backward is one
        sum over the feat group a layer."""
        m, fi, grp = self.tp
        h = batch.x.to(compute_dtype)
        edge_mask = batch.edge_val.to(compute_dtype)
        for l in range(self.layers.num_layers):
            w = getattr(self, f"w{l}").to(compute_dtype)
            a = getattr(self, f"a{l}").to(compute_dtype)
            check_divisible(h.shape[1], m, f"layer {l} input")
            blk = h.shape[1] // m
            h = _complete_grad_feat(h, grp)
            hs = h[:, fi * blk:(fi + 1) * blk]
            ws = w[fi * blk:(fi + 1) * blk]
            z = _psum_feat(torch.matmul(hs.float(), ws.float()), grp).to(compute_dtype)
            fo = z.shape[1]
            # column mask of this rank's block (a width that does not divide
            # m, the output layer, takes uneven blocks)
            cmask = torch.zeros(fo, dtype=z.dtype, device=z.device)
            cmask[fi * fo // m:(fi + 1) * fo // m] = 1
            zc = _complete_grad_feat(z, grp)
            za = _psum_feat(torch.matmul((zc * cmask).float(), a.float()), grp)[:, 0]
            att = leaky_relu(za)
            if fo % m == 0 and self.spmm_op is not None:
                blk_o = fo // m
                zs = zc[:, fi * blk_o:(fi + 1) * blk_o].contiguous()
                att_s = _complete_grad_feat(att, grp)  # the partial aggregations read it
                table = halo(zs) if halo is not None else zs
                agg_s = self.spmm_op.apply_dst(table, att_s)
                agg = _psum_feat(place_block(agg_s.to(z.dtype), fi, m), grp)
            else:
                # the whole z on every feat rank: no cotangent to complete
                table = halo(z) if halo is not None else z
                if self.spmm_op is not None:
                    agg = self.spmm_op.apply_dst(table, att).to(z.dtype)
                else:
                    v = z.shape[0]
                    av = leaky_relu(take_sorted(za, batch.dst, v, op=self.edge_op)) * edge_mask
                    agg = spmm_edgewise(table, batch.src, batch.dst, av, v, op=self.edge_op)
            h = z + agg
        return h

    def agg_width(self, l: int) -> int:
        """The width layer l aggregates (and exchanges) at: its output width;
        under tensor parallelism the slice of it where it divides m and the
        op takes slices."""
        fo = self.layers.dims[l + 1]
        m = 1 if self.tp is None else self.tp.size
        return fo // m if fo % m == 0 and self.spmm_op is not None else fo

    def forward(self, batch: GraphBatch,
                compute_dtype: torch.dtype = torch.float32,
                halo: HaloFn | None = None) -> torch.Tensor:
        """Logits (V, C); on a shard, (vp, C) with `halo` the exchange."""
        if self.tp is not None:
            return self._forward_tp(batch, compute_dtype, halo)
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
            zj, pending = z, None
            if halo is not None and (self.spmm_split is not None
                                     or self.edge_split is not None):
                zj, pending = start_halo(halo, z)
            za = torch.matmul(z, a.float())[:, 0]
            h = zj + self._aggregate(zj, za, batch, edge_mask, halo, pending)
            if l < num_layers - 1:
                h = h.to(compute_dtype)
        return h
