"""GraphBatch and the models' shared surface (port of
dorylus_tpu/models/base.py; the batch's shape contract is unchanged)."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from dorylus_tpu_torch.ops.activations import masked_softmax_xent, row_softmax


class GraphBatch(NamedTuple):
    """Tensors for the whole graph, all on one explicit device."""

    x: torch.Tensor  # (V, F) float32 input features
    onehot: torch.Tensor  # (V, C) uint8 one-hot labels
    src: torch.Tensor  # (E,) int32, or (0,) stubs when plans carry the values
    dst: torch.Tensor  # (E,) int32 (dst ascending), or (0,) stubs
    edge_val: torch.Tensor  # (E,) float32 GCN norms, GAT {0,1} mask, or (0,) stubs
    self_val: torch.Tensor  # (V,) float32 self-loop norms
    train_mask: torch.Tensor  # (V,) float32
    val_mask: torch.Tensor  # (V,) float32
    test_mask: torch.Tensor  # (V,) float32
    denom: torch.Tensor  # () float32 = |V_global| * TRAIN_PORTION
    # Interior/boundary edge split (the sharded overlap path; None when
    # unused). When present, models treat the halo callable as returning
    # ghost rows only: interior edges gather from local h (src into
    # [0, vp)), boundary edges from the ghost rows (src into
    # [0, n * max_h)); both dst-ascending. Zero-length stubs where the
    # split ops' plans carry what aggregation reads.
    src_int: Optional[torch.Tensor] = None
    dst_int: Optional[torch.Tensor] = None
    val_int: Optional[torch.Tensor] = None
    src_bnd: Optional[torch.Tensor] = None
    dst_bnd: Optional[torch.Tensor] = None
    val_bnd: Optional[torch.Tensor] = None


class FeatAxis(NamedTuple):
    """A model's place on the mesh's feat axis (tensor parallelism,
    parallel/mesh.py): m column slices, this rank's slice, and the process
    group of the m ranks that hold the same vertex shard."""

    size: int
    index: int
    group: object


def check_divisible(width: int, m: int, what: str) -> None:
    """Tensor parallelism slices a width into m equal column blocks, as JAX
    asserts; a width that does not divide raises (nothing is padded)."""
    if width % m:
        raise ValueError(f"{what} width {width} not divisible by feat_shards={m}")


Params = Dict[str, torch.Tensor]
# The sharded engine's exchange (parallel/halo.py make_halo_fn's `Halo`): h
# -> the feature table (local rows, then ghosts), or the ghost rows only on
# the overlap paths (the fused plan, the (interior, boundary) op pair, the
# edgewise split), which also split it with `start` / `finish`.
HaloFn = Callable[[torch.Tensor], torch.Tensor]


def start_halo(halo: HaloFn, h: torch.Tensor) -> tuple:
    """The overlap paths' first step: start exchanging h where the halo
    has a `start` (parallel/halo.py `Halo`). Returns (h joined to the
    reverse exchange, the exchange): the layer's work whose gradient the
    reverse exchange must wait for reads the joined h. A halo that is only
    a callable exchanges nothing yet: `finish_halo` then runs it whole."""
    if not hasattr(halo, "start"):
        return h, h
    pending = halo.start(h)
    return pending.h, pending


def finish_halo(halo: HaloFn, pending) -> torch.Tensor:
    """The ghost rows of the exchange `start_halo` began."""
    return halo.finish(pending) if hasattr(halo, "start") else halo(pending)


def check_split(spmm_split) -> None:
    """What the models take as `spmm_split`: None, the fused-overlap op
    (ShardedHybSpMM edges="fused"), or an (interior, boundary) pair of ops
    with the aggregation protocol that write the same rows (JAX's
    `op_i, op_b = self.spmm_split`)."""
    if spmm_split is None or getattr(spmm_split, "fused", False):
        return
    pair = isinstance(spmm_split, (tuple, list)) and len(spmm_split) == 2
    if not pair or any(getattr(op, "fused", False) or not hasattr(op, "apply_dst")
                       for op in spmm_split):
        raise ValueError("spmm_split: the fused-overlap op or an (interior, "
                         f"boundary) op pair, got {spmm_split!r}")
    op_i, op_b = spmm_split
    if op_i.num_out != op_b.num_out or op_i.has_static_vals != op_b.has_static_vals:
        raise ValueError("spmm_split: the interior and boundary ops must write the "
                         "same rows and both hold static values or neither")


def check_edge_split(edge_split) -> None:
    """The edgewise split's structures: an (interior, boundary) pair of
    EdgeSpMM over the same output rows."""
    if edge_split is None:
        return
    if not (isinstance(edge_split, (tuple, list)) and len(edge_split) == 2
            and edge_split[0].num_out == edge_split[1].num_out):
        raise ValueError("edge_split: an (interior, boundary) pair of EdgeSpMM over "
                         f"the same output rows, got {edge_split!r}")


def split_of(spmm_split, edge_split):
    """The op a model places its parameters by, among its split ops."""
    for ops in (spmm_split, edge_split):
        if ops is not None:
            return ops[0] if isinstance(ops, (tuple, list)) else ops
    return None


class GNN(nn.Module):
    """A model's parameters in the JAX names and (in, out) layout, so
    `load_state_dict(interop.params_from_numpy(jax_params, device))`
    carries the JAX package's params over unchanged; and the loss and
    prediction both models share."""

    def _add_param(self, name: str, shape: tuple, device: torch.device) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(shape, device=device)))

    def params(self) -> Params:
        return dict(self.named_parameters())

    def forward(self, batch: GraphBatch,
                compute_dtype: torch.dtype = torch.float32,
                halo: HaloFn | None = None) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: GraphBatch,
             compute_dtype: torch.dtype = torch.float32,
             halo: HaloFn | None = None, params: Params | None = None) -> torch.Tensor:
        """The training loss. params: tensors to run the forward on in
        place of the model's own parameters, by name (the stale weights of
        bounded staleness), so gradients are taken with respect to them."""
        return self.loss_and_logits(batch, compute_dtype, halo, params)[0]

    def loss_and_logits(self, batch: GraphBatch,
                        compute_dtype: torch.dtype = torch.float32,
                        halo: HaloFn | None = None,
                        params: Params | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """`loss`, and the logits of the forward it ran."""
        if params is None:
            logits = self.forward(batch, compute_dtype, halo)
        else:
            logits = torch.func.functional_call(self, params, (batch, compute_dtype, halo))
        return masked_softmax_xent(logits, batch.onehot, batch.train_mask,
                                   batch.denom), logits

    def predict(self, batch: GraphBatch, halo: HaloFn | None = None) -> torch.Tensor:
        return row_softmax(self.forward(batch, halo=halo))
