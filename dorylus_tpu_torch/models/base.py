"""GraphBatch and the models' shared surface (port of
dorylus_tpu/models/base.py; the batch's shape contract is unchanged)."""

from __future__ import annotations

from typing import Dict, NamedTuple

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


Params = Dict[str, torch.Tensor]


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
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: GraphBatch,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        logits = self.forward(batch, compute_dtype)
        return masked_softmax_xent(logits, batch.onehot, batch.train_mask,
                                   batch.denom)

    def predict(self, batch: GraphBatch) -> torch.Tensor:
        return row_softmax(self.forward(batch))
