"""GraphBatch: the graph's training tensors on one device (port of
dorylus_tpu/models/base.py; the shape contract is unchanged)."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class GraphBatch(NamedTuple):
    """Tensors for the whole graph, all on one explicit device."""

    x: torch.Tensor  # (V, F) float32 input features
    onehot: torch.Tensor  # (V, C) uint8 one-hot labels
    src: torch.Tensor  # (E,) int32, or (0,) stubs when plans carry the values
    dst: torch.Tensor  # (E,) int32 (dst ascending), or (0,) stubs
    edge_val: torch.Tensor  # (E,) float32 GCN norms, or (0,) stubs
    self_val: torch.Tensor  # (V,) float32 self-loop norms
    train_mask: torch.Tensor  # (V,) float32
    val_mask: torch.Tensor  # (V,) float32
    test_mask: torch.Tensor  # (V,) float32
    denom: torch.Tensor  # () float32 = |V_global| * TRAIN_PORTION


Params = Dict[str, torch.Tensor]
