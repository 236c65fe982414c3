"""Build GraphBatch tensors on a device from a host-side Graph (port of
dorylus_tpu/engine/batch.py)."""

from __future__ import annotations

import numpy as np
import torch

from dorylus_tpu.common.config import TRAIN_PORTION
from dorylus_tpu.graph.graph import Graph
from dorylus_tpu_torch.models.base import GraphBatch


def onehot_labels(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """uint8 one-hot (the loss and eval ops cast rows on the fly); labels
    < 0 (unlabelled) give an all-zero row."""
    out = np.zeros((labels.shape[0], num_classes), dtype=np.uint8)
    valid = labels >= 0
    out[np.arange(labels.shape[0])[valid], labels[valid]] = 1
    return out


def build_batch(g: Graph, device: str | torch.device, for_gat: bool = False,
                edge_arrays: bool = True) -> GraphBatch:
    """The whole graph on `device`.

    for_gat: edge_val is GAT's {0,1} edge mask (all ones: every edge is
    real) in place of the GCN norms.

    edge_arrays=False ships zero-length src/dst/edge_val stubs: the hyb
    paths (GCN's static plan, GAT's mask plans) read only their plan
    tensors, so the E-sized COO triple would be dead device memory."""
    train_m, val_m, test_m = g.masks()
    if edge_arrays:
        edge_val = np.ones(g.num_edges, np.float32) if for_gat else g.edge_norm
        src, dst = g.src, g.dst
    else:
        src = dst = np.zeros(0, np.int32)
        edge_val = np.zeros(0, np.float32)

    def t(a, dtype=None):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return GraphBatch(
        x=t(g.features, torch.float32),
        onehot=t(onehot_labels(g.labels, g.num_classes)),
        src=t(src, torch.int32),
        dst=t(dst, torch.int32),
        edge_val=t(edge_val, torch.float32),
        self_val=t(g.self_norm, torch.float32),
        train_mask=t(train_m.astype(np.float32)),
        val_mask=t(val_m.astype(np.float32)),
        test_mask=t(test_m.astype(np.float32)),
        # Loss denominator |V_global| * 0.66, the reference's trainset_size
        # (lambda_comm.cpp:156, funcs/gcn/main.cpp:100-101), as f32.
        denom=torch.tensor(np.float32(g.num_vertices * TRAIN_PORTION),
                           device=device),
    )
