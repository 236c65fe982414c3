"""Activations + loss with Dorylus-exact semantics (port of
dorylus_tpu/ops/activations.py).

- row softmax with max-subtraction (max detached) and a 1e-20 denominator
  guard (CPU_comm.cpp:276-297)
- leaky ReLU slope 0.01 (funcs/gat/ops/forward_ops.cpp:39)
- masked cross-entropy whose gradient is the reference's maskout +
  (preds - labels) / trainset_size final-layer gradient
  (funcs/gcn/main.cpp:96-101)
- evaluation as sendAccLoss (funcs/gcn/ops/network_ops.cpp:142-156)
"""

from __future__ import annotations

import torch


def row_softmax(z: torch.Tensor) -> torch.Tensor:
    z = z - torch.amax(z, dim=-1, keepdim=True).detach()
    e = torch.exp(z)
    return e / (torch.sum(e, dim=-1, keepdim=True) + 1e-20)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return torch.where(x > 0, x, slope * x)


def masked_softmax_xent(logits: torch.Tensor, onehot: torch.Tensor,
                        mask: torch.Tensor,
                        denom: float | torch.Tensor) -> torch.Tensor:
    """Sum over masked rows of CE(softmax(logits), onehot) / denom;
    d(loss)/d(logits) = mask * (softmax(logits) - onehot) / denom."""
    logz = torch.log_softmax(logits, dim=-1)
    per_row = -torch.sum(onehot.to(logz.dtype) * logz, dim=-1)
    return torch.sum(per_row * mask.to(per_row.dtype)) / denom


def accuracy_and_loss(probs: torch.Tensor, onehot: torch.Tensor,
                      mask: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(correct_count, loss_sum, row_count) over the masked rows: acc counts
    label[argmax(pred)] (the first maximum, as jnp.argmax); loss is
    -log pred[argmax(label)], clamped at 1e-30."""
    m = mask.to(torch.float32)
    pred_cls = _first_argmax(probs)
    correct = torch.sum(torch.gather(onehot, 1, pred_cls[:, None])[:, 0]
                        .to(torch.float32) * m)
    true_cls = _first_argmax(onehot)
    p_true = torch.gather(probs, 1, true_cls[:, None])[:, 0]
    loss = -torch.sum(torch.log(torch.clamp(p_true, min=1e-30)) * m)
    return correct, loss, torch.sum(m)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum of each row (torch.argmax does not
    promise which of several equal maxima it returns)."""
    is_max = x == torch.amax(x, dim=-1, keepdim=True)
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(is_max, idx, x.shape[-1]).amin(dim=-1)
