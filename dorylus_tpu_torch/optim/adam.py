"""Adam with the reference weight server's math (port of
dorylus_tpu/optim/adam.py).

Reference: src/weight-server/AdamOptimizer.{hpp,cpp} —
    BETA1=0.9, BETA2=0.999, EPSILON=1e-7, WEIGHT_DECAY=0
    lr_t = lr * sqrt(1 - B2^t) / (1 - B1^t)
    m = B1*m + (1-B1)*g ;  v = B2*v + (1-B2)*g^2
    w -= lr_t * m / (sqrt(v) + eps)

The step counter t advances once per epoch and the first update uses t=1.

Unlike the JAX version, which returns new arrays, `adam_update` and
`sgd_update` update the parameter and moment tensors IN PLACE under
torch.no_grad() (no second copy of the weights and moments) and return
them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dorylus_tpu_torch.models.base import Params


class AdamState(NamedTuple):
    step: int  # = reference `epochs` counter
    m: Params  # momentum, same keys as params
    v: Params  # decay


def adam_init(params: Params) -> AdamState:
    return AdamState(step=0,
                     m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def adam_update(params: Params, grads: Params, state: AdamState,
                lr: float = 0.01, beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-7, weight_decay: float = 0.0
                ) -> tuple[Params, AdamState]:
    """One Adam step, in place. lr_t is computed in float32, as the JAX
    version computes it from its f32 step counter."""
    t = state.step + 1
    tf = np.float32(t)
    lr_t = float(np.float32(lr) * np.sqrt(np.float32(1.0) - np.float32(beta2) ** tf)
                 / (np.float32(1.0) - np.float32(beta1) ** tf))
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            gt = g + weight_decay * p if weight_decay else g
            m, v = state.m[k], state.v[k]
            m.mul_(beta1).add_(gt, alpha=1.0 - beta1)
            v.mul_(beta2).add_(gt * gt, alpha=1.0 - beta2)
            p.sub_(lr_t * m / (torch.sqrt(v) + eps))
    return params, AdamState(step=t, m=state.m, v=state.v)


def sgd_update(params: Params, grads: Params, lr: float) -> Params:
    """Plain SGD, in place (the reference's non-Adam path,
    weighttensor.cpp:253-262)."""
    with torch.no_grad():
        for k, p in params.items():
            p.sub_(lr * grads[k])
    return params


def decay_lr(lr: float, epoch: int, every: int = 20, factor: float = 0.7) -> float:
    """LR decay mirroring WeightServer's schedule (weightserver.cpp:296-305)."""
    return lr * (factor ** (epoch // every))
