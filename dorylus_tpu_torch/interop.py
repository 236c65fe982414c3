"""Carry parameters and Adam state between numpy and the port.

The JAX package's params are a dict of arrays ("w0", "w1", ... in the
(in, out) layout) and its Adam state is (step, m, v); as numpy arrays they
move into the port unchanged, so both packages can compute the same thing
from the same starting point.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dorylus_tpu_torch.models.base import Params
from dorylus_tpu_torch.optim.adam import AdamState


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device: str | torch.device) -> Params:
    """dict of arrays -> dict of float32 tensors on `device` (copies)."""
    return {k: torch.tensor(np.asarray(a, np.float32), device=device)
            for k, a in arrays.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: p.detach().cpu().numpy().copy() for k, p in params.items()}


def adam_state_from_numpy(state: Mapping, device: str | torch.device) -> AdamState:
    """{"step": int, "m": {name: array}, "v": {name: array}} -> AdamState."""
    return AdamState(step=int(state["step"]),
                     m=params_from_numpy(state["m"], device),
                     v=params_from_numpy(state["v"], device))


def adam_state_to_numpy(state: AdamState) -> dict:
    return {"step": int(state.step), "m": params_to_numpy(state.m),
            "v": params_to_numpy(state.v)}
