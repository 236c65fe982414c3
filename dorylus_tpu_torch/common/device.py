"""Where the port's engines and ops live: the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an engine or op runs on: None means the card and raises
    when there is none; nothing falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dorylus_tpu_torch runs on the card by default and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" to "
                "run on the CPU")
        device = "cuda"
    return torch.device(device)
