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


# PyTorch's own handle of the current stream, without building a Stream
# object per call (what torch.cuda.current_stream(i).cuda_stream returns).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(index: int) -> int:
    """The raw cudaStream_t (an int) of the current stream on card `index`,
    for a kernel launch."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream
