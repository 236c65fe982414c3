"""Checkpoint / resume (port of dorylus_tpu/engine/checkpoint.py, file for
file: a checkpoint written by either package loads in the other).

Format: a single .npz per checkpoint (np.savez, no pickled code objects —
a checkpoint dir pointed at by --checkpoint-dir is untrusted input and must
not execute anything on load). Array keys are namespaced:

    params/<name>              model parameters (float32, the (in, out) layout)
    opt/step, opt/m|v/<name>   Adam state (absent for SGD runs); opt/step is
                               an int32 0-d array, as the JAX package's
                               AdamState.step is
    __meta__                   JSON blob: step + caller extras

A checkpoint is written to a dotfile temp and renamed into place, and the
LATEST marker is published the same way, so a crash mid-write never leaves
a file that `latest_checkpoint` would pick.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from dorylus_tpu_torch.interop import adam_state_to_numpy, params_to_numpy
from dorylus_tpu_torch.optim.adam import AdamState


def save_checkpoint(ckpt_dir: str | Path, step: int,
                    params: Mapping[str, torch.Tensor],
                    opt_state: Optional[AdamState] = None,
                    extra: Optional[dict] = None) -> Path:
    """Write ckpt_<step>.npz into ckpt_dir and point LATEST at it."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"ckpt_{step:08d}.npz"
    # Dotfile temp name: the latest_checkpoint glob (ckpt_*.npz) never
    # matches a partially written file.
    tmp = d / f".ckpt_{step:08d}.npz.tmp"

    arrays: dict[str, np.ndarray] = {}
    for name, w in params_to_numpy(params).items():
        arrays[f"params/{name}"] = w
    if opt_state is not None:
        if not isinstance(opt_state, AdamState):
            raise TypeError(f"opt_state: an AdamState, got {type(opt_state).__name__}")
        st = adam_state_to_numpy(opt_state)
        arrays["opt/step"] = np.asarray(st["step"], np.int32)
        for name, m in st["m"].items():
            arrays[f"opt/m/{name}"] = m
        for name, v in st["v"].items():
            arrays[f"opt/v/{name}"] = v
    meta = {"step": int(step), "extra": extra or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)

    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.rename(path)  # atomic publish
    # LATEST published atomically too: an empty marker must never be seen.
    ltmp = d / ".LATEST.tmp"
    ltmp.write_text(path.name)
    ltmp.rename(d / "LATEST")
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Optional[Path]:
    """The file LATEST names, or else the newest ckpt_*.npz; None if none."""
    d = Path(ckpt_dir)
    marker = d / "LATEST"
    if marker.exists():
        name = marker.read_text().strip()
        if name:  # an empty marker would resolve to the directory itself
            p = d / name
            if p.is_file():
                return p
    cands = sorted(p for p in d.glob("ckpt_*.npz")
                   if not p.name.endswith(".tmp.npz"))  # an older temp naming
    return cands[-1] if cands else None


def load_checkpoint(path: str | Path) -> dict:
    """{"step", "params", "opt_state", "extra"}: params a dict of numpy
    arrays, opt_state None or {"step": int, "m": {...}, "v": {...}} (what
    interop.adam_state_from_numpy takes). allow_pickle stays False."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        params = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("params/")}
        opt_state = None
        if "opt/step" in z.files:
            opt_state = {
                "step": int(z["opt/step"]),
                "m": {k.split("/", 2)[2]: z[k] for k in z.files if k.startswith("opt/m/")},
                "v": {k.split("/", 2)[2]: z[k] for k in z.files if k.startswith("opt/v/")}}
    return {"step": meta["step"], "params": params, "opt_state": opt_state,
            "extra": meta["extra"]}
