"""Load jax-free modules of `dorylus_tpu` whose packages depend on jax.

`dorylus_tpu/models/init.py` and `dorylus_tpu/engine/convergence.py` use
only numpy and the standard library, but `dorylus_tpu.models` and
`dorylus_tpu.engine` load jax in their `__init__`s, so a plain import
would pull jax in. Loading the file by path runs only that file.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType

_JAX_PKG = Path(__file__).resolve().parent.parent / "dorylus_tpu"


@functools.cache
def load(relpath: str) -> ModuleType:
    """Module object for `dorylus_tpu/<relpath>`, executed once per process.

    Only for files whose own imports are jax-free (e.g. "models/init.py",
    "engine/convergence.py")."""
    path = _JAX_PKG / relpath
    name = "dorylus_tpu_torch._shared." + relpath.removesuffix(".py").replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
