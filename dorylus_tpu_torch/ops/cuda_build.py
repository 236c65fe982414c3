"""Build the port's CUDA sources (ops/csrc/*.cu) with nvcc at first use.

Each source becomes a shared library with a plain C interface, compiled for
sm_90a into dorylus_tpu_torch/_build/ (gitignored) and loaded with ctypes.
The library name carries a hash of the source and the shared headers, so a
stale build is never loaded. `compile_sources` starts one nvcc per source
that still needs building, all at once, and waits for all of them; its
span and `load`'s say where the build's seconds went.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from dorylus_tpu_torch.common.metrics import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def compile_sources(sources: list[Path]) -> dict[Path, dict]:
    """Build every source whose library is missing, one nvcc each, all
    started together, inside the span cuda_build.compile (attribute:
    libraries, those built), each one's wait in a span cuda_build.nvcc
    (attribute: library). Returns {source: {"path", "compiled", "seconds",
    "log"}}: compiled False, seconds 0 and an empty log when the library was
    already built; else seconds runs from the start of the batch to the end
    of that source's wait (its nvcc's wall time, or longer where a source
    waited on before it finished later). Raises RuntimeError naming every
    source nvcc refused."""
    info, todo = {}, []
    for src in sources:
        so = library_path(src)
        if so.exists():
            info[src] = {"path": str(so), "compiled": False, "seconds": 0.0, "log": ""}
        else:
            todo.append((src, so))
    if not todo:
        return info
    errors = []
    with span("cuda_build.compile", libraries=len(todo)) as sp:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = []
        for src, so in todo:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((src, so, tmp, cmd, proc))
        for src, so, tmp, cmd, proc in running:
            with span("cuda_build.nvcc", library=src.stem) as wait:
                try:
                    log_text, _ = proc.communicate(timeout=900)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    log_text, _ = proc.communicate()
                    errors.append(f"nvcc timed out: {' '.join(cmd)}")
                    continue
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                              f"{log_text}")
                continue
            os.replace(tmp, so)
            info[src] = {"path": str(so), "compiled": True,
                         "seconds": wait.end - sp.start, "log": log_text}
    if errors:
        raise RuntimeError("\n".join(errors))
    return info


def load(src: Path) -> tuple[ctypes.CDLL, dict]:
    """Build `src` if needed and load its library, inside the span
    cuda_build.load (attributes: library, compiled: whether nvcc ran)."""
    with span("cuda_build.load", library=src.stem) as sp:
        info = compile_sources([src])[src]
        sp.attrs["compiled"] = info["compiled"]
        return ctypes.CDLL(info["path"]), info
