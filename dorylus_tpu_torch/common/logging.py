"""(The port's own copy of dorylus_tpu/common/logging.py.)

Structured logging, in the spirit of the reference's printLog(nodeId, ...)
(src/graph-server/utils) and serverLog (weightserver.cpp:996-1001)."""

from __future__ import annotations

import sys
import time

_START = time.time()
_VERBOSE = True


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def log(msg: str, *args, node: int | None = None) -> None:
    if not _VERBOSE:
        return
    t = time.time() - _START
    prefix = f"[{t:9.3f}s]" if node is None else f"[{t:9.3f}s][node {node}]"
    print(f"{prefix} {msg % args if args else msg}", file=sys.stderr, flush=True)
