"""Pair-mining throughput at production scale (the port's counterpart of the
JAX package's tools/bench_mine.py, with its flags and record keys).

    python -m dorylus_tpu_torch.tools.bench_mine [--vertices 5000000]
        [--degree 20] [--passes 1] [--numpy-also] [--out FILE]

Generates a community-core graph (graph/graph.py `community_core_edges`:
the overlap-heavy real-social-graph shape pair reuse targets) and times
graph/reuse.py `mine_reuse` on the native miner (native/graphcore.cpp
`gc_mine_pairs`, built and loaded by native.py); with `--numpy-also` also
one pass of the numpy miner (`_mine_one`), which must find as many pairs.
A host tool: the miner is set-up work on the CPU, and nothing here runs on
the card. Where native/libgraphcore.so does not build (a host without
libgomp, such as the card's machine) it raises: the numpy miner alone is
no measure of the native one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional


def bench(vertices: int = 5_000_000, degree: int = 20, passes: int = 1,
          numpy_also: bool = False, out=print) -> dict:
    """The record (JAX's keys); progress lines go through `out`."""
    from dorylus_tpu_torch import native
    from dorylus_tpu_torch.graph import reuse as reuse_mod
    from dorylus_tpu_torch.graph.graph import community_core_edges
    from dorylus_tpu_torch.graph.reuse import mine_reuse

    t0 = time.perf_counter()
    src, dst = community_core_edges(vertices, degree, comm=1000, core=60, seed=7)
    gen_s = time.perf_counter() - t0
    e = len(src)
    out(f"graph: {vertices} vertices, {e} edges ({gen_s:.1f}s gen)")

    if not native.has_mine_pairs():
        raise RuntimeError("bench_mine: the native pair miner (native/libgraphcore.so) did "
                           "not build or load on this host (it needs g++ with OpenMP's "
                           "libgomp; the card's host has none); this bench times it")
    t0 = time.perf_counter()
    plan = mine_reuse(src, dst, vertices, min_uses=3, passes=passes)
    native_s = time.perf_counter() - t0
    rec = {
        "edges": int(e), "vertices": vertices,
        "passes": passes,
        "native_mine_s": round(native_s, 2),
        "native_edges_per_s": round(e / native_s, 0),
        "pairs": int(plan.num_pairs),
        "row_reduction": round(plan.stats["row_reduction"], 4),
    }
    out(json.dumps(rec))

    if numpy_also:
        t0 = time.perf_counter()
        pairs, _, _, _ = reuse_mod._mine_one(src, dst, vertices, 3, 0)
        rec["numpy_one_pass_s"] = round(time.perf_counter() - t0, 2)
        rec["native_speedup"] = round(rec["numpy_one_pass_s"] / native_s, 1)
        if len(pairs) != len(plan.levels[0]):
            raise AssertionError(f"bench_mine: the numpy miner found {len(pairs)} pairs, "
                                 f"the native one {len(plan.levels[0])}")
        out(json.dumps({k: rec[k] for k in ("numpy_one_pass_s", "native_speedup")}))
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="bench_mine")
    ap.add_argument("--vertices", type=int, default=5_000_000)
    ap.add_argument("--degree", type=int, default=20)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--numpy-also", action="store_true",
                    help="also time the pure-numpy fallback (slow)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = bench(args.vertices, args.degree, args.passes, args.numpy_also,
                out=lambda line: print(line, flush=True))
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
