"""ctypes bindings for the native graphcore library (native/graphcore.cpp).

Auto-builds on first use when g++ is available; every entry point has a
pure-numpy fallback so the framework works without the native library
(slower preprocessing only — device compute is unaffected).

The port's own copy of dorylus_tpu/native.py; it builds and loads the same
native/libgraphcore.so (native/ is no part of the JAX package).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libgraphcore.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # Rebuild when the source is NEWER than the .so, not just when the
    # .so is missing — a stale binary silently serves old semantics
    # (and the arch-specific -march=native build is .gitignored, so a
    # fresh clone always builds for its own host).
    src_path = _NATIVE_DIR / "graphcore.cpp"
    try:
        stale = (not _LIB_PATH.exists()
                 or (src_path.exists()
                     and src_path.stat().st_mtime
                     > _LIB_PATH.stat().st_mtime))
    except OSError:
        stale = not _LIB_PATH.exists()
    if stale:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not _LIB_PATH.exists():
                return None  # no compiler, no binary -> numpy fallbacks
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.gc_sort_by_dst.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p]
    lib.gc_gcn_norms.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                 i64p, f32p, f32p]
    lib.gc_sort_by_key64.argtypes = [u64p, ctypes.c_int64, i64p]
    lib.gc_ldg_partition.argtypes = [i64p, i32p, ctypes.c_int32,
                                     ctypes.c_int32, i32p]
    lib.gc_refine_partition.argtypes = [i64p, i32p, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_double, i32p]
    lib.gc_version.restype = ctypes.c_int32
    if lib.gc_version() >= 2:
        lib.gc_parse_edges.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       i32p, i32p]
        lib.gc_parse_edges.restype = ctypes.c_int64
    if lib.gc_version() >= 3:
        lib.gc_mine_pairs.argtypes = [i32p, i32p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int64, i32p, i32p,
                                      i32p, i32p, i64p]
        lib.gc_mine_pairs.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def sort_by_dst(dst: np.ndarray, num_v: int) -> np.ndarray:
    """Stable counting-sort permutation ordering edges by dst (CSC)."""
    lib = _load()
    dst = np.ascontiguousarray(dst, np.int32)
    if lib is None:
        return np.argsort(dst, kind="stable")
    order = np.empty(len(dst), np.int64)
    lib.gc_sort_by_dst(_ptr(dst, ctypes.c_int32), len(dst), num_v,
                       _ptr(order, ctypes.c_int64))
    return order


def gcn_norms(src: np.ndarray, dst: np.ndarray, num_v: int):
    """(in_degree, edge_norm, self_norm) per dataloader.cpp:153-185."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if lib is None:
        deg = np.bincount(dst, minlength=num_v).astype(np.int64)
        inv_sqrt = (deg + 1.0) ** -0.5
        return deg, (inv_sqrt[src] * inv_sqrt[dst]).astype(np.float32), \
            ((deg + 1.0) ** -1.0).astype(np.float32)
    deg = np.empty(num_v, np.int64)
    edge_norm = np.empty(len(src), np.float32)
    self_norm = np.empty(num_v, np.float32)
    lib.gc_gcn_norms(_ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
                     len(src), num_v, _ptr(deg, ctypes.c_int64),
                     _ptr(edge_norm, ctypes.c_float),
                     _ptr(self_norm, ctypes.c_float))
    return deg, edge_norm, self_norm


def sort_by_key64(key: np.ndarray) -> np.ndarray:
    """Stable ascending permutation for uint64 composite keys."""
    lib = _load()
    key = np.ascontiguousarray(key, np.uint64)
    if lib is None:
        return np.argsort(key, kind="stable")
    order = np.empty(len(key), np.int64)
    lib.gc_sort_by_key64(_ptr(key, ctypes.c_uint64), len(key),
                         _ptr(order, ctypes.c_int64))
    return order


def parse_edges(path) -> tuple[np.ndarray, np.ndarray]:
    """Text snap edge list -> (src, dst): skip '#'/'%' comment lines, first
    two integer columns, drop self loops and malformed lines
    (inputs/graphToBinary.cpp readFile semantics). Native path mmaps the
    file and parses newline-aligned chunks in parallel; fallback is the
    line loop (graph/dataio.py) at ~3 MB/s."""
    lib = _load()
    if lib is None or lib.gc_version() < 2:
        from dorylus_tpu_torch.graph.dataio import _read_text_edges_py
        return _read_text_edges_py(path)
    import mmap
    with open(Path(path), "rb") as f:
        length = f.seek(0, 2)
        if length == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        buf = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    try:
        view = np.frombuffer(buf, np.uint8)  # readonly view of the mmap
        # Upper bound on edges = line count (newlines + a possible last
        # unterminated line). Counted in chunks: a whole-file boolean
        # temporary would transiently double RAM on multi-GB edge lists.
        chunk = 1 << 26
        cap = 1 + sum(int((view[i:i + chunk] == 10).sum())
                      for i in range(0, length, chunk))
        src = np.empty(cap, np.int32)
        dst = np.empty(cap, np.int32)
        n = lib.gc_parse_edges(ctypes.c_void_p(view.ctypes.data), length,
                               _ptr(src, ctypes.c_int32),
                               _ptr(dst, ctypes.c_int32))
        return src[:n].copy(), dst[:n].copy()
    finally:
        del view
        buf.close()


def has_mine_pairs() -> bool:
    lib = _load()
    return lib is not None and lib.gc_version() >= 3


def mine_pairs_native(src: np.ndarray, dst: np.ndarray, table_size: int,
                      min_uses: int, max_pairs: int):
    """One native pair-mining pass (graph/reuse.py _mine_one semantics):
    returns (pairs (P, 2) int64, src2, dst2, stats). Requires
    has_mine_pairs(); ~70 s of numpy lexsort passes at 24 M edges run in
    a few seconds of parallel C++ (native/graphcore.cpp gc_mine_pairs)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    e = len(src)
    pair_a = np.empty(e // 3 + 1, np.int32)
    pair_b = np.empty(e // 3 + 1, np.int32)
    src2 = np.empty(e, np.int32)
    dst2 = np.empty(e, np.int32)
    out = np.zeros(3, np.int64)
    p = lib.gc_mine_pairs(_ptr(src, ctypes.c_int32),
                          _ptr(dst, ctypes.c_int32), e, table_size,
                          min_uses, max_pairs,
                          _ptr(pair_a, ctypes.c_int32),
                          _ptr(pair_b, ctypes.c_int32),
                          _ptr(src2, ctypes.c_int32),
                          _ptr(dst2, ctypes.c_int32),
                          _ptr(out, ctypes.c_int64))
    e2, uses, candidates = int(out[0]), int(out[1]), int(out[2])
    pairs = np.stack([pair_a[:p].astype(np.int64),
                      pair_b[:p].astype(np.int64)], axis=1)
    stats = {"candidates": candidates, "pairs": int(p), "uses": uses,
             "rows_saved": uses - 2 * int(p)}
    return pairs, src2[:e2].copy(), dst2[:e2].copy(), stats


def ldg_partition(src: np.ndarray, dst: np.ndarray, num_v: int,
                  k: int, refine_iters: int = 8,
                  slack: float = 0.05) -> np.ndarray:
    """Streaming greedy (LDG) k-way partition — the METIS stand-in —
    followed by `refine_iters` restreaming refinement passes (each vertex
    moves to its highest-affinity part when that reduces its cut edges,
    capacity-bounded at num_v/k*(1+slack)). On a scrambled clustered test
    graph the refinement takes the cut from 0.49 to ~0.15; METIS-quality
    parts files still load via partition method "metis"."""
    lib = _load()
    # Build CSR over the undirected neighborhood (dst-sorted adjacency)
    # via the module's own O(E) counting sort — np.argsort here was an
    # O(E log E) single-threaded wall in exactly the big-graph path this
    # partitioner exists for.
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    order = sort_by_dst(d, num_v)
    col = s[order]
    counts = np.bincount(d, minlength=num_v)
    row_ptr = np.zeros(num_v + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if lib is None:
        # Greedy fallback (same algorithm, pure python — fine for tests).
        parts = np.full(num_v, -1, np.int32)
        size = np.zeros(k, np.int64)
        cap = num_v / k + 1.0
        for v in range(num_v):
            neigh = col[row_ptr[v]: row_ptr[v + 1]]
            neigh = neigh[parts[neigh] >= 0] if len(neigh) else neigh
            score = np.bincount(parts[neigh], minlength=k).astype(np.float64) \
                if len(neigh) else np.zeros(k)
            s_adj = (score + 1e-9) * (1.0 - size / cap)
            best = int(np.argmax(s_adj))
            parts[v] = best
            size[best] += 1
        rcap = int(num_v / k * (1.0 + slack)) + 1
        for _ in range(refine_iters):
            moved = 0
            for v in range(num_v):
                neigh = col[row_ptr[v]: row_ptr[v + 1]]
                if not len(neigh):
                    continue
                score = np.bincount(parts[neigh], minlength=k)
                cur = parts[v]
                # Mirror gc_refine_partition: among parts WITH ROOM, move
                # to the highest-affinity one when it strictly beats cur
                # (a full top-affinity part must not block a second-best
                # move that still improves the cut).
                open_score = np.where(size < rcap, score, -1)
                cand = int(np.argmax(open_score))
                if open_score[cand] > score[cur]:
                    size[cur] -= 1
                    size[cand] += 1
                    parts[v] = cand
                    moved += 1
            if not moved:
                break
        return parts
    col = np.ascontiguousarray(col, np.int32)
    parts = np.empty(num_v, np.int32)
    lib.gc_ldg_partition(_ptr(row_ptr, ctypes.c_int64),
                         _ptr(col, ctypes.c_int32), num_v, k,
                         _ptr(parts, ctypes.c_int32))
    if refine_iters:
        lib.gc_refine_partition(_ptr(row_ptr, ctypes.c_int64),
                                _ptr(col, ctypes.c_int32), num_v, k,
                                refine_iters, slack,
                                _ptr(parts, ctypes.c_int32))
    return parts

