"""Redundancy-free aggregation: common neighbor-PAIR reuse (HAG-style).

The port's own copy of dorylus_tpu/graph/reuse.py (numpy and the native
miner only; the jax table builder is left out), pinned to the original by
tests/test_torch_port_copies.py.

On real graphs neighbor lists overlap heavily; a pair of vertices (a, b)
that appears in many destinations' neighbor lists can be aggregated ONCE
into a pair row h[a] + h[b] appended to the gather table, and every
destination that contains the pair gathers one row instead of two.

This is exact (not an approximation) whenever the inner aggregation is
UNIT-WEIGHT, which both production models satisfy by construction:

  * GCN: edge values factor as f(src) * f(dst) with f = (deg+1)^-1/2
    (graph/dataio norms, reference dataloader.cpp:153-185) — pre-scale
    the table rows by f, aggregate unit-weight, post-scale rows by
    f(dst). (The self loop is applied outside the kernel already.)
  * GAT (Dorylus attention): edge weight = att[dst] only
    (funcs/gat/ops/forward_ops.cpp:109-141, our dst-functional kernel) —
    factors out of each destination's sum identically.

Because the rewrite computes exactly the same linear operator, the
BACKWARD of a rewritten forward is the original transposed operator —
which gets its own independently-mined rewrite. No scatter ops anywhere.

Mining (host-side, one lexsort + vectorized passes):
  1. sort edges by (dst, src); every consecutive same-dst position i is
     a candidate pair (src[i], src[i+1]);
  2. count candidate keys; keep pairs appearing >= min_uses times;
  3. greedy non-overlapping take: within each run of consecutive
     selected candidates take alternating positions (two taken pairs
     may not share an edge);
  4. re-count TAKEN uses and drop pairs whose taken count no longer
     clears min_uses (a selected pair can lose occurrences to overlap);
  5. rewrite: consumed edge pairs are replaced by one edge from the
     pair's table id (>= num_vertices); optional further passes mine
     pairs-of-pairs on the rewritten list (hierarchical reuse).

Net gathered rows change = -(taken uses) + (2 * pairs kept for the
build gather), so min_uses >= 3 guarantees a row win on every pair.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ReusePlan:
    """Rewritten edge list + pair-build levels for one direction."""

    levels: list  # list of (P_k, 2) int32 — indices into the growing table
    src: np.ndarray  # (E',) int32 table ids (>= num_vertices = pair rows)
    dst: np.ndarray  # (E',) int32 original vertex ids, ascending (CSC)
    num_vertices: int
    table_size: int  # num_vertices + total pairs
    stats: dict = field(default_factory=dict)

    @property
    def num_pairs(self) -> int:
        return self.table_size - self.num_vertices

    def build_table_np(self, h: np.ndarray) -> np.ndarray:
        tbl = h
        for p in self.levels:
            tbl = np.concatenate([tbl, tbl[p[:, 0]] + tbl[p[:, 1]]])
        return tbl


def _mine_one(src: np.ndarray, dst: np.ndarray, table_size: int,
              min_uses: int, max_pairs: int):
    """One mining pass. Returns (pairs (P,2) int64, src', dst', stats)."""
    e = len(src)
    if e < 2:
        return np.zeros((0, 2), np.int64), src, dst, {"candidates": 0}
    order = np.lexsort((src, dst))
    s = src[order]
    d = dst[order]
    cand = (d[:-1] == d[1:])  # same destination, consecutive in src order
    keys = s[:-1].astype(np.int64) * table_size + s[1:]
    uniq, inv, cnt = np.unique(np.where(cand, keys, -1),
                               return_inverse=True, return_counts=True)
    sel = (cnt >= min_uses) & (uniq >= 0)
    if max_pairs and int(sel.sum()) > max_pairs:
        # Keep the highest-count pairs.
        csel = np.where(sel, cnt, 0)
        thresh = np.partition(csel, -max_pairs)[-max_pairs]
        sel &= cnt >= max(thresh, min_uses)
        over = int(sel.sum()) - max_pairs
        if over > 0:  # break count ties arbitrarily
            at = np.flatnonzero(sel & (cnt == thresh))[:over]
            sel[at] = False
    flag = cand & sel[inv]
    if not flag.any():
        # Return the SORTED copy: callers (ReuseSpMM et al.) feed the
        # rewritten list straight into build_hyb_plan, which requires CSC
        # (dst-ascending) order — the native miner sorts its output in
        # this case too, and returning the raw input here silently
        # corrupted gradients when a direction mined zero pairs.
        return (np.zeros((0, 2), np.int64), s, d,
                {"candidates": int(cand.sum()), "pairs": 0})

    # Greedy non-overlap: alternate within each maximal run of flags.
    start = flag & ~np.concatenate([[False], flag[:-1]])
    run_id = np.cumsum(start) - 1
    run_starts = np.flatnonzero(start)
    idx = np.arange(len(flag))
    pos = np.where(flag, idx - run_starts[np.maximum(run_id, 0)], 0)
    take = flag & (pos % 2 == 0)

    # Drop pairs whose TAKEN count fell below a profitable threshold
    # (>= 3 uses nets at least one row after the 2-row build cost).
    floor = max(min_uses, 3)
    tcnt = np.bincount(inv[take], minlength=len(uniq))
    good = tcnt >= floor
    take &= good[inv]
    kept = np.flatnonzero(good & sel)
    if len(kept) == 0:
        return (np.zeros((0, 2), np.int64), s, d,  # sorted (see above)
                {"candidates": int(cand.sum()), "pairs": 0})
    pair_of_key = np.full(len(uniq), -1, np.int64)
    pair_of_key[kept] = np.arange(len(kept))
    pairs = np.stack([uniq[kept] // table_size, uniq[kept] % table_size], 1)

    tpos = np.flatnonzero(take)
    consumed = np.zeros(e, bool)
    consumed[tpos] = True
    consumed[tpos + 1] = True
    src2 = np.concatenate([s[~consumed],
                           table_size + pair_of_key[inv[tpos]]])
    dst2 = np.concatenate([d[~consumed], d[tpos]])
    o2 = np.argsort(dst2, kind="stable")
    stats = {"candidates": int(cand.sum()), "pairs": len(kept),
             "uses": int(take.sum()),
             "rows_saved": int(take.sum()) - 2 * len(kept)}
    return pairs, src2[o2].astype(src.dtype), dst2[o2].astype(dst.dtype), stats


def mine_reuse(src: np.ndarray, dst: np.ndarray, num_vertices: int,
               min_uses: int = 4, passes: int = 1,
               max_pairs: int = 0) -> ReusePlan:
    """Mine pair reuse for edges src->dst (dst aggregates). Requires
    nothing of the input order; output dst is ascending (CSC)."""
    from dorylus_tpu_torch import native

    src = np.asarray(src)
    dst = np.asarray(dst)
    e0 = len(src)
    table_size = num_vertices
    levels = []
    stats = {"passes": [], "rows_before": e0}
    s, d = src, dst
    # The native miner (graphcore.cpp gc_mine_pairs) runs the same passes
    # in parallel C++: ~70-80 s of numpy lexsorts at 24 M edges drop to a
    # few seconds — the difference between a toy lever and one that
    # reaches 100 M-edge production graphs.
    miner = (native.mine_pairs_native if native.has_mine_pairs()
             else _mine_one)
    for _ in range(max(1, passes)):
        pairs, s, d, st = miner(s, d, table_size, min_uses,
                                max_pairs or 0)
        stats["passes"].append(st)
        if len(pairs) == 0:
            break
        levels.append(pairs.astype(np.int32))
        table_size += len(pairs)
    total_pairs = table_size - num_vertices
    stats["rows_after"] = len(s) + 2 * total_pairs
    stats["row_reduction"] = 1.0 - stats["rows_after"] / max(1, e0)
    return ReusePlan(levels=levels, src=s.astype(np.int32),
                     dst=d.astype(np.int32), num_vertices=num_vertices,
                     table_size=table_size, stats=stats)
