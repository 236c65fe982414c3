"""(The port's own copy of dorylus_tpu/graph/reorder.py, pinned to the
original by tests/test_torch_port_copies.py.)

Vertex reordering for locality.

The reference gets locality from METIS partitioning (inputs/partitioner.cpp)
and otherwise keeps file order. On TPU, locality buys smaller edge-cuts
under the range partitioner — and therefore smaller halo exchanges — the
role METIS plays for the reference. It does NOT speed the aggregation
gather itself: tools/probe_roofline.py measured the XLA gather at a
pattern-independent ~85 GB/s (random == sorted == local-window indices).

These reorderings are optional preprocessing; the train/val/test split
stays bound to the ORIGINAL vertex indices (src/common/utils.hpp:60-62
splits by file order), carried in Graph.split_ids.
"""

from __future__ import annotations

import numpy as np

from dorylus_tpu_torch.graph.graph import Graph


def bfs_order(g: Graph) -> np.ndarray:
    """Cuthill-McKee-like BFS ordering: order[new_id] = old_id.

    Queue-discipline BFS from a lowest-degree root: each frontier is
    emitted sorted by the emission position of the parent that discovered
    it, so children land next to their parents and communities stay
    contiguous (a plain level-by-level BFS loses this — levels of a
    small-diameter graph span the whole vertex set). Vectorized over whole
    frontiers: Reddit-scale graphs (233k vertices, 11M edges) reorder in
    seconds."""
    v = g.num_vertices
    # Undirected adjacency in CSR.
    s = np.concatenate([g.src, g.dst])
    d = np.concatenate([g.dst, g.src])
    o = np.argsort(d, kind="stable")
    col = s[o]
    counts = np.bincount(d, minlength=v)
    ptr = np.zeros(v + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])

    visited = np.zeros(v, bool)
    order = np.empty(v, np.int64)
    pos = 0
    deg_order = np.argsort(counts, kind="stable")  # low-degree roots first
    root_at = 0
    frontier = np.empty(0, np.int64)
    while pos < v:
        if frontier.size == 0:
            while visited[deg_order[root_at]]:
                root_at += 1
            frontier = deg_order[root_at: root_at + 1]
            visited[frontier] = True
        order[pos: pos + frontier.size] = frontier
        pos += frontier.size
        # Expand the whole frontier at once: slice lengths differ, so build
        # a flat neighbor list via repeat + cumulative offsets; each
        # neighbor keeps the rank of the parent that reached it.
        lens = ptr[frontier + 1] - ptr[frontier]
        total = int(lens.sum())
        if total == 0:
            frontier = np.empty(0, np.int64)
            continue
        starts = np.repeat(ptr[frontier], lens)
        within = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(lens[:-1])]), lens)
        neigh = col[starts + within]
        rank = np.repeat(np.arange(frontier.size), lens)
        keep = ~visited[neigh]
        neigh, rank = neigh[keep], rank[keep]
        if neigh.size == 0:
            frontier = np.empty(0, np.int64)
            continue
        # Dedupe keeping each vertex's FIRST (lowest-rank) discoverer, then
        # emit in parent-rank order — the queue discipline of classic RCM.
        sel = np.lexsort((rank, neigh))
        neigh, rank = neigh[sel], rank[sel]
        first = np.r_[True, neigh[1:] != neigh[:-1]]
        neigh, rank = neigh[first], rank[first]
        visited[neigh] = True
        frontier = neigh[np.argsort(rank, kind="stable")]
    assert pos == v
    return order


def degree_order(g: Graph, ascending: bool = False) -> np.ndarray:
    """Degree ordering. Descending clusters hubs; ASCENDING makes the
    hybrid-ELL kernel's bucket layout the identity permutation
    (ops/hyb_spmm.py build_hyb_plan "_n_iso"), dropping its output
    (V, F) gather — on undirected graphs (in-deg == out-deg) the forward
    AND backward plans both collapse."""
    key = g.in_degree if ascending else -g.in_degree
    return np.argsort(key, kind="stable")


def apply_order(g: Graph, order: np.ndarray) -> Graph:
    """Relabel vertices: new_id i corresponds to old order[i]. The split
    keeps following original indices via split_ids."""
    v = g.num_vertices
    inv = np.empty(v, np.int64)
    inv[order] = np.arange(v)
    old_split = g.split_ids if g.split_ids is not None else np.arange(v)
    out = Graph(
        num_vertices=v,
        src=inv[g.src].astype(np.int32),
        dst=inv[g.dst].astype(np.int32),
        features=None if g.features is None else g.features[order],
        labels=None if g.labels is None else g.labels[order],
        num_classes=g.num_classes,
    )
    out.split_ids = old_split[order]
    return out.finalize()
