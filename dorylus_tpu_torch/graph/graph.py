"""(The port's own copy of dorylus_tpu/graph/graph.py, plus `build_graph`;
pinned to the original by tests/test_torch_port_copies.py.)

Host-side global graph container.

The analog of the reference's RawGraph/Graph (src/graph-server/graph/graph.hpp)
before partitioning: directed edge list, per-vertex in-degrees, features and
labels, plus the GCN symmetric-normalization edge values computed exactly as
DataLoader::setEdgeNormalizations (src/graph-server/graph/dataloader.cpp:153-185):

    deg(v)      = in_degree(v) + 1              (self loop counted)
    edge (u->v) : value = deg(u)^-1/2 * deg(v)^-1/2
    self loop v : value = deg(v)^-1             (vertex "norm factor")

so the propagation matrix is S = D~^-1/2 (A + I) D~^-1/2 with D~ = D_in + I,
applied as  ah[v] = selfnorm[v]*h[v] + sum_{u->v} edgenorm(u,v) * h[u]
(Engine::aggregateGCN, engine/ops/gcn_ops.cpp:130-191).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from dorylus_tpu_torch.common.config import TRAIN_PORTION, VAL_PORTION


@dataclass
class Graph:
    num_vertices: int
    # Directed edges: message flows src -> dst (dst aggregates from src).
    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    features: Optional[np.ndarray] = None  # (V, F) float32
    labels: Optional[np.ndarray] = None  # (V,) int32 class ids
    num_classes: int = 0

    # Derived (filled by finalize()).
    in_degree: np.ndarray = field(default=None, repr=False)
    edge_norm: np.ndarray = field(default=None, repr=False)  # (E,) float32
    self_norm: np.ndarray = field(default=None, repr=False)  # (V,) float32
    # Original vertex index per (possibly reordered) vertex; the train/val/
    # test split follows these (utils.hpp:60-62 splits by file order).
    split_ids: np.ndarray = field(default=None, repr=False)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def finalize(self) -> "Graph":
        """Sort edges into CSC order (by dst) and compute degrees + GCN
        normalization values. CSC ordering mirrors the reference's
        forwardAdj layout (graph.hpp:96-98) and enables sorted segment
        sums on TPU. Uses the native graphcore library when available
        (counting sort + parallel norm computation)."""
        from dorylus_tpu_torch import native

        v = self.num_vertices
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        order = native.sort_by_dst(self.dst, v)
        self.src = self.src[order]
        self.dst = self.dst[order]
        self.in_degree, self.edge_norm, self.self_norm = native.gcn_norms(
            self.src, self.dst, v)
        return self

    # ---- split masks (src/common/utils.hpp:60-62: by global vertex index) ----

    def split_bounds(self) -> tuple[int, int]:
        train_end = int(self.num_vertices * TRAIN_PORTION)
        val_end = train_end + int(self.num_vertices * VAL_PORTION)
        return train_end, val_end

    def masks(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        train_end, val_end = self.split_bounds()
        idx = (self.split_ids if self.split_ids is not None
               else np.arange(self.num_vertices))
        return idx < train_end, (idx >= train_end) & (idx < val_end), idx >= val_end

    # ---- dense oracle helpers (for tests; mirrors miscs/check-correctness) ----

    def dense_norm_adj(self) -> np.ndarray:
        """Dense S = D~^-1/2 (A+I) D~^-1/2 for small-graph oracle checks."""
        v = self.num_vertices
        s = np.zeros((v, v), dtype=np.float64)
        np.add.at(s, (self.dst, self.src), self.edge_norm.astype(np.float64))
        s[np.arange(v), np.arange(v)] += self.self_norm.astype(np.float64)
        return s

    @staticmethod
    def make_undirected(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Add reverse edges and dedupe (the reference datasets ship directed
        edge lists; inputs/prepare treats the graph as undirected for METIS)."""
        from dorylus_tpu_torch import native

        s = np.concatenate([src, dst]).astype(np.uint64)
        d = np.concatenate([dst, src]).astype(np.uint64)
        keep = s != d  # drop explicit self loops; normalization adds them
        s, d = s[keep], d[keep]
        # Dedupe via one composite-key sort (same (src, dst) lexicographic
        # order np.unique(axis=0) produced, minus its row-view overhead —
        # the structured-dtype unique was the preprocessing wall at 100M+
        # edges).
        key = (s << np.uint64(32)) | d
        key = key[native.sort_by_key64(key)]
        new = np.ones(len(key), bool)
        new[1:] = key[1:] != key[:-1]
        key = key[new]
        return ((key >> np.uint64(32)).astype(np.int32),
                (key & np.uint64(0xFFFFFFFF)).astype(np.int32))


def synthetic_graph(
    num_vertices: int,
    avg_degree: int,
    feature_dim: int,
    num_classes: int,
    seed: int = 0,
    planted: bool = True,
) -> Graph:
    """Random graph with (optionally) planted class structure so that
    training has signal; used for tests/benchmarks when the real datasets
    aren't on disk (analog of miscs/generate-dataset).

    DENSITY NOTE: avg_degree counts the DIRECTED edges generated before
    make_undirected doubles them — the finished graph has ~2*avg_degree
    in-degree. clustered_synthetic_graph pre-halves instead (its finished
    in-degree ~= avg_degree), so cross-generator comparisons at the same
    parameter compare ~2x different densities. Kept as-is deliberately:
    halving here would silently change every committed golden fixture,
    plan shape and benchmark graph built on this generator."""
    rng = np.random.default_rng(seed)
    v = num_vertices
    e = num_vertices * avg_degree
    labels = rng.integers(0, num_classes, size=v).astype(np.int32)

    if planted:
        # Homophilous edges: half within class, half uniform.
        order = np.argsort(labels, kind="stable")
        by_class = [order[labels[order] == c] for c in range(num_classes)]
        n_intra = e // 2
        srcs, dsts = [], []
        cls = rng.integers(0, num_classes, size=n_intra)
        for c in range(num_classes):
            members = by_class[c]
            if len(members) < 2:
                continue
            k = int((cls == c).sum())
            srcs.append(members[rng.integers(0, len(members), size=k)])
            dsts.append(members[rng.integers(0, len(members), size=k)])
        n_rand = e - sum(len(x) for x in srcs)
        srcs.append(rng.integers(0, v, size=n_rand).astype(np.int64))
        dsts.append(rng.integers(0, v, size=n_rand).astype(np.int64))
        src = np.concatenate(srcs).astype(np.int32)
        dst = np.concatenate(dsts).astype(np.int32)
    else:
        src = rng.integers(0, v, size=e).astype(np.int32)
        dst = rng.integers(0, v, size=e).astype(np.int32)

    src, dst = Graph.make_undirected(src, dst)

    feats = rng.normal(0, 1, size=(v, feature_dim)).astype(np.float32)
    if planted:
        # Class-dependent feature shift.
        centers = rng.normal(0, 1, size=(num_classes, feature_dim)).astype(np.float32)
        feats += 0.5 * centers[labels]

    g = Graph(
        num_vertices=v,
        src=src,
        dst=dst,
        features=feats,
        labels=labels,
        num_classes=num_classes,
    )
    return g.finalize()


def clustered_synthetic_graph(
    num_vertices: int,
    avg_degree: int,
    feature_dim: int,
    num_classes: int,
    seed: int = 0,
    window: int = 4096,
    cut: float = 0.1,
) -> Graph:
    """Locality-structured random graph: each edge stays within ±window/2 of
    its endpoint with probability 1-cut, else lands uniformly. This is the
    shape a METIS-partitioned real-world graph presents to a range
    partitioner (the reference's inputs/partitioner.cpp exists precisely to
    expose such small edge-cuts — Reddit/Amazon cuts are ~5-15%); a
    uniform-random graph has edge-cut (n-1)/n and NO partitioner can fix it,
    so it is the wrong stand-in for scaling studies."""
    rng = np.random.default_rng(seed)
    v = num_vertices
    e = num_vertices * avg_degree // 2  # make_undirected doubles
    dst = rng.integers(0, v, size=e).astype(np.int64)
    local = rng.random(e) >= cut
    off = rng.integers(-window // 2, window // 2 + 1, size=e)
    src = np.where(local, (dst + off) % v, rng.integers(0, v, size=e))
    src, dst = Graph.make_undirected(src.astype(np.int32), dst.astype(np.int32))
    labels = ((np.arange(v) * num_classes) // v).astype(np.int32)
    feats = rng.normal(0, 1, size=(v, feature_dim)).astype(np.float32)
    centers = rng.normal(0, 1, size=(num_classes, feature_dim)).astype(np.float32)
    feats += 0.5 * centers[labels]
    g = Graph(num_vertices=v, src=src, dst=dst, features=feats,
              labels=labels, num_classes=num_classes)
    return g.finalize()


def community_core_edges(v: int, deg: int, comm: int = 500, core: int = 80,
                         p_core: float = 0.8, seed: int = 0):
    """Community-core edge list: each vertex draws most in-neighbors
    Zipf-weighted from its community's small popular core. This is the
    real-social-graph shape where neighbor LISTS overlap (distinct from
    clustered_synthetic_graph's locality-without-overlap), i.e. the
    workload HAG-style pair reuse (graph/reuse.py) was designed for; a
    uniform-random graph yields ~no repeated pairs by construction.
    Returns (src, dst) int32, dst-ascending (CSC)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, core + 1) ** 0.9
    w /= w.sum()
    dst = np.repeat(np.arange(v, dtype=np.int64), deg)
    base = (dst // comm) * comm
    pick_core = rng.random(len(dst)) < p_core
    core_idx = rng.choice(core, size=len(dst), p=w)
    rand_idx = rng.integers(0, comm, size=len(dst))
    src = base + np.where(pick_core, core_idx, rand_idx)
    src = np.minimum(src, v - 1)
    keep = src != dst
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    o = np.argsort(dst, kind="stable")
    return src[o], dst[o]


def build_graph(num_vertices: int, avg_degree: int, feature_dim: int,
                num_classes: int, seed: int = 0) -> Graph:
    """Random directed graph in CSC order, without the O(E log E) dedup of
    synthetic_graph (benchmark scale): the port's copy of the JAX package's
    bench.py `build_graph`, same random stream, same graph."""
    rng = np.random.default_rng(seed)
    e = num_vertices * avg_degree
    src = rng.integers(0, num_vertices, size=e, dtype=np.int64).astype(np.int32)
    dst = rng.integers(0, num_vertices, size=e, dtype=np.int64).astype(np.int32)
    g = Graph(
        num_vertices=num_vertices, src=src, dst=dst,
        features=rng.normal(0, 1, size=(num_vertices, feature_dim)).astype(np.float32),
        labels=rng.integers(0, num_classes, size=num_vertices).astype(np.int32),
        num_classes=num_classes,
    )
    return g.finalize()
