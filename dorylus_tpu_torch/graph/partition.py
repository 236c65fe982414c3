"""Vertex partitioning + halo (ghost) exchange plans.

The port's own copy of dorylus_tpu/graph/partition.py (`partition_graph`,
`assign_partitions`, `Shard`, `ShardedGraph`; pinned field for field by
tests/test_torch_port_copies.py), with `build_recv_plan` beside it and
without `ShardedGraph.stacked()`: the JAX package stacks every shard's
arrays on a leading axis for one SPMD program, the port runs one process
per shard and each rank keeps only its own `Shard` (`save_shard` /
`load_shard` hand a shard to its rank as one .npz file).

The reference's partition pipeline:
  - inputs/partitioner.cpp (METIS k-way vertex partition)
  - DataLoader::preprocess (dataloader.cpp:225-330): edge classification
    local/remote, ghost discovery, ghost degrees, per-edge norm factors
  - Graph's ghost maps (graph.hpp:87-98): forwardGhostMap = which local
    vertices each remote partition needs, ghost tensors receive remote
    activations each layer.

Every shard gets uniformly padded arrays (vp rows, max_h ghost slots per
peer), so the feature-table index of an edge source, vp + owner * max_h +
rank, means the same on every rank; the push-based ZMQ scatter/ghost-receiver
pair (gcn_ops.cpp:204-362) becomes one all-to-all per layer
(parallel/halo.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from dorylus_tpu_torch.common.config import TRAIN_PORTION, VAL_PORTION
from dorylus_tpu_torch.graph.graph import Graph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Shard:
    """Host-side (numpy) padded arrays for one vertex shard."""

    shard_id: int
    num_local: int  # real local vertices (<= vp)
    global_ids: np.ndarray  # (vp,) int64, -1 on padding rows
    x: np.ndarray  # (vp, F)
    onehot: np.ndarray  # (vp, C)
    src: np.ndarray  # (ep,) int32 into feature table [0, vp + n*max_h)
    dst: np.ndarray  # (ep,) int32 into [0, vp)
    edge_val: np.ndarray  # (ep,) float32; 0 on padding edges
    self_val: np.ndarray  # (vp,) float32; 0 on padding rows
    train_mask: np.ndarray  # (vp,) float32
    val_mask: np.ndarray
    test_mask: np.ndarray
    send_idx: np.ndarray  # (n_shards, max_h) int32 local rows to send to peer p
    num_edges: int  # real edge count
    num_int: int = 0  # real interior edges (src local); bnd = num_edges - num_int
    # Interior/boundary split of the same edges (overlap path): interior
    # src index local rows [0, vp); boundary src index the ghost table
    # [0, n_shards*max_h). Aggregating interior edges has no data
    # dependency on the halo all_to_all, so XLA overlaps them — the TPU
    # analog of the reference overlapping local compute with scatter.
    src_int: np.ndarray = None  # (ep_int,) int32
    dst_int: np.ndarray = None
    val_int: np.ndarray = None
    src_bnd: np.ndarray = None  # (ep_bnd,) int32 into ghosts
    dst_bnd: np.ndarray = None
    val_bnd: np.ndarray = None


@dataclass
class ShardedGraph:
    shards: List[Shard]
    n_shards: int
    vp: int  # padded local vertex count (uniform)
    ep: int  # padded local edge count (uniform)
    ep_int: int  # padded interior edge count (uniform)
    ep_bnd: int  # padded boundary edge count (uniform)
    max_h: int  # padded per-peer halo count (uniform)
    num_vertices: int  # global |V|
    num_edges: int  # global |E|
    num_classes: int
    denom: float  # |V_global| * TRAIN_PORTION


def assign_partitions(
    g: Graph,
    n_shards: int,
    method: str = "range",
    parts: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Vertex -> shard assignment.

    "range"  : contiguous blocks (the layout the reference's bsnap partition
               files induce per node once METIS parts are applied);
    "hash"   : v mod n;
    "metis"  : caller-provided parts array (e.g. read from a
               graph.bsnap.parts file written by inputs/partitioner.cpp);
    "ldg"    : native streaming greedy partitioner (native/graphcore.cpp,
               the in-repo METIS stand-in) — minimizes edge-cut by neighbor
               affinity, which directly shrinks halo traffic.
    """
    v = g.num_vertices
    if method == "metis":
        assert parts is not None and parts.shape[0] == v
        return parts.astype(np.int32)
    if method == "hash":
        return (np.arange(v) % n_shards).astype(np.int32)
    if method == "range":
        block = (v + n_shards - 1) // n_shards
        return (np.arange(v) // block).astype(np.int32)
    if method == "ldg":
        from dorylus_tpu_torch import native
        return native.ldg_partition(np.asarray(g.src), np.asarray(g.dst),
                                    v, n_shards)
    raise ValueError(f"unknown partition method {method}")


def partition_graph(
    g: Graph,
    n_shards: int,
    method: str = "range",
    parts: Optional[np.ndarray] = None,
    for_gat: bool = False,
    pad_vertices_to: int = 8,
    pad_edges_to: int = 128,
    pad_halo_to: int = 8,
) -> ShardedGraph:
    """Build uniformly-padded shards + halo exchange plan.

    Streams over the edge array a constant number of times (two stable
    sorts + per-shard slicing), unlike the reference's per-edge
    classification loop (dataloader.cpp:225-330) or this module's round-2
    version, whose per-(shard, peer) `np.unique` masks were O(n²·E) and
    could not reach the reference's 32-part Friendster configuration."""
    from dorylus_tpu_torch import native

    v_total = g.num_vertices
    n = n_shards
    part = assign_partitions(g, n_shards, method, parts)

    # Local vertex ids: one stable argsort of `part` groups vertices by
    # shard with global ids ascending inside each group (deterministic,
    # same order as the round-2 np.where construction).
    vorder = np.argsort(part, kind="stable")
    vbounds = np.searchsorted(part[vorder], np.arange(n + 1))
    local_gids = [vorder[vbounds[s]: vbounds[s + 1]] for s in range(n)]
    local_index = np.empty(v_total, np.int64)  # global -> local row
    local_index[vorder] = (np.arange(v_total)
                           - np.repeat(vbounds[:-1], np.diff(vbounds)))

    edge_owner = part[g.dst]  # edges live with their destination shard
    src_owner = part[g.src]

    # Per-shard edge slices: a stable sort by owner keeps the global CSC
    # (dst-ascending) order within each shard. Fast path: edges arrive
    # dst-ascending (Graph.finalize), so any monotone vertex->shard map
    # (range partitioning, or METIS parts applied through a renumbering)
    # makes edge_owner ALREADY sorted — eorder is the identity and every
    # per-shard "gather by e_sel" below collapses to a contiguous slice
    # (at Friendster-like scale the argsort + 5 full-array gathers are
    # ~40% of partitioning wall).
    if edge_owner.size == 0 or (np.diff(edge_owner) >= 0).all():
        eorder = None
        ebounds = np.searchsorted(edge_owner, np.arange(n + 1))
    else:
        eorder = np.argsort(edge_owner, kind="stable")
        ebounds = np.searchsorted(edge_owner[eorder], np.arange(n + 1))
    e_per_shard = np.diff(ebounds)

    # Ghost discovery in ONE pass: remote edges sorted by the composite
    # key (edge_owner, src_owner, src gid); run starts mark the unique
    # ghosts, already grouped per (receiver, owner) with gids ascending —
    # exactly the ghosts[s][p] lists of the round-2 np.unique version.
    remote_idx = np.where(edge_owner != src_owner)[0]
    key = ((edge_owner[remote_idx].astype(np.uint64) << np.uint64(44))
           | (src_owner[remote_idx].astype(np.uint64) << np.uint64(32))
           | g.src[remote_idx].astype(np.uint64))
    assert n <= (1 << 12) and v_total <= (1 << 32), "composite key width"
    rs = remote_idx[native.sort_by_key64(key)]
    r_recv = edge_owner[rs].astype(np.int64)  # needing shard
    r_own = src_owner[rs].astype(np.int64)  # owning shard
    r_gid = g.src[rs].astype(np.int64)
    new = np.ones(len(rs), bool)
    new[1:] = ((r_recv[1:] != r_recv[:-1]) | (r_own[1:] != r_own[:-1])
               | (r_gid[1:] != r_gid[:-1]))
    g_recv, g_own, g_gid = r_recv[new], r_own[new], r_gid[new]
    pair = g_recv * n + g_own
    pair_cnt = np.bincount(pair, minlength=n * n)
    max_h = int(pair_cnt.max()) if len(g_gid) else 0
    max_h = max(_round_up(max(max_h, 1), pad_halo_to), pad_halo_to)

    vp = max(int(np.diff(vbounds).max()), 1) if v_total else 1
    vp = _round_up(max(vp, 1), pad_vertices_to)
    ep = _round_up(max(int(e_per_shard.max()), 1), pad_edges_to)
    int_counts = np.bincount(edge_owner[edge_owner == src_owner],
                             minlength=n)
    bnd_counts = e_per_shard - int_counts
    ep_int = _round_up(max(int(int_counts.max()), 1), pad_edges_to)
    ep_bnd = _round_up(max(int(bnd_counts.max()), 1), pad_edges_to)

    # Feature-table index of every edge source, computed globally: local
    # sources map through local_index; remote sources land in the ghost
    # region vp + owner*max_h + (rank of gid within the receiver's ghost
    # list of that owner) — the rank falls out of the sorted run layout.
    run_start = np.zeros(n * n, np.int64)
    np.cumsum(pair_cnt[:-1], out=run_start[1:])
    ghost_rank = np.arange(len(g_gid)) - run_start[pair]
    uniq_of_edge = np.cumsum(new) - 1  # remote edge -> its unique ghost
    src_table = np.empty(g.num_edges, np.int64)
    local_edge = edge_owner == src_owner
    src_table[local_edge] = local_index[g.src[local_edge]]
    src_table[rs] = vp + r_own * max_h + ghost_rank[uniq_of_edge]

    # send_idx[s][p] = local rows (on s) that peer p needs from s =
    # the unique ghosts with (recv=p, own=s): regroup them by owner.
    sorder = np.argsort(g_own * n + g_recv, kind="stable")
    sbounds = np.searchsorted((g_own * n + g_recv)[sorder],
                              np.arange(n * n + 1))
    send_rows = local_index[g_gid[sorder]]

    train_end = int(v_total * TRAIN_PORTION)
    val_end = train_end + int(v_total * VAL_PORTION)

    feat_dim = g.features.shape[1]
    num_classes = g.num_classes

    shards: List[Shard] = []
    for s in range(n_shards):
        gids = local_gids[s]
        n_local = len(gids)

        x = np.zeros((vp, feat_dim), np.float32)
        x[:n_local] = g.features[gids]
        onehot = np.zeros((vp, num_classes), np.uint8)
        valid = g.labels[gids] >= 0
        onehot[np.arange(n_local)[valid], g.labels[gids][valid]] = 1

        gid_arr = np.full(vp, -1, np.int64)
        gid_arr[:n_local] = gids

        self_val = np.zeros(vp, np.float32)
        self_val[:n_local] = g.self_norm[gids]

        # Split follows original file-order ids (reordering-safe).
        sid = (g.split_ids[gids] if g.split_ids is not None else gids)
        masks = np.zeros((3, vp), np.float32)
        masks[0, :n_local] = (sid < train_end).astype(np.float32)
        masks[1, :n_local] = ((sid >= train_end) & (sid < val_end)).astype(np.float32)
        masks[2, :n_local] = (sid >= val_end).astype(np.float32)

        # Edges owned by this shard (already dst-ascending); the src ->
        # feature-table remap was computed globally (src_table above).
        e_sel = (slice(int(ebounds[s]), int(ebounds[s + 1]))
                 if eorder is None
                 else eorder[ebounds[s]: ebounds[s + 1]])
        n_e = int(e_per_shard[s])
        e_dst_g = g.dst[e_sel]
        e_val = (np.ones(n_e, np.float32) if for_gat
                 else g.edge_norm[e_sel])
        src_idx = src_table[e_sel]
        own = src_owner[e_sel] == s

        # Padding dst slots carry the LAST local row (vp-1), not 0, so the
        # dst-ascending invariant the sorted-segment_sum hint relies on
        # survives padding (val=0 keeps the padding numerically inert).
        src_arr = np.zeros(ep, np.int32)
        dst_arr = np.full(ep, vp - 1, np.int32)
        val_arr = np.zeros(ep, np.float32)
        src_arr[:n_e] = src_idx
        dst_arr[:n_e] = local_index[e_dst_g]
        val_arr[:n_e] = e_val

        # Interior/boundary split (overlap path).
        dst_local_all = local_index[e_dst_g]
        k_int = int(own.sum())
        k_bnd = n_e - k_int
        src_int = np.zeros(ep_int, np.int32)
        dst_int = np.full(ep_int, vp - 1, np.int32)
        val_int = np.zeros(ep_int, np.float32)
        src_int[:k_int] = src_idx[own]
        dst_int[:k_int] = dst_local_all[own]
        val_int[:k_int] = e_val[own]
        src_bnd = np.zeros(ep_bnd, np.int32)
        dst_bnd = np.full(ep_bnd, vp - 1, np.int32)
        val_bnd = np.zeros(ep_bnd, np.float32)
        src_bnd[:k_bnd] = src_idx[~own] - vp  # rebase into ghost table
        dst_bnd[:k_bnd] = dst_local_all[~own]
        val_bnd[:k_bnd] = e_val[~own]

        # send_idx[p] = local rows that peer p needs from us (= ghosts[p][s]),
        # padded by repeating row 0 (receiver never addresses padded slots).
        send = np.zeros((n_shards, max_h), np.int32)
        for p in range(n_shards):
            if p == s:
                continue
            lo, hi = sbounds[s * n + p], sbounds[s * n + p + 1]
            send[p, : hi - lo] = send_rows[lo:hi]

        shards.append(
            Shard(
                shard_id=s,
                num_local=n_local,
                global_ids=gid_arr,
                x=x,
                onehot=onehot,
                src=src_arr,
                dst=dst_arr,
                edge_val=val_arr,
                self_val=self_val,
                train_mask=masks[0],
                val_mask=masks[1],
                test_mask=masks[2],
                send_idx=send,
                num_edges=n_e,
                num_int=k_int,
                src_int=src_int, dst_int=dst_int, val_int=val_int,
                src_bnd=src_bnd, dst_bnd=dst_bnd, val_bnd=val_bnd,
            )
        )

    return ShardedGraph(
        shards=shards,
        n_shards=n_shards,
        vp=vp,
        ep=ep,
        ep_int=ep_int,
        ep_bnd=ep_bnd,
        max_h=max_h,
        num_vertices=v_total,
        num_edges=g.num_edges,
        num_classes=num_classes,
        denom=v_total * TRAIN_PORTION,
    )


def build_recv_plan(send_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side backward plan for one shard's send lists: (order, rows)
    with order a stable argsort of the flattened send_idx and rows the
    sorted local row per flat send slot. The halo backward then reduces
    returned ghost gradients with a sorted segment-sum of g[order] over
    rows — rows repeat when a local row is sent to several peers. Entries
    of -1 (send slots the caller marked as padding) sort first, for the
    caller to drop."""
    flat = np.asarray(send_idx).ravel()
    order = np.argsort(flat, kind="stable").astype(np.int32)
    return order, flat[order].astype(np.int32)


def shard_edges(shard: Shard, edges: str = "combined"
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, val) of one shard's REAL edges, no pad edge, for one edge
    set: "combined" (src into [0, vp + n * max_h)), "interior" (src local,
    into [0, vp)) or "boundary" (src rebased into the ghost rows
    [0, n * max_h)). The split is taken from the combined arrays (an edge is
    interior when its source is a local row), so it serves a shard loaded
    from its file as well; it equals `src_int[:num_int]` etc. as
    `partition_graph` lays them out (both keep the dst-ascending order)."""
    e = shard.num_edges
    src, dst, val = (np.asarray(a[:e]) for a in (shard.src, shard.dst, shard.edge_val))
    if edges == "combined":
        return src, dst, val
    vp = shard.x.shape[0]
    if edges == "interior":
        keep = src < vp
        return src[keep], dst[keep], val[keep]
    if edges == "boundary":
        keep = src >= vp
        return src[keep] - np.int32(vp), dst[keep], val[keep]
    raise ValueError(f"edges={edges!r}: \"combined\", \"interior\" or \"boundary\"")


@dataclass
class ShardMeta:
    """What a rank needs of the whole partition beside its own Shard."""

    n_shards: int
    vp: int
    ep: int  # the largest per-shard edge count, padded (kernel="auto" reads it)
    max_h: int
    num_vertices: int  # global |V|
    num_edges: int  # global |E|
    num_classes: int
    denom: float  # |V_global| * TRAIN_PORTION

    @classmethod
    def of(cls, sharded: ShardedGraph) -> "ShardMeta":
        return cls(**{f: getattr(sharded, f) for f in cls.__dataclass_fields__})


_SHARD_ARRAYS = ("global_ids", "x", "onehot", "src", "dst", "edge_val",
                 "self_val", "train_mask", "val_mask", "test_mask", "send_idx")
_SHARD_INTS = ("shard_id", "num_local", "num_edges", "num_int")


def save_shard(path, shard: Shard, meta: ShardMeta) -> None:
    """One shard and the partition's scalars as an .npz: what the parent of
    a local launch hands each rank. Edge arrays are cut to the real edges
    (a rank pads nothing); the interior/boundary split is left out
    (`shard_edges` takes it from the combined arrays)."""
    e = shard.num_edges
    arrays = {k: getattr(shard, k) for k in _SHARD_ARRAYS}
    for k in ("src", "dst", "edge_val"):
        arrays[k] = arrays[k][:e]
    scalars = {k: np.int64(getattr(shard, k)) for k in _SHARD_INTS}
    scalars.update({"meta_" + k: np.float64(v) for k, v in vars(meta).items()})
    np.savez(path, **arrays, **scalars)


def load_shard(path) -> tuple[Shard, ShardMeta]:
    with np.load(path) as z:
        shard = Shard(**{k: z[k] for k in _SHARD_ARRAYS},
                      **{k: int(z[k]) for k in _SHARD_INTS})
        meta = ShardMeta(**{
            k: (float if k == "denom" else int)(z["meta_" + k])
            for k in ShardMeta.__dataclass_fields__})
    return shard, meta
