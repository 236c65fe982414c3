"""The two axes of the sharded engine over one joined process group (port of
dorylus_tpu/parallel/mesh.py).

JAX lays its devices out as a (graph, feat) mesh, `reshape(n, m)`; here
each rank is one process and the mesh is two families of process groups
over the world of n * m ranks:

  * 'graph': vertex shards (partition, halo exchange, the loss and the
    evaluation sums). Rank r sits in graph shard r // m; the ranks of one
    graph group share a feat index and hold the n shards;
  * 'feat': tensor parallelism (models/gcn.py, models/gat.py
    `_forward_tp`): rank r sits at feat index r % m; the m ranks of one
    feat group hold the same shard and each aggregates an F/m column slice
    of the feature table, the layer matmul's partial products summed over
    the group.

Weight gradients are summed over the world (both axes). Every rank calls
`dist.new_group` for every group in the same order (the collective that
creates a group needs every rank of the world, members or not).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch.distributed as dist

from dorylus_tpu_torch.parallel import multihost


class Mesh(NamedTuple):
    """This rank's place in the (graph, feat) mesh. A group is None where
    the axis is the whole world (no group was made) and nothing crosses it
    when its size is 1."""

    n_shards: int  # graph shards, n
    feat_shards: int  # feat shards, m
    graph_index: int  # this rank's shard: rank // m
    feat_index: int  # this rank's column slice: rank % m
    graph_group: Optional[object]  # the n ranks holding this feat index
    feat_group: Optional[object]  # the m ranks holding this shard


def make_mesh(n_shards: Optional[int] = None, feat_shards: int = 1) -> Mesh:
    """The mesh over the joined world (or one rank without a process group):
    n_shards graph shards by feat_shards feat shards, n_shards None meaning
    world // feat_shards. A world that is not n * m raises ValueError (JAX:
    the mesh's feat axis does not match). With m = 1 the graph group is the
    world and no group is made."""
    world, me = multihost.world_size(), multihost.rank()
    m = max(1, int(feat_shards))
    n = int(n_shards) if n_shards else world // m
    if n < 1 or n * m != world:
        raise ValueError(f"a mesh of {n_shards or '?'} graph x {m} feat shards needs "
                         f"n * m ranks; the world has {world} (feat axis of size {m} "
                         "does not fit)")
    if m == 1:
        return Mesh(n, 1, me, 0, None, None)
    graph_group = feat_group = None
    for i in range(n):  # the feat groups: one per shard
        grp = dist.new_group(ranks=[i * m + j for j in range(m)])
        if i == me // m:
            feat_group = grp
    for j in range(m):  # the graph groups: one per feat index
        grp = dist.new_group(ranks=[i * m + j for i in range(n)])
        if j == me % m:
            graph_group = grp
    return Mesh(n, m, me // m, me % m, graph_group, feat_group)
