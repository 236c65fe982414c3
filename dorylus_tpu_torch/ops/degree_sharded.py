"""Sharded degree-padded SpMM: one rank's degree plans over its vertex shard
(port of dorylus_tpu/ops/degree_sharded.py, `kernel="degree"` on the
sharded engine).

Three edge sets, as in JAX:

  * edges="combined": every edge of the shard; the table is
    `halo_exchange`'s [local h | ghost rows], vp + n * max_h rows;
  * edges="interior": the edges whose source is a local row; table = the
    local h (vp rows);
  * edges="boundary": the ghost-sourced edges; table = the received ghost
    rows alone (n * max_h rows, sources rebased into them).

The (interior, boundary) pair is the halo-overlap path of the degree
kernel: the interior pass reads no ghost row, so it does not depend on the
exchange; the models add the two outputs (models/gcn.py, models/gat.py).
Each op is a `DegreeSpMM` over that edge set, so the entries (`apply`,
`apply_static`, `apply_dst`, `apply_unit`), their backward order and the
kernels are the single-device ones: on the card a plan is one hub part of
K1 (static), K2 (unit/dst) or K7 (dynamic); CPU tensors take
`degree_pass_plain` (ops/degree_spmm.py). An edge set may be empty on a
rank (a shard without boundary edges): the passes then return zeros of the
right shape without a launch, and the backward still hands the exchange a
defined zero gradient, so every rank enters the reverse all-to-all.

What the port leaves out of the JAX module: `_stack_uniform`, the pad-edge
liveness recount, `row_chunk` and the out-block maps. The first two pad
every shard's plan to one shape and silence the pad edges, because
shard_map stacks the shards under one program; here a rank owns its plan,
built over the shard's REAL edges, so no pad edge exists. The last two are
TPU memory guards (ROADMAP.md "Not to port").
"""

from __future__ import annotations

import torch

from dorylus_tpu_torch.common.device import resolve_device
from dorylus_tpu_torch.graph.partition import Shard, shard_edges
from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM


class ShardedDegreeSpMM(DegreeSpMM):
    """One rank's degree plans over one edge set of its shard (JAX:
    ops/degree_sharded.ShardedDegreeSpMM, one slice of its stacked arrays).

    shard: the rank's `Shard`; n: the number of shards. static_vals: bake
    the shard's edge values (the GCN norms) into the plans for
    `apply_static`; without them `apply(table, val)` takes this edge set's
    values ((E_set,), in the set's edge order) and `apply_dst` /
    `apply_unit` weigh by destination or by 1.

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu"."""

    def __init__(self, shard: Shard, n: int, edges: str = "combined", block: int = 16,
                 static_vals: bool = False, gather_dtype: torch.dtype | None = None,
                 device: str | torch.device | None = None):
        device = resolve_device(device)
        src, dst, val = shard_edges(shard, edges)
        vp, max_h = int(shard.x.shape[0]), int(shard.send_idx.shape[1])
        table = {"combined": vp + n * max_h, "interior": vp, "boundary": n * max_h}[edges]
        super().__init__(src, dst, table, vp, block=block, gather_dtype=gather_dtype,
                         static_val=val if static_vals else None, device=device)
        self.edges, self.vp, self.table = edges, vp, table
        self.num_edges = len(src)
