"""Sharded pair-reuse SpMM: one rank's pair rewrite over its shard's
post-halo feature table (port of dorylus_tpu/ops/reuse_sharded.py,
`kernel="hyb", reuse="pairs"` on the sharded engine).

Each rank mines pairs over ITS OWN real edges. The sources index the table
`halo_exchange` returns ([local h | ghost rows], vp + n * max_h rows; vp
rows on one graph shard, which has no halo), so a
pair row combines two rows this rank already holds after the exchange, a
local and a ghost row included, and no other rank is asked for anything.
That is also why reuse runs on the combined table only: a pair may span the
interior/boundary split, so the engine turns the overlap plans off.

The op is `ReuseSpMM` (ops/reuse_spmm.py) over the (vp, vp + n * max_h)
operator of the shard: the forward is mined over (src -> dst) with the pair
ids starting at vp + n * max_h, the backward over the transpose with base
vp, both with the package's one miner (graph/reuse.py), so both packages
mine the same rewrite from the same edges; then the mask plans over the two
rewrites. On the card: K6 builds the pair rows, K2 runs the pass.

GCN rides the rank-1 norm factorisation f(src) f(dst), f = sqrt(self_norm):
the table is pre-scaled by `f_in` (vp + n * max_h,) and the output
post-scaled by `f_out` (vp,). The ghost entries of f_in are the REMOTE
vertices' factors, which this rank does not hold: the engine fetches them
once, before it builds the op, by exchanging the local factor as a one-column
table over its halo plan (`exchange_rank1_factor`), a collective every rank
enters (the JAX package
assembles them on the host from every shard's send lists). Slots past a
pair's exact ghost count stay 0 where JAX repeats the owner's row 0; no
edge reads them.

Not ported, being shard_map uniformity only: `_pad_edges`,
`_padded_level_sizes`, `_remap_pair_ids`, `_pad_levels` and the pooled
width DP (they pad every shard's levels and rewritten edges to one shape);
and `set_msgs_budget` (a TPU scan-chunk guard; ROADMAP.md "Not to port").
"""

from __future__ import annotations

import numpy as np
import torch

from dorylus_tpu_torch.common.device import resolve_device
from dorylus_tpu_torch.graph.partition import Shard, shard_edges
from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM


def exchange_rank1_factor(f_local: np.ndarray, halo_plan) -> np.ndarray:
    """The table's rank-1 factor (vp + n * max_h,) of one rank: its local
    factor, then what each owner holds for the ghost rows this rank receives,
    fetched by one exchange of the factor as a one-column table over the
    rank's HaloPlan (parallel/halo.py). A collective: every rank of the
    group enters it."""
    from dorylus_tpu_torch.parallel.halo import halo_recv

    f_local = np.asarray(f_local, np.float32)
    col = torch.tensor(f_local, device=halo_plan.device)[:, None].contiguous()
    with torch.no_grad():
        ghosts = halo_recv(col, halo_plan)[:, 0].cpu().numpy()
    return np.concatenate([f_local, ghosts])


class ShardedReuseSpMM(ReuseSpMM):
    """One rank's pair rewrite (JAX: ops/reuse_sharded.ShardedReuseSpMM, one
    shard of it). Entries as ReuseSpMM: `apply_static` (GCN, with
    rank1_factor), `apply_dst`, `apply_unit`; `apply` raises. The table is
    `halo_exchange`'s (vp + n * max_h, F).

    rank1_factor: the factor of every table row (vp + n * max_h,), JAX's
    `f_in` of this shard: f = sqrt(self_val) of the local rows (0 on padding
    rows), then the owners' factors of the ghost rows, which a rank gets
    from `exchange_rank1_factor`. Its first vp entries scale the output.
    None for GAT. With n = 1 the table is the vp local rows and the factor
    the local one: there is no halo (JAX's op keeps the ghost rows there
    and its engine fails on the vp-row table the model hands it).

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu"."""

    def __init__(self, shard: Shard, n: int, rank1_factor=None,
                 gather_dtype: torch.dtype | None = None, min_uses: int = 3,
                 passes: int = 1, max_pairs: int = 0, max_width: int = 512,
                 device: str | torch.device | None = None):
        device = resolve_device(device)
        src, dst, _ = shard_edges(shard, "combined")
        vp, max_h = int(shard.x.shape[0]), int(shard.send_idx.shape[1])
        # one graph shard exchanges nothing: its table is the vp local rows
        table = vp + n * max_h if n > 1 else vp
        factors = None
        if rank1_factor is not None:
            f_in = np.asarray(rank1_factor, np.float32)
            if f_in.shape != (table,):
                raise ValueError(f"rank1_factor {f_in.shape}: want the table's ({table},) "
                                 f"factors, {vp} local then {n * max_h} ghost rows")
            factors = (f_in, f_in[:vp])
        super().__init__(src, dst, table, vp, max_width=max_width,
                         gather_dtype=gather_dtype, rank1_factor=factors,
                         min_uses=min_uses, passes=passes, max_pairs=max_pairs,
                         device=device)
        self.vp, self.table = vp, table
