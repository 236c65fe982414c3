"""Host-side degree-padded plan builder — a numpy copy of the JAX
package's.

`dorylus_tpu/ops/degree_spmm.py` imports jax at module top, so its builder
cannot be imported here. `build_degree_plan` is copied from it with the
out-block maps left out: the port always builds with out_block_rows=0.
Those maps (`out_idx`, `out_loc`) block the final segment reduction below a
TPU VMEM cliff; the CUDA kernels write each output row once from one team of
lanes, so they have nothing to block (ROADMAP.md "Not to port").
`tests/test_torch_port_degree.py` pins the copy to the original array for
array.

Plan layout (one per direction): each vertex's in-edges, in edge order,
fill a run of ceil(deg / block) block rows of `block` slots; pad slots
gather row 0 and carry the edge sentinel E.
  * slot_src (R, block) int32: source row of each slot;
  * slot_to_edge (R, block) int32: original edge id per slot (E for pads);
  * block_row (R,) int32: the vertex each block row belongs to (ascending;
    a zero-edge graph has one sentinel row for vertex 0);
  * edge_to_slot (max(1, E),) int32: flat slot of each original edge;
  * live_cnt (R,) int32: live slots per block row (always a prefix).
"""

from __future__ import annotations

import numpy as np


def build_degree_plan(src: np.ndarray, dst: np.ndarray,
                      edge_ids: np.ndarray | None,
                      num_out: int, block: int = 16) -> dict:
    """Host-side plan. Requires dst ascending (CSC order).

    edge_ids: original edge index of each (src, dst) pair — identity for
    the forward plan, the transpose permutation for the backward plan —
    so dynamic edge values (GAT attention) can be routed into slots."""
    e = len(src)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if edge_ids is None:
        edge_ids = np.arange(e, dtype=np.int64)
    deg = np.bincount(dst, minlength=num_out)
    nblk = -(-deg // block)  # ceil; 0 for isolated vertices
    r = max(1, int(nblk.sum()))
    block_row = np.repeat(np.arange(num_out, dtype=np.int64), nblk)
    if len(block_row) == 0:
        block_row = np.zeros(1, np.int64)
    vstart = np.zeros(num_out + 1, np.int64)
    np.cumsum(nblk * block, out=vstart[1:])
    estart = np.zeros(num_out + 1, np.int64)
    np.cumsum(deg, out=estart[1:])
    slot = vstart[dst] + (np.arange(e) - estart[dst])

    n_slots = r * block
    slot_src = np.zeros(n_slots, np.int32)
    slot_to_edge = np.full(n_slots, e, np.int64)  # e == padding sentinel
    slot_src[slot] = src
    slot_to_edge[slot] = edge_ids
    # Inverse map: original edge id -> flat slot (for the fused-SDDMM bwd).
    edge_to_slot = np.zeros(max(1, e), np.int64)
    edge_to_slot[edge_ids] = slot
    return {
        "slot_src": slot_src.reshape(r, block),
        "slot_to_edge": slot_to_edge.astype(np.int32).reshape(r, block),
        "block_row": block_row.astype(np.int32),
        "edge_to_slot": edge_to_slot.astype(np.int32),
        # Live slots per block row. Edges fill each vertex's slot run in
        # order, so liveness within a row is always a PREFIX — a (R,) count
        # reconstructs the (R, B) mask via an in-register iota compare,
        # 16x fewer mask bytes than a dense (R, B) array (see _slot_live).
        "live_cnt": np.bincount(slot // block, minlength=r).astype(np.int32),
    }
