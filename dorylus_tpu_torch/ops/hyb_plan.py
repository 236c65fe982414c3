"""Host-side hybrid-ELL plan builder — a numpy copy of the JAX package's.

`dorylus_tpu/ops/hyb_spmm.py` imports jax at module top, so its builder
cannot be imported here. These functions are copied from it verbatim
(`_choose_widths`, `_fill_rows`, `build_hyb_plan` and the `_LAMBDA_SLOTS`
default; `_cast_vals`' bf16 pre-cast happens in torch when the plan is
uploaded, since numpy has no bfloat16) and `tests/test_torch_port_ops.py` pins them to
the original array for array: both packages must run the same plans.

Plan layout (one per direction):
  * buckets: one slot row per vertex with 1 <= deg <= max_width, in
    buckets of DP-chosen widths (multiples of 8). rows[i, :cnt[i]] are
    the source ids of vertex v[i]'s edges; pads are row 0 with val 0.
  * top: vertices with deg > max_width ("hubs") as width-max_width chunk
    rows; rowv maps each chunk row to its hub (ascending, so a hub's
    chunk rows are contiguous).
  * output placement: "_n_iso" (the identity layout of a graph numbered
    by ascending degree) or "inv" (vertex -> position, with a zero
    sentinel row for isolated vertices).
"""

from __future__ import annotations

import numpy as np

# Per-bucket fixed cost in slot-equivalents for the width DP. The value is
# the JAX package's, fitted there to a per-kernel startup cost on a TPU;
# it is kept so both packages build identical plans. Re-fitting it for the
# CUDA kernel (whose per-bucket cost is one launch) is a ROADMAP item.
_LAMBDA_SLOTS = 512 * 1024


def _choose_widths(deg_sorted: np.ndarray, lam: int) -> list[int]:
    """Bucket widths (multiples of 8) minimizing slots + lam*n_buckets
    over vertices with the given ascending degrees (all >= 1)."""
    wclass = ((deg_sorted + 7) // 8) * 8
    cands, counts = np.unique(wclass, return_counts=True)
    k = len(cands)
    prefix = np.zeros(k + 1, np.int64)
    np.cumsum(counts, out=prefix[1:])
    best = np.full(k + 1, np.iinfo(np.int64).max, np.int64)
    best[0] = 0
    back = np.zeros(k + 1, np.int32)
    for j in range(1, k + 1):
        for i in range(j):
            c = best[i] + cands[j - 1] * (prefix[j] - prefix[i]) + lam
            if c < best[j]:
                best[j] = c
                back[j] = i
    widths = []
    j = k
    while j > 0:
        widths.append(int(cands[j - 1]))
        j = int(back[j])
    return widths[::-1]


def _fill_rows(src, estart, verts, deg, width, edge_ids):
    """(len(verts), width) slot grid for one-row-per-vertex buckets:
    rows[i, :deg[v]] = src ids of v's edges, pads -> row 0 (killed by the
    mask/val weight). Also returns the original edge id per slot
    (sentinel E for pads) — liveness within a row is always a PREFIX."""
    cnt = deg[verts].astype(np.int32)
    tot = int(cnt.sum())
    rstart = np.zeros(len(verts) + 1, np.int64)
    np.cumsum(cnt, out=rstart[1:])
    ridx = np.repeat(np.arange(len(verts)), cnt)
    cidx = np.arange(tot) - rstart[ridx]
    eidx = estart[verts][ridx] + cidx
    rows = np.zeros((len(verts), width), np.int32)
    rows[ridx, cidx] = src[eidx]
    s2e = np.full((len(verts), width), len(src), np.int64)
    s2e[ridx, cidx] = edge_ids[eidx]
    return rows, cnt, s2e, (ridx, cidx, eidx)


def build_hyb_plan(src: np.ndarray, dst: np.ndarray,
                   edge_ids: np.ndarray | None, num_out: int,
                   max_width: int = 512,
                   lam_slots: int = _LAMBDA_SLOTS,
                   static_val: np.ndarray | None = None,
                   widths: list[int] | None = None) -> dict:
    """Host-side plan. Requires dst ascending (CSC order). edge_ids maps
    this edge order to original edge ids (identity for the forward plan,
    the transpose permutation for the backward plan).

    widths: fixed bucket widths instead of the DP, KEEPING empty buckets —
    the sharded wrapper (ops/hyb_sharded.py) needs every shard's plan to
    share one bucket structure under a single SPMD program."""
    e = len(src)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if edge_ids is None:
        edge_ids = np.arange(e, dtype=np.int64)
    deg = np.bincount(dst, minlength=num_out)
    estart = np.zeros(num_out + 1, np.int64)
    np.cumsum(deg, out=estart[1:])
    order = np.argsort(deg, kind="stable")
    deg_s = deg[order]
    first = int(np.searchsorted(deg_s, 1))  # skip isolated vertices
    active, deg_a = order[first:], deg_s[first:]
    hub_lo = int(np.searchsorted(deg_a, max_width, side="right"))
    normal, hubs = active[:hub_lo], active[hub_lo:]
    deg_n = deg_a[:hub_lo]
    sv = None
    if static_val is not None:
        sv = np.asarray(static_val, np.float32)

    buckets = []
    slot_off = 0
    e2s = np.zeros(max(1, e), np.int64)
    lo = 0
    keep_empty = widths is not None
    if widths is None:
        widths = _choose_widths(deg_n, lam_slots) if len(deg_n) else []
    for w in widths:
        hi = int(np.searchsorted(deg_n, w, side="right"))
        verts = normal[lo:hi]
        lo = hi
        if len(verts) == 0 and not keep_empty:
            continue
        rows, cnt, s2e, (ridx, cidx, eidx) = _fill_rows(
            src, estart, verts, deg, w, edge_ids)
        b = {"rows": rows, "cnt": cnt, "v": verts.astype(np.int32),
             "s2e": s2e.astype(np.int32)}
        if sv is not None:
            vals = np.zeros(rows.shape, np.float32)
            vals[ridx, cidx] = sv[edge_ids[eidx]]
            b["vals"] = vals
        e2s[edge_ids[eidx]] = slot_off + ridx * w + cidx
        slot_off += rows.size
        buckets.append(b)
    # Explicit widths must cover every non-hub degree — an uncovered
    # vertex would silently aggregate to zero (sentinel inv row) and leak
    # slot-0 garbage through e2s gradients.
    assert lo == len(normal), \
        f"widths {widths} cover degrees <= {widths[-1] if widths else 0}, " \
        f"but {len(normal) - lo} vertices have higher (non-hub) degree"

    top = None
    if len(hubs):
        nrow = -(-deg[hubs] // max_width)
        rt = int(nrow.sum())
        rows = np.zeros((rt, max_width), np.int32)
        s2e = np.full((rt, max_width), e, np.int64)
        cnt = np.full(rt, max_width, np.int32)
        rowv = np.repeat(np.arange(len(hubs), dtype=np.int32), nrow)
        rowv_global = hubs[rowv].astype(np.int32)
        # Per-hub fill loop (hub count is small by construction: only
        # vertices with deg > max_width land here).
        r0 = 0
        vals = np.zeros((rt, max_width), np.float32) if sv is not None else None
        for i, vtx in enumerate(hubs):
            d = int(deg[vtx])
            ed = np.arange(estart[vtx], estart[vtx] + d)
            nr = -(-d // max_width)
            pad = nr * max_width - d
            rows[r0:r0 + nr] = np.pad(src[ed], (0, pad)).reshape(nr, max_width)
            se = np.pad(edge_ids[ed], (0, pad), constant_values=e)
            s2e[r0:r0 + nr] = se.reshape(nr, max_width)
            if d % max_width:
                cnt[r0 + nr - 1] = d % max_width
            if sv is not None:
                vals[r0:r0 + nr] = np.pad(
                    sv[edge_ids[ed]], (0, pad)).reshape(nr, max_width)
            flat = slot_off + r0 * max_width + np.arange(d)
            e2s[edge_ids[ed]] = flat
            r0 += nr
        top = {"rows": rows, "cnt": cnt, "rowv": rowv,
               "rowv_global": rowv_global, "v": hubs.astype(np.int32),
               "s2e": s2e.astype(np.int32)}
        if sv is not None:
            top["vals"] = vals
        slot_off += rows.size

    # Output layout: [buckets..., hubs, zero row]; inv: vertex -> position.
    # When vertices are ALREADY numbered by ascending degree (the
    # degree-sort preprocessing, graph/reorder.py degree_order
    # ascending=True), the stable degree argsort is the identity, bucket
    # outputs land in vertex order, and the inverse-permutation gather
    # collapses to a zero-row prefix for the isolated vertices — plan
    # carries "_n_iso" instead of "inv" (undirected graphs get it on BOTH
    # plans since in-deg == out-deg).
    plan = {"buckets": tuple(buckets), "top": top,
            "e2s": e2s.astype(np.int32), "n_slots": slot_off}
    if np.array_equal(order, np.arange(num_out)):
        plan["_n_iso"] = first
    else:
        n_active = sum(len(b["v"]) for b in buckets) + (len(hubs) if top else 0)
        inv = np.full(num_out, n_active, np.int64)
        pos = 0
        for b in buckets:
            inv[b["v"]] = np.arange(pos, pos + len(b["v"]))
            pos += len(b["v"])
        if top is not None:
            inv[top["v"]] = np.arange(pos, pos + len(top["v"]))
        plan["inv"] = inv.astype(np.int32)
    return plan
