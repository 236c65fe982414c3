"""The gather kernels' view of a slot plan: the part-descriptor table of
csrc/gather_pass.cuh (K1/K2 in hyb_spmm.cu, K8 in fused_spmm.cu, K7 in
dyn_spmm.cu) and the padded gather table; and of a CSR (K3/K4 in
edge_spmm.cu): the CSR team's launch geometry.

A plan's parts (the buckets and the hub top of a hybrid-ELL plan, the one
part of a degree plan) run in ONE launch. `PartTable` is built once, when
the plan is uploaded: it checks every part once (index dtypes, devices,
contiguity, shapes; what the kernel assumes of the plan), drops parts
without output rows and orders the rest by their live slots per output row,
longest first, so the blocks of the longest rows start first. Per group size
g (the lanes that read one table row, set by the pass's width) it lays out
the 64-byte descriptors the launch carries in its parameters: pointers, the
slot-row width, the output rows, the part's first block, `split` (slot
indices from split on read the second table of K8; LOCAL_ONLY for a part
that reads local rows only), `wide` (a warp per output row instead of a
group) and `slot0`, the flat slot of the part's first slot: the slots of the
parts before it in plan order, the order in which a dynamic plan's e2s
names an edge's slot (K7 reads s2e and writes its dots there). A block
finds its part from the first blocks.

`gather_table` writes the table the kernel reads: the gather dtype, rows
padded to a multiple of 16 bytes (the kernel loads 16 bytes a lane), pad
columns zero. An f32 table of aligned width is used as it is.

`walk_plain` computes a pass by walking the descriptor table block by block
in plain torch: the CPU tests hold it against the plain passes, which shows
that the blocks cover every output row once and that each part reads the
table it should. `walk_csr_plain` does the same for a CSR pass and
`walk_dyn_plain` for K7's passes, down to the slots each group takes and the
reduce-scatter that hands each edge's (slot's) dot to the lane that writes
it.
"""

from __future__ import annotations

import numpy as np
import torch

THREADS = 256  # threads of a block (gather_pass.cuh kPassThreads)
MAX_PARTS = 56  # descriptors one launch carries (gather_pass.cuh kMaxParts)
LOCAL_ONLY = 2**31 - 1  # `split` of a part whose slots never read the second table
# A part whose output rows hold at least this many live slots on average
# gets a warp per output row (its groups split the row's slots); a part of
# shorter rows a group per output row.
WIDE_SLOTS = 64

PART_DTYPE = np.dtype([("rows", "<u8"), ("vals", "<u8"), ("cnt", "<u8"), ("row_ptr", "<u8"),
                       ("out_idx", "<u8"), ("w", "<i4"), ("n_out", "<i4"), ("block0", "<i4"),
                       ("split", "<i4"), ("wide", "<i4"), ("slot0", "<i4")])
assert PART_DTYPE.itemsize == 64


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hybrid-ELL kernel: {msg}")


def check_part(part: dict, device: torch.device) -> int:
    """What the kernels assume of one part of a plan; returns its output
    row count."""
    rows, cnt, out_idx = part["rows"], part["cnt"], part["v"]
    row_ptr, vals = part.get("row_ptr"), part.get("vals")
    ints = [rows, cnt, out_idx] + ([row_ptr] if row_ptr is not None else [])
    _check(all(t.dtype == torch.int32 for t in ints), "plan indices must be int32")
    for t in ints + ([vals] if vals is not None else []):
        _check(t.device == device, f"plan tensor on {t.device}, plan on {device}")
        _check(t.is_contiguous(), "all tensors must be contiguous")
    _check(rows.dim() == 2 and cnt.shape == (rows.shape[0],),
           f"rows {tuple(rows.shape)} / cnt {tuple(cnt.shape)} disagree")
    _check(vals is None or vals.shape == rows.shape,
           f"vals {None if vals is None else tuple(vals.shape)} / rows "
           f"{tuple(rows.shape)} disagree")
    n_out = out_idx.shape[0]
    if row_ptr is None:
        _check(n_out == rows.shape[0], "bucket needs one slot row per output row")
    else:
        _check(row_ptr.shape == (n_out + 1,), "row_ptr must have n_out + 1 entries")
    return n_out


def group_lanes(ld: int, itemsize: int) -> tuple[int, int]:
    """(g, column tiles) for a table of leading dimension ld: the lanes that
    read one row 16 bytes each, rounded up to 8, 16 or 32, and the tiles of
    g * 16 bytes that cover the row."""
    pieces = ld * itemsize // 16
    g = 8 if pieces <= 8 else 16 if pieces <= 16 else 32
    return g, -(-pieces // g)


def gather_table(table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (rows, ld) table the kernel reads: `table` in `dtype`, each row
    padded with zeros to ld, the width rounded up to a multiple of 16 bytes.
    A table already in that layout (an aligned, contiguous f32 table of
    aligned width) is returned as it is."""
    f = table.shape[1]
    vec = 16 // dtype.itemsize
    ld = -(-f // vec) * vec
    if ld == f:
        tb = table.to(dtype).contiguous()  # one cast (none for a table already so)
        if tb.data_ptr() % 16 == 0:
            return tb
    tb = torch.empty((table.shape[0], ld), dtype=dtype, device=table.device)
    if ld > f:
        tb[:, f:].zero_()
    tb[:, :f].copy_(table)
    return tb


class PartTable:
    """The descriptor table of one plan. parts: the plan's part dicts
    (rows, cnt, v, optional vals and row_ptr) on one device; splits: each
    part's `split` (default LOCAL_ONLY: one table)."""

    def __init__(self, parts: list, splits: list | None = None):
        splits = list(splits) if splits is not None else [LOCAL_ONLY] * len(parts)
        _check(len(splits) == len(parts), "one split per part")
        self.device = parts[0]["rows"].device if parts else torch.device("cpu")
        kept = []
        slot0 = 0
        for part, split in zip(parts, splits):
            n_out = check_part(part, self.device)
            if n_out:
                live = int(part["cnt"].sum())
                kept.append((-live / n_out, len(kept), part, split, n_out, live, slot0))
            slot0 += part["rows"].numel()
        _check(slot0 < 2**31, f"{slot0} slots: past the kernels' int32 slot index")
        self.n_slots = slot0  # of every part given, in plan order
        kept.sort(key=lambda k: k[:2])  # longest rows first, then plan order
        self.parts = [k[2] for k in kept]
        self.splits = [k[3] for k in kept]
        self.n_out = [k[4] for k in kept]
        self.live = [k[5] for k in kept]
        self.slot0 = [k[6] for k in kept]
        self.wide = [live >= WIDE_SLOTS * n for live, n in zip(self.live, self.n_out)]
        # of every part given, so that a plan whose parts are all empty keeps
        # its values' dtype (its static pass launches nothing and is no error)
        vals = [p.get("vals") for p in parts]
        self.vals_dtype = vals[0].dtype if vals and all(v is not None for v in vals) else None
        _check(all(v is None or v.dtype == self.vals_dtype for v in vals),
               "every part's values must share one dtype")
        self.out_rows = max((int(p["v"].max()) + 1 for p in self.parts), default=0)
        self._layouts: dict = {}

    def teams(self, g: int, k: int) -> int:
        """Output rows a block of part k covers at group size g."""
        return THREADS // (32 if self.wide[k] or g == 32 else g)

    def layout(self, g: int) -> list:
        """The launches of a pass at group size g: [(descriptor array, first
        part, blocks, the array's address)], one launch per MAX_PARTS
        parts."""
        if g not in self._layouts:
            launches = []
            for k0 in range(0, len(self.parts), MAX_PARTS):
                ks = range(k0, min(k0 + MAX_PARTS, len(self.parts)))
                desc = np.zeros(len(ks), PART_DTYPE)
                block = 0
                for row, k in zip(desc, ks):
                    p = self.parts[k]
                    row["rows"], row["cnt"], row["out_idx"] = (
                        p["rows"].data_ptr(), p["cnt"].data_ptr(), p["v"].data_ptr())
                    row["vals"] = p["vals"].data_ptr() if "vals" in p else 0
                    row["row_ptr"] = p["row_ptr"].data_ptr() if "row_ptr" in p else 0
                    row["w"], row["n_out"] = p["rows"].shape[1], self.n_out[k]
                    row["block0"], row["split"], row["wide"] = block, self.splits[k], self.wide[k]
                    row["slot0"] = self.slot0[k]
                    block += -(-self.n_out[k] // self.teams(g, k))
                launches.append((desc, k0, block, desc.ctypes.data))
            self._layouts[g] = launches
        return self._layouts[g]

    def block_rows(self, g: int) -> list:
        """[(part index, output rows)] for every block of every launch at
        group size g, in launch order, read back from the descriptors as the
        kernel reads them."""
        out = []
        for desc, k0, n_blocks, _ in self.layout(g):
            for b in range(n_blocks):
                j = int(np.searchsorted(desc["block0"], b, side="right")) - 1
                k = k0 + j
                t = self.teams(g, k)
                rel = b - int(desc["block0"][j])
                rows = np.arange(rel * t, min((rel + 1) * t, int(desc["n_out"][j])))
                out.append((k, rows))
        return out


def walk_plain(pt: PartTable, g: int, tables: tuple, num_out: int,
               gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """A static or mask pass computed block by block from the descriptor
    table, in plain torch -> (num_out, F) f32. tables: (h,) or (h, ghosts);
    a slot s of a part reads h[s] below the part's split, ghosts[s - split]
    from it on. Narrow gather dtypes multiply in their dtype and sum in f32,
    as the kernels and the plain passes do."""
    narrow = gather_dtype is not None and gather_dtype.itemsize < 4
    dt = gather_dtype if narrow else torch.float32
    cat = torch.cat([t.to(dt) for t in tables])
    h_rows, dev = tables[0].shape[0], tables[0].device
    out = torch.zeros((num_out, tables[0].shape[1]), dtype=torch.float32, device=dev)
    for k, rows in pt.block_rows(g):
        part, split = pt.parts[k], pt.splits[k]
        i = torch.as_tensor(rows, dtype=torch.long, device=dev)
        if "row_ptr" in part:
            rp = part["row_ptr"].long()
            runs = rp[i + 1] - rp[i]
            owner = torch.repeat_interleave(torch.arange(len(i), device=dev), runs)
            r = rp[i][owner] + torch.arange(len(owner), device=dev) - (
                torch.cumsum(runs, 0) - runs)[owner]
        else:
            r, owner = i, torch.arange(len(i), device=dev)
        s = part["rows"][r].long()
        s = torch.where(s < split, s, s - split + h_rows)
        live = (torch.arange(s.shape[1], device=dev)[None, :]
                < part["cnt"][r].long()[:, None]).to(dt)
        wt = part["vals"][r].to(dt) * live if mode == "static" else live
        sums = (cat[s] * wt[..., None]).sum(dim=1, dtype=torch.float32)
        block = torch.zeros((len(i), out.shape[1]), dtype=torch.float32,
                            device=dev).index_add_(0, owner, sums)
        out[part["v"][i].long()] = block
    return out


def csr_geometry(ld: int, itemsize: int, n_rows: int, n_edges: int, dot: bool = False
                 ) -> dict:
    """The launch of a CSR pass (gather_pass.cuh `csr_team`) over a table of
    leading dimension ld: `g` lanes a group, `r` groups a team (a warp a row,
    its groups splitting the row's edges, where the rows average WIDE_SLOTS
    edges; a row wider than g * 16 bytes walks its column tiles inside the
    team), `rows_a_block`, `blocks` and `unroll`, the 16-byte loads a lane
    keeps in flight (dot: a pass that forms K4's dots)."""
    g, _ = group_lanes(ld, itemsize)
    r = 32 // g if g < 32 and n_edges >= WIDE_SLOTS * n_rows else 1
    rows = THREADS // (g * r)
    return {"g": g, "r": r, "rows_a_block": rows, "blocks": -(-n_rows // rows),
            "unroll": 8 if itemsize == 4 and g == 32 and not dot else 4}


def _brev_low(x: torch.Tensor, u: int) -> torch.Tensor:
    """x's log2(u) low bits reversed (gather_pass.cuh `brev_low`)."""
    bits = u.bit_length() - 1
    out = torch.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


def _reduce_scatter(d: torch.Tensor, g: int, u: int) -> torch.Tensor:
    """(..., g lanes, u slots) partial dots -> (..., g): lane gl the dot of
    slot brev(gl % u) over the group, as `reduce_scatter` forms it: halving
    exchanges with lane gl ^ o, then a butterfly over the rest."""
    lanes = torch.arange(g)
    o = 1
    while o < u:
        half = d.shape[-1] // 2
        up = ((lanes & o) != 0)[:, None]
        keep = torch.where(up, d[..., half:], d[..., :half])
        send = torch.where(up, d[..., :half], d[..., half:])
        d = keep + send[..., lanes ^ o, :]
        o <<= 1
    v = d[..., 0]
    while o < g:
        v = v + v[..., lanes ^ o]
        o <<= 1
    return v


def _team_chunk(x_rows: torch.Tensor, wts: torch.Tensor | None, own_i: torch.Tensor | None,
                g: int, r: int, u: int, cols: torch.Tensor, live: torch.Tensor) -> tuple:
    """One chunk of m <= g * r slots of a team, as `csr_team` and `dyn_team`
    run it: group q takes the chunk's slots q, q + r, ..., u at a time, each
    lane the 16 bytes `cols` of the slot's row. x_rows: (m, ld) the chunk's
    table rows; wts: (m,) their weights in the table's dtype, or None; own_i:
    (g, vec) the team's own row in the dtype its products are formed in, or
    None. Returns the chunk's weighted sums per lane ((g, vec) f32, or None)
    and each slot's dot as the lane that loaded its index receives it after
    the reduce-scatter ((m,) f32, or None)."""
    m = x_rows.shape[0]
    steps = -(-m // r)
    n_st = -(-steps // u) * u  # steps in whole batches of u
    sl = torch.arange(r)[None, :] + r * torch.arange(n_st)[:, None]  # (steps, r)
    alive = (sl < m)[..., None, None] & live
    idx = sl.clamp(max=m - 1)
    x = x_rows[idx][..., cols] * alive  # (steps, r, g, vec) in the table's dtype
    sums = dots = None
    if wts is not None:
        sums = (x * wts[idx][..., None, None]).float().sum(dim=(0, 1))
    if own_i is not None:
        d = (x.to(own_i.dtype) * own_i).float().sum(-1)  # (steps, r, g)
        d = d.reshape(n_st // u, u, r, g).permute(0, 2, 3, 1)
        v = _reduce_scatter(d, g, u)  # (batches, r, g)
        step = torch.arange(m) // r
        dots = v[step // u, torch.arange(m) % r, _brev_low(step % u, u)]
    return sums, dots


def _lane_cols(tile: int, g: int, vec: int, ld: int) -> tuple:
    """(g, vec) columns of each lane's 16 bytes in a column tile, clamped
    into the row, and which of them lie in it."""
    cols = tile + torch.arange(g)[:, None] * vec + torch.arange(vec)
    return cols.clamp(max=ld - 1), cols < ld


def walk_csr_plain(tab: torch.Tensor, own: torch.Tensor | None, row_ptr: torch.Tensor,
                   col: torch.Tensor, val: torch.Tensor | None, perm: torch.Tensor | None,
                   f: int) -> tuple:
    """A CSR pass computed team by team as `csr_team` runs it, in plain
    torch: the sum (val given, read at perm(e): out (rows, f) f32, products
    in tab's dtype) and the dot (own given: dval (E,) f32 in the CSR's edge
    order, each written by the lane that loaded edge e). tab and own are
    laid out by `gather_table`. Returns (out or None, dval or None, writes
    per dval entry)."""
    ld, itemsize = tab.shape[1], tab.element_size()
    n_rows, e = row_ptr.shape[0] - 1, col.shape[0]
    geo = csr_geometry(ld, itemsize, n_rows, e, dot=own is not None)
    g, r, u = geo["g"], geo["r"], geo["unroll"]
    team, vec = g * r, 16 // itemsize
    out = torch.zeros((n_rows, f)) if val is not None else None
    dval = torch.zeros(e) if own is not None else None
    writes = torch.zeros(e, dtype=torch.int64)
    rp = row_ptr.long().tolist()
    for i in range(n_rows):  # block i // rows_a_block, its team i % rows_a_block
        rb, re = rp[i], rp[i + 1]
        for tile in range(0, ld, g * vec):
            cols, live = _lane_cols(tile, g, vec, ld)
            own_i = None
            if own is not None:
                own_i = torch.zeros((g, vec))
                if i < own.shape[0] and rb < re:
                    own_i = own[i][cols].float() * live
            acc = torch.zeros((g, vec))
            for e0 in range(rb, re, team):
                edge = torch.arange(e0, min(e0 + team, re))
                wts = None
                if val is not None:
                    wts = val[perm[edge].long() if perm is not None else edge].to(tab.dtype)
                sums, mine = _team_chunk(tab[col[edge].long()], wts, own_i, g, r, u, cols, live)
                if sums is not None:
                    acc += sums
                if mine is not None:
                    dval[edge] = mine if tile == 0 else dval[edge] + mine
                    if tile == 0:
                        writes[edge] += 1
            if out is not None:
                keep = (cols < f) & live
                out[i, cols[keep]] = acc[keep]
    return out, dval, writes


def dyn_geometry(ld: int, itemsize: int, wide: bool, dot: bool = False) -> dict:
    """The team of a K7 pass (gather_pass.cuh `dyn_team`) over a table of
    leading dimension ld: `g` lanes a group, `r` groups a team (a warp a row
    for a wide part), `unroll`, the 16-byte loads a lane keeps in flight (4
    with the dot, as `csr_team`)."""
    g, _ = group_lanes(ld, itemsize)
    return {"g": g, "r": 32 // g if wide and g < 32 else 1,
            "unroll": 8 if itemsize == 4 and g == 32 and not dot else 4}


def walk_dyn_plain(pt: PartTable, tab: torch.Tensor, s2e: torch.Tensor, val: torch.Tensor,
                   own: torch.Tensor | None, num_out: int, f: int,
                   wslot: torch.Tensor | None = None) -> tuple:
    """K7's pass computed block by block and team by team as
    `dyn_pass_kernel` runs it, in plain torch: out (num_out, f) f32, slot
    (r, j) of part k weighing its row by val[s2e[slot0_k + r*w + j]] rounded
    to tab's dtype (or by wslot at that slot), products in tab's dtype; with
    own, each live slot's dot (products in tab's dtype) into flat
    (pt.n_slots,) at slot0_k + r*w + j, written by the lane that loaded the
    slot's index, a later column tile adding to it. tab and own are laid out
    by `gather_table`, s2e is the plan's map in flat slot order. Returns
    (out, flat or None, the live slots' visits per flat slot)."""
    ld, itemsize = tab.shape[1], tab.element_size()
    vec = 16 // itemsize
    out = torch.zeros((num_out, f))
    flat = torch.zeros(pt.n_slots) if own is not None else None
    visits = torch.zeros(pt.n_slots, dtype=torch.int64)
    for k, rows in pt.block_rows(group_lanes(ld, itemsize)[0]):
        part = pt.parts[k]
        geo = dyn_geometry(ld, itemsize, pt.wide[k], dot=own is not None)
        g, r, u = geo["g"], geo["r"], geo["unroll"]
        w, rp = part["rows"].shape[1], part.get("row_ptr")
        for i in rows.tolist():
            v = int(part["v"][i])
            run = range(int(rp[i]), int(rp[i + 1])) if rp is not None else range(i, i + 1)
            for tile in range(0, ld, g * vec):
                cols, live = _lane_cols(tile, g, vec, ld)
                own_i = None
                if own is not None:
                    own_i = torch.zeros((g, vec), dtype=own.dtype)
                    if v < own.shape[0]:
                        own_i = own[v][cols] * live
                acc = torch.zeros((g, vec))
                for rr in run:
                    n, slot = int(part["cnt"][rr]), pt.slot0[k] + rr * w
                    for j0 in range(0, n, g * r):
                        sl = torch.arange(slot + j0, slot + min(j0 + g * r, n))
                        wts = (wslot[sl] if wslot is not None
                               else val[s2e[sl].long()].to(tab.dtype))
                        x_rows = tab[part["rows"][rr, j0:j0 + len(sl)].long()]
                        sums, mine = _team_chunk(x_rows, wts, own_i, g, r, u, cols, live)
                        acc += sums
                        if mine is not None:
                            flat[sl] = mine if tile == 0 else flat[sl] + mine
                        if tile == 0:
                            visits[sl] += 1
                keep = (cols < f) & live
                out[v, cols[keep]] = acc[keep]
    return out, flat, visits
