"""The gather kernels' view of a slot plan: the part-descriptor table of
csrc/gather_pass.cuh (K1/K2 in hyb_spmm.cu, K8 in fused_spmm.cu) and the
padded gather table; and of a CSR (K3/K4 in edge_spmm.cu): the CSR team's
launch geometry.

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
that reads local rows only) and `wide` (a warp per output row instead of a
group). A block finds its part from the first blocks.

`gather_table` writes the table the kernel reads: the gather dtype, rows
padded to a multiple of 16 bytes (the kernel loads 16 bytes a lane), pad
columns zero. An f32 table of aligned width is used as it is.

`walk_plain` computes a pass by walking the descriptor table block by block
in plain torch: the CPU tests hold it against the plain passes, which shows
that the blocks cover every output row once and that each part reads the
table it should. `walk_csr_plain` does the same for a CSR pass, down to the
slots each group takes and the reduce-scatter that hands each edge's dot to
the lane that writes it.
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
                       ("split", "<i4"), ("wide", "<i4"), ("pad", "<i4")])
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
        for part, split in zip(parts, splits):
            n_out = check_part(part, self.device)
            if n_out:
                live = int(part["cnt"].sum())
                kept.append((-live / n_out, len(kept), part, split, n_out, live))
        kept.sort(key=lambda k: k[:2])  # longest rows first, then plan order
        self.parts = [k[2] for k in kept]
        self.splits = [k[3] for k in kept]
        self.n_out = [k[4] for k in kept]
        self.live = [k[5] for k in kept]
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
    lanes = torch.arange(g)
    for i in range(n_rows):  # block i // rows_a_block, its team i % rows_a_block
        rb, re = rp[i], rp[i + 1]
        for tile in range(0, ld, g * vec):
            cols = tile + lanes[:, None] * vec + torch.arange(vec)  # (g, vec): a lane's 16 bytes
            live = cols < ld
            cols = cols.clamp(max=ld - 1)
            own_i = torch.zeros((g, vec))
            if own is not None and i < own.shape[0] and rb < re:
                own_i = own[i][cols].float() * live
            acc = torch.zeros((g, vec))
            for e0 in range(rb, re, team):
                m = min(team, re - e0)
                steps = -(-m // r)
                n_st = -(-steps // u) * u  # steps in whole batches of u
                sl = torch.arange(r)[None, :] + r * torch.arange(n_st)[:, None]  # (steps, r)
                alive = (sl < m)[..., None, None] & live
                edge = e0 + sl.clamp(max=m - 1)
                w = perm[edge].long() if perm is not None else edge
                x = tab[col[edge].long()][..., cols] * alive  # (steps, r, g, vec) in tab's dtype
                if val is not None:
                    a = val[w].to(tab.dtype)[..., None, None]
                    acc += (x * a).float().sum(dim=(0, 1))
                if own is not None:
                    d = (x.float() * own_i).sum(-1)  # (steps, r, g)
                    d = d.reshape(n_st // u, u, r, g).permute(0, 2, 3, 1)
                    v = _reduce_scatter(d, g, u)  # (batches, r, g)
                    tl = torch.arange(m)
                    step = tl // r
                    mine = v[step // u, tl % r, _brev_low(step % u, u)]
                    dval[e0 + tl] = mine if tile == 0 else dval[e0 + tl] + mine
                    if tile == 0:
                        writes[e0 + tl] += 1
            if out is not None:
                keep = (cols < f) & live
                out[i, cols[keep]] = acc[keep]
    return out, dval, writes

