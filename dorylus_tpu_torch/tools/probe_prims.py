"""Measure the H100 primitive rates that bound any per-edge gather kernel
(the port of tools/probe_pallas_prims.py).

    python -m dorylus_tpu_torch.tools.probe_prims [--ops 100000]

The JAX package judged its SpMM kernels against MEASURED rates of the
Mosaic primitives they are built from. These are the card's counterparts,
four hand-written kernels in ops/csrc/probe_prims.cu:

  P1 `dyn_load`     index-dependent (8, 128) f32 row-block loads from a
                    table in shared memory, summed (Mosaic A);
  P2 `dyn_rmw`      the same as a read-modify-write (+1) of a
                    shared-memory scratch (Mosaic B);
  P3 `row_copy`     per-row 512-byte asynchronous copies (`cp.async`, 32
                    pieces of 16 bytes a row) from device memory into a
                    shared-memory ring of depth 16 (Mosaic C); also with
                    256-byte rows (a (rows, 64) table), where a half-warp is
                    a stream, so rows and bytes a second part ways;
  P4 `lane_gather`  indexed warp shuffles over an (8, 128) register tile,
                    out[r, c] = tile[r, ids[c]], summed (Mosaic D).

A "stream" is one serial chain of ops: a block for P1 and P2, a warp for P3
(a half-warp at 256-byte rows) and P4; `idx` carries one row of indices per stream. The Mosaic table of A
and B is 2 MB of VMEM; a block has at most 227 KB of shared memory, so the
table here is the largest whole number of row-blocks that fits beside the
kernel's index buffer (`table_blocks`: 56 row-blocks, 224 KB, on an H100).

Each probe has a plain PyTorch version beside it. The probe functions
dispatch on the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises; nothing falls back. `run` times
every kernel (`measure`) on one block (the per-SM rate, the counterpart of
one Mosaic grid step) and on a grid that fills the card, and holds the timed
launch's output against the plain version on the same inputs (P2 and P3 bit
for bit, P1 and P4 to 1e-4 * max|ref|: f32 sums in another order), after a
fast first check at a small size (`check_against_plain`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from dorylus_tpu_torch.ops import cuda_build

# Kernel launches made by this process. chip_smoke.py resets them before it
# calls `measure` and reads them after.
LAUNCHES = {"P1": 0, "P2": 0, "P3": 0, "P4": 0}

TILE_ROWS, COLS = 8, 128  # one row-block: 4 KB of f32
DEPTH = 16  # P3's ring
ROW_COLS = (128, 64)  # P3's row widths: 512- and 256-byte rows
HALF_ROWS_60MB = 234_376  # P3's 256-byte-row table: 60 MB, the bf16 Reddit table's size
# P3's tables of 512-byte rows: 32 MB (in the L2), 60 MB (K1's bf16 Reddit
# table), 119 MB (K3's f32 F=128 Reddit table: 232,965 rows) and 1 GB
DMA_ROWS = (65_536, 117_188, 232_965, 1 << 21)
ID_ROWS = 64  # P4's id rows, cycled
WARPS = 8  # P3/P4 streams per block
_IDX_BYTES = 1024  # P1/P2's staged-index buffer beside the table

_CSRC = cuda_build.CSRC / "probe_prims.cu"
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


# ---- plain torch versions (CPU path and kernel references) ----


def dyn_load_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1: out[s] = tab.view(B, 8, 128)[idx[s]].sum(0) -> (S, 8, 128) f32
    (summed 4,096 ops at a time, so no (N, 8, 128) tensor is built)."""
    tab3 = tab.view(-1, TILE_ROWS, COLS)
    out = torch.zeros((idx.shape[0], TILE_ROWS, COLS), dtype=torch.float32, device=tab.device)
    for s in range(idx.shape[0]):
        for c0 in range(0, idx.shape[1], 4096):
            out[s] += tab3[idx[s, c0: c0 + 4096].long()].sum(0)
    return out


def dyn_rmw_plain(idx: torch.Tensor, tab_blocks: int) -> torch.Tensor:
    """P2: the scratch after `scratch[r] += 1` for every r of idx[s]:
    row-block b holds bincount(idx[s])[b] -> (S, B, 8, 128) f32."""
    cnt = torch.stack([torch.bincount(row.long(), minlength=tab_blocks) for row in idx])
    return cnt.float()[:, :, None, None].expand(-1, -1, TILE_ROWS, COLS).contiguous()


def row_copy_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P3: each stream's ring after its last op: slot i % 16 holds
    tab[idx[s, i]] for the last 16 ops i -> (S, 16, C) f32 for a (rows, C)
    table."""
    n = idx.shape[1]
    out = torch.empty((idx.shape[0], DEPTH, tab.shape[1]), dtype=tab.dtype, device=tab.device)
    slots = torch.arange(n - DEPTH, n, device=tab.device) % DEPTH
    out[:, slots] = tab[idx[:, n - DEPTH:].long()]
    return out


def lane_gather_plain(tab: torch.Tensor, ids: torch.Tensor, n_ops: int) -> torch.Tensor:
    """P4: sum over ops i of torch.gather(tab, columns, ids[i % 64]) ->
    (S, 8, 128) f32."""
    acc = torch.zeros_like(tab)
    rows = ids.long()[:, None, None, :].expand(-1, tab.shape[0], TILE_ROWS, -1)
    for i in range(n_ops):
        acc += torch.gather(tab, 2, rows[i % ID_ROWS])
    return acc


# ---- CUDA kernels: build, bind, launch ----


def build_kernel() -> ctypes.CDLL:
    """Build csrc/probe_prims.cu (P1-P4) for sm_90a (once per source
    content) and load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_max_shared.argtypes = [ci]
    lib.probe_dyn_load.argtypes = [ci, vp, ci, vp, ci, ci, vp, vp]
    lib.probe_dyn_rmw.argtypes = [ci, ci, vp, ci, ci, vp, vp]
    lib.probe_row_copy.argtypes = [ci, vp, ci, vp, ci, ci, vp, vp]
    lib.probe_lane_gather.argtypes = [ci, vp, vp, ci, ci, vp, vp]
    for fn in (lib.probe_max_shared, lib.probe_dyn_load, lib.probe_dyn_rmw,
               lib.probe_row_copy, lib.probe_lane_gather):
        fn.restype = ci
    lib.probe_error_string.argtypes = [ci]
    lib.probe_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"probe kernel: {msg}")


def _dev_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tensors(dev: torch.device, floats: list, ints: list) -> None:
    _check(dev.type == "cuda", f"tensors must be CUDA tensors, got {dev}")
    _check(all(t.dtype == torch.float32 for t in floats),
           f"tables are float32, got {[t.dtype for t in floats]}")
    _check(all(t.dtype == torch.int32 for t in ints), "indices must be int32")
    for t in floats + ints:
        _check(t.device == dev, f"tensor on {t.device}, expected {dev}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
               "tensors must be contiguous and 16-byte aligned")


def _raise_on(lib, name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.probe_error_string(code).decode()} ({code})")


def table_blocks(device: str | torch.device = "cuda") -> int:
    """The most (8, 128) f32 row-blocks P1/P2's shared-memory table holds on
    this card: what a block may ask for, less the index buffer."""
    lib = build_kernel()
    dev = torch.device(device)
    limit = lib.probe_max_shared(dev.index if dev.index is not None
                                 else torch.cuda.current_device())
    if limit < 0:
        _raise_on(lib, "probe_max_shared", -limit)
    return (limit - _IDX_BYTES) // (TILE_ROWS * COLS * 4)


def _launch_dyn_load(tab: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    """P1. Validates what the kernel assumes and raises on anything it
    does not take (index ranges are the public function's to check)."""
    _check_tensors(tab.device, [tab, out], [idx])
    _check(tab.dim() == 2 and tab.shape[1] == COLS and tab.shape[0] % TILE_ROWS == 0
           and tab.shape[0] > 0, f"table {tuple(tab.shape)}: want (8 * B, 128)")
    blocks = tab.shape[0] // TILE_ROWS
    _check(blocks <= table_blocks(tab.device),
           f"{blocks} row-blocks do not fit a block's shared memory "
           f"({table_blocks(tab.device)} do)")
    _check(idx.dim() == 2 and out.shape == (idx.shape[0], TILE_ROWS, COLS),
           f"idx {tuple(idx.shape)} / out {tuple(out.shape)} disagree")
    lib = build_kernel()
    _raise_on(lib, "probe_dyn_load", lib.probe_dyn_load(
        _dev_index(tab), tab.data_ptr(), blocks, idx.data_ptr(), idx.shape[0],
        idx.shape[1], out.data_ptr(), _stream(tab)))
    LAUNCHES["P1"] += idx.shape[0] > 0


def _launch_dyn_rmw(idx: torch.Tensor, out: torch.Tensor) -> None:
    """P2; out (S, B, 8, 128) names the scratch's size."""
    _check_tensors(idx.device, [out], [idx])
    _check(idx.dim() == 2 and out.dim() == 4
           and out.shape == (idx.shape[0], out.shape[1], TILE_ROWS, COLS) and out.shape[1] > 0,
           f"idx {tuple(idx.shape)} / out {tuple(out.shape)} disagree")
    _check(out.shape[1] <= table_blocks(idx.device),
           f"{out.shape[1]} row-blocks do not fit a block's shared memory")
    lib = build_kernel()
    _raise_on(lib, "probe_dyn_rmw", lib.probe_dyn_rmw(
        _dev_index(idx), out.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1],
        out.data_ptr(), _stream(idx)))
    LAUNCHES["P2"] += idx.shape[0] > 0


def _launch_row_copy(tab: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    """P3, on a (rows, 128) or (rows, 64) table: 512- or 256-byte rows."""
    _check_tensors(tab.device, [tab, out], [idx])
    _check(tab.dim() == 2 and tab.shape[1] in ROW_COLS and tab.shape[0] > 0,
           f"table {tuple(tab.shape)}: want (rows, 128) or (rows, 64)")
    _check(idx.dim() == 2 and idx.shape[1] >= DEPTH,
           f"idx {tuple(idx.shape)}: want (streams, ops) with ops >= {DEPTH}")
    _check(out.shape == (idx.shape[0], DEPTH, tab.shape[1]), f"out {tuple(out.shape)}")
    lib = build_kernel()
    _raise_on(lib, "probe_row_copy", lib.probe_row_copy(
        _dev_index(tab), tab.data_ptr(), tab.shape[1] * 4, idx.data_ptr(), idx.shape[0],
        idx.shape[1], out.data_ptr(), _stream(tab)))
    LAUNCHES["P3"] += idx.shape[0] > 0


def _launch_lane_gather(tab: torch.Tensor, ids: torch.Tensor, n_ops: int,
                        out: torch.Tensor) -> None:
    """P4."""
    _check_tensors(tab.device, [tab, out], [ids])
    _check(tab.dim() == 3 and tab.shape[1:] == (TILE_ROWS, COLS) and out.shape == tab.shape,
           f"tiles {tuple(tab.shape)} / out {tuple(out.shape)}: want (S, 8, 128)")
    _check(ids.shape == (ID_ROWS, COLS), f"ids {tuple(ids.shape)}: want (64, 128)")
    _check(n_ops >= 0, f"n_ops {n_ops}")
    lib = build_kernel()
    _raise_on(lib, "probe_lane_gather", lib.probe_lane_gather(
        _dev_index(tab), tab.data_ptr(), ids.data_ptr(), tab.shape[0], n_ops,
        out.data_ptr(), _stream(tab)))
    LAUNCHES["P4"] += tab.shape[0] > 0


def _on_card(name: str, t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _in_range(name: str, idx: torch.Tensor, hi: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= hi):
        raise ValueError(f"{name}: indices outside [0, {hi})")


def dyn_load(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1 -> (S, 8, 128) f32. tab (8 * B, 128) f32, idx (S, N) int32 in
    [0, B). CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    _in_range("dyn_load", idx, tab.shape[0] // TILE_ROWS)
    if not _on_card("dyn_load", tab):
        return dyn_load_plain(tab, idx)
    out = torch.empty((idx.shape[0], TILE_ROWS, COLS), dtype=torch.float32, device=tab.device)
    _launch_dyn_load(tab, idx, out)
    return out


def dyn_rmw(idx: torch.Tensor, tab_blocks: int) -> torch.Tensor:
    """P2 -> (S, B, 8, 128) f32, each stream's scratch."""
    _in_range("dyn_rmw", idx, tab_blocks)
    if not _on_card("dyn_rmw", idx):
        return dyn_rmw_plain(idx, tab_blocks)
    out = torch.empty((idx.shape[0], tab_blocks, TILE_ROWS, COLS), dtype=torch.float32,
                      device=idx.device)
    _launch_dyn_rmw(idx, out)
    return out


def row_copy(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P3 -> (S, 16, C) f32, each stream's ring. tab (rows, C) f32 with C
    = 128 or 64, idx (S, N >= 16) int32 in [0, rows)."""
    _in_range("row_copy", idx, tab.shape[0])
    if idx.dim() != 2 or idx.shape[1] < DEPTH:
        raise ValueError(f"row_copy: idx {tuple(idx.shape)} needs at least {DEPTH} ops")
    if not _on_card("row_copy", tab):
        return row_copy_plain(tab, idx)
    out = torch.empty((idx.shape[0], DEPTH, tab.shape[1]), dtype=torch.float32,
                      device=tab.device)
    _launch_row_copy(tab, idx, out)
    return out


def lane_gather(tab: torch.Tensor, ids: torch.Tensor, n_ops: int) -> torch.Tensor:
    """P4 -> (S, 8, 128) f32. tab (S, 8, 128) f32, ids (64, 128) int32 in
    [0, 128)."""
    _in_range("lane_gather", ids, COLS)
    if not _on_card("lane_gather", tab):
        return lane_gather_plain(tab, ids, n_ops)
    out = torch.empty_like(tab)
    _launch_lane_gather(tab, ids, n_ops, out)
    return out


# ---- the probe run ----


def _ms(fn, iters: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _close(name: str, got: torch.Tensor, ref: torch.Tensor, exact: bool) -> float:
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if exact and not torch.equal(got, ref):
        raise AssertionError(f"{name}: differs from the plain version (max abs err {err:.3e})")
    if not bool(torch.isfinite(got).all()) or err > 1e-4 * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} > 1e-4 * max|ref| {scale:.3e}")
    return err


def _card(device) -> tuple[torch.device, int, int]:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("probe_prims measures the card: no CUDA device")
    return dev, torch.cuda.get_device_properties(dev).multi_processor_count, table_blocks(dev)


class Inputs:
    """Seeded inputs on the card at the grids that fill it: P1/P2 one block
    (one stream) an SM, since a block's table takes an SM's shared memory; P3
    three blocks of 8 warps (64 KB of rings each) an SM; P4 eight blocks of 8
    warps an SM. Each method seeds its own generator, so a caller that asks
    again with the same arguments holds the tensors `measure` ran on."""

    def __init__(self, dev: torch.device, sms: int, seed: int):
        self.dev, self.seed = dev, seed
        self.tile_streams, self.copy_streams = sms, sms * 3 * WARPS
        self.gather_streams = sms * 8 * WARPS

    def _draw(self, tag: int, hi: int, int_shape: tuple, float_shape: tuple):
        gen = torch.Generator(device=self.dev).manual_seed(self.seed * 8 + tag)
        floats = torch.randn(*float_shape, generator=gen, device=self.dev)
        return floats, torch.randint(0, hi, int_shape, generator=gen, device=self.dev,
                                     dtype=torch.int32)

    def tiles(self, blocks: int, n_ops: int):
        """P1/P2: the (8 * blocks, 128) table and (streams, n_ops) indices."""
        return self._draw(1, blocks, (self.tile_streams, n_ops), (blocks * TILE_ROWS, COLS))

    def copies(self, rows: int, n_ops: int, cols: int = COLS):
        """P3: the (rows, cols) table and (streams, n_ops) row indices; at 64
        columns (256-byte rows) a half-warp is a stream, so twice the
        streams fill the same grid."""
        streams = self.copy_streams * (COLS // cols)
        return self._draw(2 if cols == COLS else 4, rows, (streams, n_ops), (rows, cols))

    def gathers(self):
        """P4: the (streams, 8, 128) tiles and the (64, 128) id rows."""
        return self._draw(3, COLS, (ID_ROWS, COLS), (self.gather_streams, TILE_ROWS, COLS))


def card_inputs(device: str | torch.device = "cuda", seed: int = 0) -> tuple[Inputs, int]:
    """(the inputs `measure` draws for this seed, the table's row-blocks)."""
    dev, sms, blocks = _card(device)
    return Inputs(dev, sms, seed), blocks


def check_against_plain(device: str | torch.device = "cuda", check_ops: int = 2000,
                        dma_rows: int = 65_536, seed: int = 0) -> dict:
    """A fast first check at check_ops ops a stream (not a multiple of the
    kernels' index rounds, so their tails run), every stream of a full grid:
    P2 and P3 bit for bit, P1 and P4 to 1e-4 * max|ref|. Returns {"P1": max
    abs err, ...}; raises AssertionError where a kernel disagrees. `measure`
    makes the same comparison at the shape it times."""
    inp, blocks = card_inputs(device, seed)
    tab, idx = inp.tiles(blocks, check_ops)
    errs = {"P1": _close("P1", dyn_load(tab, idx), dyn_load_plain(tab, idx), exact=False),
            "P2": _close("P2", dyn_rmw(idx, blocks), dyn_rmw_plain(idx, blocks), exact=True)}
    errs["P3"] = 0.0
    for cols in ROW_COLS:
        tab, idx = inp.copies(dma_rows, max(check_ops, DEPTH), cols)
        errs["P3"] = max(errs["P3"], _close(f"P3 ({cols * 4}-byte rows)", row_copy(tab, idx),
                                            row_copy_plain(tab, idx), exact=True))
    tiles, ids = inp.gathers()
    errs["P4"] = _close("P4", lane_gather(tiles, ids, check_ops),
                        lane_gather_plain(tiles, ids, check_ops), exact=False)
    return errs


def measure(device: str | torch.device = "cuda", n_ops: int = 100_000,
            dma_rows: tuple = DMA_ROWS, half_rows: tuple = (HALF_ROWS_60MB,),
            seed: int = 0, probes: tuple = tuple(LAUNCHES)) -> dict:
    """Time each kernel at n_ops ops a stream on one block (the per-SM
    rate) and on a grid that fills the card (P3 and P4 on one stream too).
    The plain version runs on the same inputs at the card's grid: it is
    timed, and the timed launch's output is held against it (P2
    and P3 bit for bit, P1 and P4 to 1e-4 * max|ref|; `max_abs_err`, for P3
    the largest over the tables), so what is compared is what is timed.
    Returns {"P1": {...}, ...}: per grid the ms, ops/s and, where an op
    moves bytes, bytes/s; P3 per table size (`dma_rows`: 32 MB stays in the
    L2, 60 MB is K1's table, 119 MB K3's, 1 GB does not fit) and, for each
    of `half_rows`, at 256-byte rows on a (rows, 64) table
    (`tables_256`)."""
    inp, blocks = card_inputs(device, seed)
    tile_bytes = TILE_ROWS * COLS * 4

    def rates(ms, streams, op_bytes=None):
        ops_s = streams * n_ops / (ms * 1e-3)
        row = {"streams": streams, "ms": ms, "ops_per_s": ops_s}
        if op_bytes:
            row["bytes_per_s"] = ops_s * op_bytes
        return row

    def against_plain(row, name, out, plain_fn, exact):
        ref = [None]

        def call():
            ref[0] = plain_fn()

        row["plain_ms"] = _ms(call, 1)
        row["max_abs_err"] = _close(name, out, ref[0], exact)

    res: dict = {"table_blocks": blocks, "table_bytes": blocks * tile_bytes,
                 "sms": inp.tile_streams, "n_ops": n_ops}
    if "P1" in probes or "P2" in probes:
        _measure_tiles(res, inp, blocks, n_ops, rates, against_plain)
    if "P3" in probes:
        _measure_copies(res, inp, n_ops, dma_rows, half_rows, rates, against_plain)
    if "P4" in probes:
        _measure_gathers(res, inp, n_ops, rates, against_plain)
    return res


def _measure_tiles(res, inp, blocks, n_ops, rates, against_plain):
    dev, tile_bytes = inp.dev, TILE_ROWS * COLS * 4
    streams = inp.tile_streams
    tab, idx = inp.tiles(blocks, n_ops)
    out1 = torch.empty((streams, TILE_ROWS, COLS), device=dev)
    out2 = torch.empty((streams, blocks, TILE_ROWS, COLS), device=dev)
    # the card's grid last, so `out` holds every stream's result
    res["P1"] = {
        "op_bytes": tile_bytes,
        "one_block": rates(_ms(lambda: _launch_dyn_load(tab, idx[:1], out1[:1])), 1, tile_bytes),
        "card": rates(_ms(lambda: _launch_dyn_load(tab, idx, out1)), streams, tile_bytes)}
    res["P2"] = {
        "op_bytes": 2 * tile_bytes,
        "one_block": rates(_ms(lambda: _launch_dyn_rmw(idx[:1], out2[:1])), 1, 2 * tile_bytes),
        "card": rates(_ms(lambda: _launch_dyn_rmw(idx, out2)), streams, 2 * tile_bytes)}
    against_plain(res["P1"], "P1", out1, lambda: dyn_load_plain(tab, idx), exact=False)
    against_plain(res["P2"], "P2", out2, lambda: dyn_rmw_plain(idx, blocks), exact=True)
    del tab, idx, out1, out2


def _measure_copies(res, inp, n_ops, dma_rows, half_rows, rates, against_plain):
    dev = inp.dev
    res["P3"] = {"op_bytes": COLS * 4, "depth": DEPTH, "tables": {}, "tables_256": {}}
    for rows, cols in [(r, COLS) for r in dma_rows] + [(r, COLS // 2) for r in half_rows]:
        tab, idx = inp.copies(rows, n_ops, cols)
        streams, per_warp = idx.shape[0], COLS // cols
        out = torch.empty((streams, DEPTH, cols), device=dev)
        one = idx[:1], out[:1]
        block = idx[:WARPS * per_warp], out[:WARPS * per_warp]
        row = {"table_bytes": rows * cols * 4, "row_bytes": cols * 4,
               "one_stream": rates(_ms(lambda: _launch_row_copy(tab, *one)), 1, cols * 4),
               "one_block": rates(_ms(lambda: _launch_row_copy(tab, *block)),
                                  WARPS * per_warp, cols * 4),
               "card": rates(_ms(lambda: _launch_row_copy(tab, idx, out)), streams, cols * 4)}
        against_plain(row, f"P3 ({rows} rows of {cols * 4} bytes)", out,
                      lambda: row_copy_plain(tab, idx), exact=True)
        res["P3"]["max_abs_err"] = max(row["max_abs_err"], res["P3"].get("max_abs_err", 0.0))
        res["P3"]["tables" if cols == COLS else "tables_256"][str(rows)] = row
        del tab, idx, out


def _measure_gathers(res, inp, n_ops, rates, against_plain):
    streams = inp.gather_streams
    tiles, ids = inp.gathers()
    out = torch.empty_like(tiles)
    shuffles = 4 * 4 * TILE_ROWS  # warp shuffles of one op

    def p4(ms, n):
        row = rates(ms, n)
        row["shuffles_per_s"] = row["ops_per_s"] * shuffles
        row["elements_per_s"] = row["ops_per_s"] * TILE_ROWS * COLS
        return row

    res["P4"] = {
        "shuffles_per_op": shuffles,
        "one_stream": p4(_ms(lambda: _launch_lane_gather(tiles[:1], ids, n_ops, out[:1])), 1),
        "one_block": p4(_ms(lambda: _launch_lane_gather(tiles[:WARPS], ids, n_ops,
                                                        out[:WARPS])), WARPS),
        "card": p4(_ms(lambda: _launch_lane_gather(tiles, ids, n_ops, out)), streams)}
    against_plain(res["P4"], "P4", out, lambda: lane_gather_plain(tiles, ids, n_ops),
                  exact=False)


def run(device: str | torch.device = "cuda", n_ops: int = 100_000, check_ops: int = 2000,
        seed: int = 0, log=print, probes: tuple = tuple(LAUNCHES)) -> dict:
    """The probe: a fast check of P1-P4 against their plain versions, then
    the measurement of `probes`, which holds each timed launch against its
    plain version at n_ops; P3 on the 32 MB, 60 MB, 119 MB and 1 GB tables
    of 512-byte rows and on the 60 MB table of 256-byte rows. Needs a card:
    raises without one."""
    check_against_plain(device, check_ops, seed=seed)
    res = measure(device, n_ops, seed=seed, probes=probes)
    for k in probes:
        log(f"probe {k}: " + json.dumps(res[k]))
    return res


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=100_000, help="ops per stream when timing")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probes", default="P1,P2,P3,P4", help="which probes to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_prims: torch.cuda.is_available() is False: no GPU to measure",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    res = run(args.device, n_ops=args.ops, probes=tuple(args.probes.split(",")))
    print(json.dumps({"probe_prims": res, "launches": LAUNCHES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
