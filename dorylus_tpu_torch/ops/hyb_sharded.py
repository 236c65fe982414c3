"""Sharded hybrid-ELL SpMM: one rank's hyb plans over its vertex shard
(port of dorylus_tpu/ops/hyb_sharded.py).

A shard's edges end in its vp local vertices and start in the feature
table [0, vp + n * max_h): local rows, then the ghost rows of each owner
(graph/partition.py). The plan layouts, as in JAX:

  * edges="combined": the forward plan over the shard's edges and the
    backward plan over their transpose, with num_in = vp + n * max_h. The
    model hands it `halo_exchange`'s full table; the entries are the
    single-device ones (`apply_static`, `apply_dst`, `apply_unit` through
    `HybStaticFn` / `HybDstFn` / `HybUnitFn`).
  * edges="interior" / "boundary": the same entries over the edges whose
    source is a local row (table = h, vp rows) or a ghost row (table = the
    received ghost rows alone, n * max_h rows, sources rebased). The JAX op
    has the pair and its tests hold it; the engines take the fused plan
    for hyb and the pair only for the degree kernel
    (ops/degree_sharded.py).
  * edges="fused" (the overlap plan): ONE forward plan whose buckets come
    in a PURE group then a MIXED group. A vertex is mixed when any in-edge
    source is a ghost or its degree exceeds max_width (hubs are forced
    mixed, so the pure group never owns a chunked top bucket). Pure
    buckets gather from the local (vp, F) rows alone, with no dependency
    on the halo exchange; mixed buckets and the hub top gather from local
    and ghost rows. The entries take (h, ghosts) separately:
    `apply_static_fused`, `apply_dst_fused`, `apply_unit_fused`. The
    backward needs no fusion: it is one pass over the combined transpose
    plan with table = gout into one (vp + n * max_h, F) buffer, whose
    [:vp] / [vp:] rows are dh / dghosts (two views, no copy, no kernel of
    its own: JAX's `_fused_bwd_pass`).

What the port leaves out of the JAX module: `_uniform_plans`, `_pad_rows`,
`_stack_free`, `_pad_idx` and the pooled width DP. They pad every shard's
plan to one shape because shard_map stacks them under one program. Here a
rank owns its plan: it is built over the shard's REAL edges
(`[:num_edges]`, so no pad edge exists and liveness needs no recount) with
the rank's own width DP. dynamic=False only, as the JAX engine builds it.

On the card the forward pass is K8 (csrc/fused_spmm.cu): K1/K2's gather
core with two table pointers, so h and ghosts are never concatenated. The
descriptor of a pure bucket carries no split (it reads h alone), a mixed
bucket's and the hub top's carry split = vp. The engines launch it as two
ranges of the plan's parts, so that the pure buckets run while the halo
exchange is in flight (JAX exposes them to XLA's scheduler beside the
all_to_all, dorylus_tpu/ops/hyb_sharded.py:328-342): `fused_pure_pass`
zeroes the f32 output, casts h once and launches the pure range (none
when the plan has no pure bucket) before the ghosts arrive;
`fused_mixed_pass` casts the ghosts and launches the mixed buckets and
the top into the same output after. The two write disjoint rows, each
summed inside its part by the same code as one launch over every part
(`fused_pass`, which the checks hold the ranges against), so the result
is the same bit for bit. Each dispatches on the device: CPU tensors take
the plain version (`fused_pure_plain` / `fused_mixed_plain`, the halves of
`fused_pass_plain`), CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dorylus_tpu_torch.common.device import resolve_device
from dorylus_tpu_torch.graph.partition import Shard, shard_edges
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.gather_parts import LOCAL_ONLY, PartTable, gather_table
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan
from dorylus_tpu_torch.ops.hyb_spmm import (HybDstFn, HybStaticFn, HybUnitFn, _hyb_pass,
                                            _hyb_pass_plain, _is_narrow, _upload,
                                            launch_parts, reduce_slots_plain)

# K8 launches made by this process (one a fused pass in one launch, one a
# range), and those of them over a pure range.
FUSED_LAUNCHES = 0
FUSED_PURE_LAUNCHES = 0

_CSRC = cuda_build.CSRC / "fused_spmm.cu"
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def build_kernel() -> ctypes.CDLL:
    """Build csrc/fused_spmm.cu (K8) for sm_90a (once per source content)
    and load it. Raises when nvcc fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = cuda_build.load(_CSRC)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_pass.argtypes = [ci, ci, ci, vp, vp, ci, ci, ci, vp, ci, ci, ci, vp, vp]
    lib.fused_pass.restype = ci
    lib.fused_error_string.argtypes = [ci]
    lib.fused_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _launch_fused_pass(tb_h: torch.Tensor, tb_g: torch.Tensor, plan: dict,
                       out: torch.Tensor, unit: bool) -> int:
    """K8 over every part of `plan` (the fused plan, or one of its ranges,
    `plan["pure"]` / `plan["mixed"]`): a slot index s below a part's split
    (vp for mixed parts) reads tb_h[s], any other tb_g[s - vp]; the part's
    values weigh the rows (static) or 1 does (unit=True, mask mode). tb_h
    and tb_g are laid out by `gather_table`. Raises on anything the kernel
    does not take. Returns the launches made."""
    global FUSED_LAUNCHES, FUSED_PURE_LAUNCHES
    launched = launch_parts(build_kernel, "fused_pass", [tb_h, tb_g], plan, out, unit)
    FUSED_LAUNCHES += launched
    if plan.get("range") == "pure":
        FUSED_PURE_LAUNCHES += launched
    return launched


class PureRange(NamedTuple):
    """What the pure range leaves for the mixed one: the (vp, F) f32
    output with the pure buckets' rows written, and h as the pass reads it
    (cast to the gather dtype once; on the card laid out by
    `gather_table`)."""

    out: torch.Tensor
    h_table: torch.Tensor


def _place_plain(out: torch.Tensor, tb: torch.Tensor, parts, narrow: bool,
                 mode: str) -> None:
    """Each part's f32 sums into its rows of out (the hub top's chunk rows
    added per hub first), as `_hyb_pass_plain` computes them."""
    for part in parts:
        sums, _ = reduce_slots_plain(tb, part, narrow, mode)
        if "rowv" in part:
            sums = torch.zeros((part["v"].shape[0], out.shape[1]), dtype=torch.float32,
                               device=out.device).index_add_(0, part["rowv"], sums)
        out[part["v"].long()] = sums


def fused_pure_plain(h: torch.Tensor, plan: dict, n_pure: int,
                     gather_dtype: torch.dtype | None, mode: str) -> PureRange:
    """The pure half of `fused_pass_plain`: the first n_pure buckets, which
    gather h alone, into a zeroed (vp, F) f32 output."""
    tb_h = h if gather_dtype is None else h.to(gather_dtype)
    out = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    _place_plain(out, tb_h, plan["buckets"][:n_pure], _is_narrow(gather_dtype), mode)
    return PureRange(out, tb_h)


def fused_mixed_plain(pure: PureRange, ghosts: torch.Tensor, plan: dict, n_pure: int,
                      gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """The mixed half of `fused_pass_plain`: the other buckets and the hub
    top over concat(h, ghosts), into pure.out, which it returns."""
    tb_g = ghosts if gather_dtype is None else ghosts.to(gather_dtype)
    parts = list(plan["buckets"][n_pure:]) + ([plan["top"]] if plan["top"] is not None else [])
    _place_plain(pure.out, torch.cat([pure.h_table, tb_g], dim=0), parts,
                 _is_narrow(gather_dtype), mode)
    return pure.out


def fused_pass_plain(h: torch.Tensor, ghosts: torch.Tensor, plan: dict, n_pure: int,
                     gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """The fused forward pass in plain torch (JAX `_fused_fwd_pass`): the
    first n_pure buckets gather h, the rest concat(h, ghosts) -> (vp, F)
    f32. Works on tensors of any device; `fused_pass` routes only CPU
    tensors here."""
    return _hyb_pass_plain(torch.cat([h, ghosts], dim=0), plan, h.shape[0], gather_dtype,
                           mode, h_local=h, n_pure=n_pure)


def _check_fused(h: torch.Tensor, mode: str, entry: str) -> None:
    if mode not in ("static", "mask"):
        raise ValueError(f"{entry}: mode {mode!r} (static or mask)")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{entry}: unsupported device {h.device}")


def fused_pass(h: torch.Tensor, ghosts: torch.Tensor, plan: dict, n_pure: int,
               gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """The fused forward pass in one launch -> (vp, F) f32 (the engines
    run it as two ranges, `fused_pure_pass` then `fused_mixed_pass`, which
    the checks hold against it). CPU tensors run the plain version. CUDA
    tensors run K8 once over the pure buckets (which read h alone), the
    mixed buckets and the hub top; h and ghosts are each cast once to the
    gather dtype. Anything else raises."""
    _check_fused(h, mode, "fused_pass")
    if h.device.type == "cpu":
        return fused_pass_plain(h, ghosts, plan, n_pure, gather_dtype, mode)
    if h.device.type != "cuda" or ghosts.device != h.device:
        raise ValueError(f"fused_pass: h on {h.device}, ghosts on {ghosts.device}")
    if h.dim() != 2 or ghosts.dim() != 2 or h.shape[0] + ghosts.shape[0] < plan["n_src"]:
        raise ValueError(f"fused_pass: h {tuple(h.shape)} + ghosts {tuple(ghosts.shape)} "
                         f"hold fewer than the plan's {plan['n_src']} source rows")
    dt = gather_dtype if _is_narrow(gather_dtype) else torch.float32
    out = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    _launch_fused_pass(gather_table(h, dt), gather_table(ghosts, dt), plan, out, mode == "mask")
    return out


def fused_pure_pass(h: torch.Tensor, plan: dict, n_pure: int,
                    gather_dtype: torch.dtype | None, mode: str) -> PureRange:
    """K8's pure range: zero the (vp, F) f32 output, cast h once to the
    gather dtype, and launch the pure buckets (which read h alone; no
    launch where the plan has none). CPU tensors run the plain half."""
    _check_fused(h, mode, "fused_pure_pass")
    if h.device.type == "cpu":
        return fused_pure_plain(h, plan, n_pure, gather_dtype, mode)
    dt = gather_dtype if _is_narrow(gather_dtype) else torch.float32
    out = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    tb_h = gather_table(h, dt)
    if plan["pure"]["parts"].parts:
        # the pure parts never read the second table: it holds no row
        _launch_fused_pass(tb_h, tb_h[:0], plan["pure"], out, mode == "mask")
    return PureRange(out, tb_h)


def fused_mixed_pass(pure: PureRange, ghosts: torch.Tensor, plan: dict, n_pure: int,
                     gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """K8's mixed range after `fused_pure_pass`: cast the ghosts once and
    launch the mixed buckets and the hub top into pure.out, which it
    returns (the (vp, F) f32 fused pass). CPU tensors run the plain half."""
    out = pure.out
    _check_fused(out, mode, "fused_mixed_pass")
    if out.device.type == "cpu":
        return fused_mixed_plain(pure, ghosts, plan, n_pure, gather_dtype, mode)
    if ghosts.device != out.device or ghosts.dim() != 2 or (
            out.shape[0] + ghosts.shape[0] < plan["n_src"]):
        raise ValueError(f"fused_mixed_pass: ghosts {tuple(ghosts.shape)} on {ghosts.device} "
                         f"for {out.shape[0]} local rows on {out.device} and a plan of "
                         f"{plan['n_src']} source rows")
    if plan["mixed"]["parts"].parts:
        _launch_fused_pass(pure.h_table, gather_table(ghosts, pure.h_table.dtype),
                           plan["mixed"], out, mode == "mask")
    return out


def _merge_fused(pure: dict, mixed: dict, num_out: int) -> dict:
    """One forward plan from the pure and the mixed subset plans: pure
    buckets, then mixed buckets, hubs only in the mixed top, and one
    vertex -> output position map over [pure | mixed | hubs | zero row]."""
    assert pure["top"] is None, "hubs must be mixed"
    buckets = tuple(pure["buckets"]) + tuple(mixed["buckets"])
    top = mixed["top"]
    n_active = sum(len(b["v"]) for b in buckets) + (len(top["v"]) if top else 0)
    inv = np.full(num_out, n_active, np.int64)
    pos = 0
    for part in buckets + ((top,) if top is not None else ()):
        inv[part["v"]] = np.arange(pos, pos + len(part["v"]))
        pos += len(part["v"])
    return {"buckets": buckets, "top": top, "inv": inv.astype(np.int32)}


class ShardedHybSpMM:
    """One rank's hyb plans over its shard (JAX: ops/hyb_sharded.
    ShardedHybSpMM, one slice of its stacked arrays).

    shard: the rank's `Shard`; n: the number of shards. edges: "combined",
    "fused", or one half of the split, "interior" / "boundary" (table = h /
    the ghost rows). static_vals: bake
    the shard's edge values (the GCN norms) into the plans (`apply_static`
    / `apply_static_fused`); without them the plans serve the unit-weight
    entries (GAT). gather_dtype as in HybSpMM.

    device: None means the card and raises without one; the CPU only when
    the caller passes device="cpu"."""

    def __init__(self, shard: Shard, n: int, edges: str = "combined",
                 static_vals: bool = False, gather_dtype: torch.dtype | None = None,
                 max_width: int = 512, lam_slots: int = _LAMBDA_SLOTS,
                 device: str | torch.device | None = None):
        device = resolve_device(device)
        if edges not in ("combined", "fused", "interior", "boundary"):
            raise ValueError(f"ShardedHybSpMM edges={edges!r}: \"combined\", \"fused\", "
                             "\"interior\" or \"boundary\"")
        src, dst, val = shard_edges(shard, "combined" if edges == "fused" else edges)
        val = np.asarray(val, np.float32) if static_vals else None
        ne = len(src)
        if ne and (np.diff(dst) < 0).any():
            raise ValueError("shard edges must be dst-sorted")
        vp, max_h = int(shard.x.shape[0]), int(shard.send_idx.shape[1])
        table = {"interior": vp, "boundary": n * max_h}.get(edges, vp + n * max_h)
        if ne and (src.min() < 0 or src.max() >= table or dst.min() < 0 or dst.max() >= vp):
            raise ValueError("shard edge endpoint out of range")
        self.vp, self.table = vp, table
        self.num_in, self.num_out = table, vp
        self.edges = edges
        self.fused = edges == "fused"
        self.n_pure = 0
        self.gather_dtype = gather_dtype
        self.has_static_vals = static_vals
        self.dynamic = False
        self.device = torch.device(device)
        if self.fused:
            # JAX `_build_fused`: classify the vertices, one plan per
            # subset (a subset of dst-sorted edges stays dst-sorted).
            deg = np.bincount(dst, minlength=vp)
            ghost_dst = np.zeros(vp, bool)
            ghost_dst[dst[src >= vp]] = True
            mixed_e = (ghost_dst | (deg > max_width))[dst]
            parts = []
            for idx in (np.where(~mixed_e)[0], np.where(mixed_e)[0]):
                parts.append(build_hyb_plan(
                    src[idx], dst[idx], None, vp, max_width, lam_slots,
                    static_val=None if val is None else val[idx]))
            fwd = _merge_fused(parts[0], parts[1], vp)
            self.n_pure = len(parts[0]["buckets"])
            self.pure_edges, self.mixed_edges = int((~mixed_e).sum()), int(mixed_e.sum())
        else:
            fwd = build_hyb_plan(src, dst, None, vp, max_width, lam_slots, val)
        order = np.argsort(src, kind="stable")
        bwd = build_hyb_plan(dst[order], src[order], order, table, max_width,
                             lam_slots, val)
        vals_dtype = gather_dtype if _is_narrow(gather_dtype) else torch.float32
        self.fwd = _upload(fwd, int(src.max()) + 1 if ne else 0, vals_dtype, self.device)
        self.bwd = _upload(bwd, int(dst.max()) + 1 if ne else 0, vals_dtype, self.device)
        if self.fused:
            # K8's descriptors: the pure buckets read h alone, the mixed
            # buckets and the hub top split their slots at vp
            f = self.fwd
            parts = list(f["buckets"]) + ([f["top"]] if f["top"] is not None else [])
            f["parts"] = PartTable(parts, [LOCAL_ONLY] * self.n_pure
                                   + [vp] * (len(parts) - self.n_pure))
            f["vp"] = vp
            # the same descriptors as two ranges, launched either side of
            # the exchange's finish (fused_pure_pass / fused_mixed_pass)
            n_mixed = len(parts) - self.n_pure
            f["pure"] = {"parts": PartTable(parts[: self.n_pure]), "n_src": vp, "vp": vp,
                         "range": "pure"}
            f["mixed"] = {"parts": PartTable(parts[self.n_pure:], [vp] * n_mixed),
                          "n_src": f["n_src"], "vp": vp}

    def _pass(self, table, plan, num_out, mode, val=None, other=None):
        return _hyb_pass(table, plan, num_out, self.gather_dtype, mode, val, other)

    def pure_range(self, h: torch.Tensor, mode: str) -> PureRange:
        """The fused forward's pure range over h (the buckets whose in-edges
        are all local), for the entries' `pure`: issued while the halo
        exchange of h is in flight. Made outside autograd: the entries'
        backward is the whole gradient, through h. mode: "static" (GCN's
        `apply_static_fused`) or "mask" (`apply_unit_fused`,
        `apply_dst_fused`)."""
        self._need(True, "pure_range")
        with torch.no_grad():
            return fused_pure_pass(h, self.fwd, self.n_pure, self.gather_dtype, mode)

    def _fwd_fused(self, h: torch.Tensor, ghosts: torch.Tensor, mode: str,
                   pure: PureRange | None) -> torch.Tensor:
        if pure is None:
            pure = fused_pure_pass(h, self.fwd, self.n_pure, self.gather_dtype, mode)
        return fused_mixed_pass(pure, ghosts, self.fwd, self.n_pure, self.gather_dtype, mode)

    def _need(self, fused: bool, entry: str) -> None:
        if self.fused != fused:
            raise RuntimeError(f"{entry}: op built with edges={self.edges!r}")

    # combined plan: the table is halo_exchange's (vp + n * max_h, F);
    # interior: h (vp, F); boundary: the ghost rows (n * max_h, F)
    def apply_static(self, table: torch.Tensor) -> torch.Tensor:
        self._need(False, "apply_static")
        if not self.has_static_vals:
            raise RuntimeError("op built without static values: use "
                               "apply_unit / apply_dst")
        return HybStaticFn.apply(table, self)

    def apply_unit(self, table: torch.Tensor) -> torch.Tensor:
        self._need(False, "apply_unit")
        return HybUnitFn.apply(table, self)

    def apply_dst(self, table: torch.Tensor, dst_val: torch.Tensor) -> torch.Tensor:
        self._need(False, "apply_dst")
        return HybDstFn.apply(table, dst_val, self)

    # fused plan: local rows and ghost rows apart; pure: `pure_range(h, mode)`
    # made beforehand (None: made here)
    def apply_static_fused(self, h: torch.Tensor, ghosts: torch.Tensor,
                           pure: PureRange | None = None) -> torch.Tensor:
        self._need(True, "apply_static_fused")
        if not self.has_static_vals:
            raise RuntimeError("op built without static values: use "
                               "apply_unit_fused / apply_dst_fused")
        return FusedFn.apply(h, ghosts, None, self, "static", pure)

    def apply_unit_fused(self, h: torch.Tensor, ghosts: torch.Tensor,
                         pure: PureRange | None = None) -> torch.Tensor:
        self._need(True, "apply_unit_fused")
        return FusedFn.apply(h, ghosts, None, self, "mask", pure)

    def apply_dst_fused(self, h: torch.Tensor, ghosts: torch.Tensor,
                        dst_val: torch.Tensor, pure: PureRange | None = None) -> torch.Tensor:
        self._need(True, "apply_dst_fused")
        return FusedFn.apply(h, ghosts, dst_val, self, "mask", pure)


class FusedFn(torch.autograd.Function):
    """The fused-overlap entries (JAX: `fused_static_apply`,
    `fused_unit_apply`, `fused_dst_apply` with their custom VJPs). Forward:
    the two-table pass, its mixed range added to `pure` (the pure range,
    made before the ghosts arrived; made here when None), and with dst_val
    the row scale out[v] = dst_val[v] * u[v]. Backward: one pass over the
    combined transpose plan with table = gout (scaled by dst_val in f32
    first, as JAX does) into one (vp + n * max_h, F) buffer; its [:vp] rows
    are dh (the pure buckets' share included), its [vp:] rows dghosts, each
    cast to its input's dtype; d_dst = rowsum(u * gout) in f32 from the
    saved unscaled u."""

    @staticmethod
    def forward(ctx, h, ghosts, dst_val, op, mode, pure=None):
        u = op._fwd_fused(h, ghosts, mode, pure)
        ctx.op, ctx.mode = op, mode
        ctx.h_dtype, ctx.g_dtype = h.dtype, ghosts.dtype
        ctx.h_rows, ctx.g_rows = h.shape[0], ghosts.shape[0]
        if dst_val is None:
            ctx.scaled = False
            return u
        ctx.scaled = True
        ctx.save_for_backward(u, dst_val)
        return u * dst_val.float()[:, None]

    @staticmethod
    def backward(ctx, gout):
        op = ctx.op
        gout = gout.float()
        d_dst = None
        table_grad = gout
        if ctx.scaled:
            u, dst_val = ctx.saved_tensors
            table_grad = gout * dst_val.float()[:, None]
            if ctx.needs_input_grad[2]:
                d_dst = (u * gout).sum(-1).to(dst_val.dtype)
        dh = dg = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dfull = op._pass(table_grad.contiguous(), op.bwd, op.table, ctx.mode)
            dh = dfull[: ctx.h_rows].to(ctx.h_dtype)
            dg = dfull[op.vp: op.vp + ctx.g_rows].to(ctx.g_dtype)
        return dh, dg, d_dst, None, None, None
