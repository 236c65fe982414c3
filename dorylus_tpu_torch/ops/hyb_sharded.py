"""Sharded hybrid-ELL SpMM: one rank's hyb plans over its vertex shard
(port of dorylus_tpu/ops/hyb_sharded.py).

A shard's edges end in its vp local vertices and start in the feature
table [0, vp + n * max_h): local rows, then the ghost rows of each owner
(graph/partition.py). Two plan layouts, as in JAX:

  * edges="combined": the forward plan over the shard's edges and the
    backward plan over their transpose, with num_in = vp + n * max_h. The
    model hands it `halo_exchange`'s full table; the entries are the
    single-device ones (`apply_static`, `apply_dst`, `apply_unit` through
    `HybStaticFn` / `HybDstFn` / `HybUnitFn`).
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

On the card the mixed part is K8 (csrc/fused_spmm.cu): K1/K2's work shape
with two table pointers, so h and ghosts are never concatenated; the pure
buckets run the one-table kernel (K1/K2) on h. `fused_pass` dispatches on
the device: CPU tensors take the plain version (`_hyb_pass_plain` with
`h_local` / `n_pure`), CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dorylus_tpu_torch.graph.partition import Shard
from dorylus_tpu_torch.ops import cuda_build
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS, build_hyb_plan
from dorylus_tpu_torch.ops.hyb_spmm import (_DTYPE_CODE, HybDstFn, HybStaticFn,
                                            HybUnitFn, _check, _check_part,
                                            _device_index, _hyb_pass,
                                            _hyb_pass_plain, _is_narrow,
                                            _launch_part, _upload)

# K8 launches made by this process, one per mixed plan part.
FUSED_LAUNCHES = 0

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
    lib.fused_part.argtypes = [ci, ci, vp, vp, ci, ci, vp, vp, vp, ci, vp, vp, ci, vp, vp]
    lib.fused_part.restype = ci
    lib.fused_error_string.argtypes = [ci]
    lib.fused_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(info)
    _lib = lib
    return lib


def _launch_fused_part(tb_h: torch.Tensor, tb_g: torch.Tensor, part: dict,
                       out: torch.Tensor, unit: bool) -> bool:
    """Launch K8 for one mixed plan part: slot index s < len(tb_h) reads
    tb_h[s], any other tb_g[s - len(tb_h)]; the part's values weigh the
    rows (static) or 1 does (unit=True, mask mode). Validates everything
    the kernel assumes and raises on anything it does not take. Returns
    whether it launched."""
    global FUSED_LAUNCHES
    vals = None if unit else part.get("vals")
    _check(unit or vals is not None, "static mode needs a plan with values")
    n_out = _check_part(tb_h, part, out, [], [tb_g] + ([vals] if vals is not None else []))
    _check(tb_g.dtype == tb_h.dtype and tb_g.dim() == 2 and tb_g.shape[1] == tb_h.shape[1],
           f"ghosts {tb_g.dtype} {tuple(tb_g.shape)} / h {tb_h.dtype} "
           f"{tuple(tb_h.shape)} disagree")
    _check(vals is None or (vals.dtype == tb_h.dtype and vals.shape == part["rows"].shape),
           "vals must match the table dtype and the slot grid")
    if n_out == 0:
        return False
    rows, row_ptr = part["rows"], part.get("row_ptr")
    lib = build_kernel()
    code = lib.fused_part(
        _device_index(tb_h), _DTYPE_CODE[tb_h.dtype], tb_h.data_ptr(), tb_g.data_ptr(),
        tb_h.shape[0], tb_h.shape[1], rows.data_ptr(),
        vals.data_ptr() if vals is not None else None, part["cnt"].data_ptr(),
        rows.shape[1], row_ptr.data_ptr() if row_ptr is not None else None,
        part["v"].data_ptr(), n_out, out.data_ptr(),
        torch.cuda.current_stream(tb_h.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"fused_part ({'mask' if unit else 'static'}) launch "
                           f"failed: {lib.fused_error_string(code).decode()} ({code})")
    FUSED_LAUNCHES += 1
    return True


def fused_pass_plain(h: torch.Tensor, ghosts: torch.Tensor, plan: dict, n_pure: int,
                     gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """The fused forward pass in plain torch (JAX `_fused_fwd_pass`): the
    first n_pure buckets gather h, the rest concat(h, ghosts) -> (vp, F)
    f32. Works on tensors of any device; `fused_pass` routes only CPU
    tensors here."""
    return _hyb_pass_plain(torch.cat([h, ghosts], dim=0), plan, h.shape[0], gather_dtype,
                           mode, h_local=h, n_pure=n_pure)


def fused_pass(h: torch.Tensor, ghosts: torch.Tensor, plan: dict, n_pure: int,
               gather_dtype: torch.dtype | None, mode: str) -> torch.Tensor:
    """The fused forward pass -> (vp, F) f32. CPU tensors run the plain
    version. CUDA tensors run the pure buckets on K1/K2 over h, launched
    first (they need no ghost row), then the mixed buckets and the hub top
    on K8 over the two tables; h and ghosts are each cast once to the
    gather dtype. Anything else raises."""
    if mode not in ("static", "mask"):
        raise ValueError(f"fused_pass: mode {mode!r} (static or mask)")
    if h.device.type == "cpu":
        return fused_pass_plain(h, ghosts, plan, n_pure, gather_dtype, mode)
    if h.device.type != "cuda" or ghosts.device != h.device:
        raise ValueError(f"fused_pass: h on {h.device}, ghosts on {ghosts.device}")
    if h.dim() != 2 or ghosts.dim() != 2 or h.shape[0] + ghosts.shape[0] < plan["n_src"]:
        raise ValueError(f"fused_pass: h {tuple(h.shape)} + ghosts {tuple(ghosts.shape)} "
                         f"hold fewer than the plan's {plan['n_src']} source rows")
    dt = gather_dtype if _is_narrow(gather_dtype) else torch.float32
    tb_h, tb_g = h.to(dt).contiguous(), ghosts.to(dt).contiguous()
    out = torch.zeros((h.shape[0], h.shape[1]), dtype=torch.float32, device=h.device)
    unit = mode == "mask"
    for bi, part in enumerate(plan["buckets"]):
        if bi < n_pure:
            _launch_part(tb_h, part, out, unit)
        else:
            _launch_fused_part(tb_h, tb_g, part, out, unit)
    if plan["top"] is not None:
        _launch_fused_part(tb_h, tb_g, plan["top"], out, unit)
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

    shard: the rank's `Shard`; n: the number of shards. static_vals: bake
    the shard's edge values (the GCN norms) into the plans (`apply_static`
    / `apply_static_fused`); without them the plans serve the unit-weight
    entries (GAT). gather_dtype as in HybSpMM."""

    def __init__(self, shard: Shard, n: int, edges: str = "combined",
                 static_vals: bool = False, gather_dtype: torch.dtype | None = None,
                 max_width: int = 512, lam_slots: int = _LAMBDA_SLOTS,
                 device: str | torch.device = "cpu"):
        if edges not in ("combined", "fused"):
            raise NotImplementedError(
                f"ShardedHybSpMM edges={edges!r}: the interior/boundary plan pair "
                "is still to port (ROADMAP.md queue 2 item 8)")
        ne = shard.num_edges
        src = np.asarray(shard.src[:ne])
        dst = np.asarray(shard.dst[:ne])
        val = np.asarray(shard.edge_val[:ne], np.float32) if static_vals else None
        if ne and (np.diff(dst) < 0).any():
            raise ValueError("shard edges must be dst-sorted")
        vp, max_h = int(shard.x.shape[0]), int(shard.send_idx.shape[1])
        table = vp + n * max_h
        if ne and (src.min() < 0 or src.max() >= table or dst.min() < 0 or dst.max() >= vp):
            raise ValueError("shard edge endpoint out of range")
        self.vp, self.table = vp, table
        self.num_in, self.num_out = table, vp
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

    def _pass(self, table, plan, num_out, mode, val=None, other=None):
        return _hyb_pass(table, plan, num_out, self.gather_dtype, mode, val, other)

    def _fwd_fused(self, h: torch.Tensor, ghosts: torch.Tensor, mode: str) -> torch.Tensor:
        return fused_pass(h, ghosts, self.fwd, self.n_pure, self.gather_dtype, mode)

    def _need(self, fused: bool, entry: str) -> None:
        if self.fused != fused:
            raise RuntimeError(f"{entry}: op built with edges="
                               f"{'fused' if self.fused else 'combined'!r}")

    # combined plan: the table is halo_exchange's (vp + n * max_h, F)
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

    # fused plan: local rows and ghost rows apart
    def apply_static_fused(self, h: torch.Tensor, ghosts: torch.Tensor) -> torch.Tensor:
        self._need(True, "apply_static_fused")
        if not self.has_static_vals:
            raise RuntimeError("op built without static values: use "
                               "apply_unit_fused / apply_dst_fused")
        return FusedFn.apply(h, ghosts, None, self, "static")

    def apply_unit_fused(self, h: torch.Tensor, ghosts: torch.Tensor) -> torch.Tensor:
        self._need(True, "apply_unit_fused")
        return FusedFn.apply(h, ghosts, None, self, "mask")

    def apply_dst_fused(self, h: torch.Tensor, ghosts: torch.Tensor,
                        dst_val: torch.Tensor) -> torch.Tensor:
        self._need(True, "apply_dst_fused")
        return FusedFn.apply(h, ghosts, dst_val, self, "mask")


class FusedFn(torch.autograd.Function):
    """The fused-overlap entries (JAX: `fused_static_apply`,
    `fused_unit_apply`, `fused_dst_apply` with their custom VJPs). Forward:
    the two-table pass, and with dst_val the row scale
    out[v] = dst_val[v] * u[v]. Backward: one pass over the combined
    transpose plan with table = gout (scaled by dst_val in f32 first, as
    JAX does) into one (vp + n * max_h, F) buffer; its [:vp] rows are dh,
    its [vp:] rows dghosts, each cast to its input's dtype;
    d_dst = rowsum(u * gout) in f32 from the saved unscaled u."""

    @staticmethod
    def forward(ctx, h, ghosts, dst_val, op, mode):
        u = op._fwd_fused(h, ghosts, mode)
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
        return dh, dg, d_dst, None, None
