// Slot pass with per-edge (dynamic) values and a fused value gradient (K7),
// for Hopper (sm_90a).
//
// Replaces the dynamic mode of dorylus_tpu/ops/hyb_spmm.py `_hyb_pass` /
// `_reduce_part` (`hyb_spmm_apply` and its backward `_apply_bwd`) and the
// dynamic entry of dorylus_tpu/ops/degree_spmm.py `_degree_pass`
// (`degree_spmm_apply` and its backward): a degree plan is a hub part whose
// vertices own runs of width-16 block rows.
//
// One launch runs every part of a plan (its buckets and its hub top, or a
// degree plan's one part) through the gather core's dynamic-value team
// (gather_pass.cuh `dyn_pass_kernel`):
//
//   out[out_idx[i], :] = sum_{r in [row_ptr[i], row_ptr[i+1])}
//                        sum_{j < cnt[r]}  val[s2e[r, j]] * table[rows[r, j], :]
//
// and, with `own` given (the backward over the transposed plan, where table
// = gout and own = h), each live slot's value gradient in flat slot order:
//
//   flat[slot0 + r*w + j] = < table[rows[r, j], :], own[out_idx[i], :] >
//
// which the caller turns into dval = flat[e2s], JAX's own order of work
// (`_hyb_pass`: the dv grids raveled in global slot order, pulled back
// through e2s). Every output row and every slot has one writer: no
// atomics, the same bits on every run.
//
// What bounds it: the gathered bytes, as K1's (E * F * sizeof(T) of table
// rows at data-dependent addresses), plus per live slot a 4-byte edge id
// and the 4-byte value read through it (in the backward plan, whose edge
// ids are a permutation, scattered), or the slot's weight from a table in
// slot order that the caller gathered; with the dot, 4 bytes of flat per
// slot, written coalesced. The launchers live here, not in the header, so
// that hyb_spmm.cu and fused_spmm.cu instantiate none of these kernels.
//
// Numerics, as the JAX narrow mode: in bf16 each weight is rounded to bf16
// (`val_ext[s2e].astype(msgs_dtype)`), each product weight * table is
// rounded to bf16 (mul.bf16x2), each product table * own (own cast to bf16
// by the caller) is rounded to bf16, and every sum runs in f32. In f32 the
// products and sums are f32 (possibly one FMA).

#include "gather_pass.cuh"

namespace {

using dorylus::dyn_pass_kernel;
using dorylus::DynArgs;
using dorylus::kMaxParts;
using dorylus::kPassThreads;
using dorylus::PartDesc;
using dorylus::PassParams;

template <typename T, bool kDot>
cudaError_t launch_dyn_group(int g, const PassParams& p, const DynArgs& a, int n_blocks,
                             cudaStream_t s) {
  if (g == 8) {
    dyn_pass_kernel<T, 8, kDot><<<n_blocks, kPassThreads, 0, s>>>(p, a);
  } else if (g == 16) {
    dyn_pass_kernel<T, 16, kDot><<<n_blocks, kPassThreads, 0, s>>>(p, a);
  } else if (g == 32) {
    dyn_pass_kernel<T, 32, kDot><<<n_blocks, kPassThreads, 0, s>>>(p, a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table (and own, and wslot), 1 = bfloat16. dot: also
// write each live slot's dot into flat (own and flat given). g: lanes of a
// row group (8, 16 or 32); parts: n_parts PartDescs (host memory) laid out
// for g, over n_blocks blocks of 256 threads. table and own: (rows, ld) with
// ld a multiple of 16 bytes, f <= ld the columns written to out (num_out, f)
// f32. s2e: the plan's slot->edge map in flat slot order; val: (E,) f32;
// wslot: null, or each slot's weight in the table's dtype in flat slot order
// (then val and s2e are not read). Returns the CUDA error code of the launch
// (0 = cudaSuccess); launches on `stream`, does not synchronise and
// allocates nothing.
int dyn_pass(int device, int dtype, int dot, int g, const void* parts, int n_parts,
             int n_blocks, const void* table, const void* own, int ld, int f,
             const void* s2e, const void* val, const void* wslot, int own_rows, void* out,
             void* flat, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts > kMaxParts || n_parts < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dot && (own == nullptr || flat == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_parts == 0 || n_blocks <= 0 || f <= 0) return 0;
  PassParams p;
  memcpy(p.parts, parts, n_parts * sizeof(PartDesc));
  p.n_parts = n_parts;
  DynArgs a;
  a.tab = table;
  a.own = own;
  a.s2e = static_cast<const int32_t*>(s2e);
  a.val = static_cast<const float*>(val);
  a.wslot = wslot;
  a.out = static_cast<float*>(out);
  a.flat = static_cast<float*>(flat);
  a.ld = ld;
  a.f = f;
  a.own_rows = own_rows;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dot ? launch_dyn_group<float, true>(g, p, a, n_blocks, s)
              : launch_dyn_group<float, false>(g, p, a, n_blocks, s);
  } else if (dtype == 1) {
    err = dot ? launch_dyn_group<__nv_bfloat16, true>(g, p, a, n_blocks, s)
              : launch_dyn_group<__nv_bfloat16, false>(g, p, a, n_blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* dyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
