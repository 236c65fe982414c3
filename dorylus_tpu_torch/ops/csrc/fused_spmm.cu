// Two-table hybrid-ELL pass (K8) for Hopper (sm_90a): the fused-overlap plan
// of the sharded engine, its pure buckets, mixed buckets and hub top in one
// launch.
//
// Replaces dorylus_tpu/ops/hyb_sharded.py `_fused_fwd_pass` (:501, entered by
// `fused_static_apply`, `fused_unit_apply`, `fused_dst_apply`), which calls
// `_hyb_pass(concat(h, ghosts), ..., h_local=h, n_pure=...)`: the first
// n_pure buckets gather local rows only, the rest and the hub top gather
// from the concatenation of the local rows h (vp, F) and the ghost rows
// (n * max_h, F) the halo exchange delivered. The concatenation is XLA's
// need, not the math's: here a slot index s < split reads h[s], any other
// reads ghosts[s - split], and nothing is copied. A mixed part carries split
// = vp; a pure part split = INT_MAX, so it never takes the ghost branch.
//
// The work is K1/K2's, through the same gather core (gather_pass.cuh) with
// the two-table row source:
//
//   out[out_idx[i], :] = sum_{r in [row_ptr[i], row_ptr[i+1])}
//                        sum_{j < cnt[r]}  w[r, j] * T(rows[r, j])[:]
//   T(s) = s < split ? h[s] : ghosts[s - split]
//
// with w = vals (static mode, the baked GCN norms) or 1 (mask mode: GAT's
// unit-weight pass). The table select is one compare per slot, uniform
// across the lanes of a row.
//
// What bounds it: gathered bytes, as K1/K2 (about E * F * sizeof(T) of table
// rows at data-dependent addresses, E * 4 of slot indices, E * sizeof(T) of
// values in static mode; two flops per gathered element), and the
// instructions per gathered element, which the core's 16-byte loads and
// packed bf16 products cut (gather_pass.cuh).
//
// Numerics: as K1/K2. In static bf16 mode each product is rounded to bf16
// before the f32 sum; h and ghosts arrive already cast to the gather dtype
// (each cast once by the caller, as JAX casts `tb` and `tb_local`).

#include "gather_pass.cuh"

extern "C" {

// As hyb_pass (hyb_spmm.cu), with two tables of one leading dimension ld: h
// holds the rows below each mixed part's split, ghosts the rows a slot index
// >= split addresses.
int fused_pass(int device, int dtype, int unit, const void* h, const void* ghosts, int ld,
               int f, int g, const void* parts, int n_parts, int n_blocks, int col_tiles,
               void* out, void* stream) {
  return dorylus::run_pass(device, dtype, unit, g, parts, n_parts, n_blocks, col_tiles, f, out,
                           stream, [&](auto tag) {
                             using T = decltype(tag);
                             return dorylus::TwoTables<T>{static_cast<const T*>(h),
                                                          static_cast<const T*>(ghosts), ld};
                           });
}

const char* fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
