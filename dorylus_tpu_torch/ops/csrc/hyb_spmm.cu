// Hybrid-ELL SpMM, static-value and mask modes (K1, K2), for Hopper (sm_90a).
//
// Replaces dorylus_tpu/ops/hyb_spmm.py `_hyb_pass` (:392) / `_reduce_part`
// (:321):
//   * static mode (K1): the forward of `hyb_spmm_static_apply` and its
//     backward `_static_bwd`, the same pass over the transposed plan;
//   * mask mode (K2): the unit-weight pass of `hyb_spmm_unit_apply` and
//     `hyb_spmm_dst_apply` (`_weights` mask branch), forward and backward.
//     The dst variant's row scale and row-dot stay torch ops around it, as
//     they are jnp ops around `_hyb_pass` in JAX.
// The degree plans (ops/degree_spmm.py), a rank's sharded plans and the
// pair-reuse pass (K2 over the rewritten plan) run on the same entry.
//
// One launch runs every part of a plan (its buckets and its hub top, or a
// degree plan's one part) through the gather core of gather_pass.cuh, with
// the one-table row source: src(s) = table + s * ld. The caller zero-fills
// `out`, which covers isolated vertices, so both output layouts of the JAX
// plan (`_n_iso` prefix, `inv` with a zero sentinel row) reduce to writing
// row out_idx[i] directly: no permutation gather, no message tensor, no
// scan chunking.
//
// What bounds it: gathered bytes, about E * F * sizeof(T) of table rows at
// data-dependent addresses (E edges, F features, mostly from the L2), E * 4
// of slot indices and, in static mode, E * sizeof(T) of values; at most two
// flops per gathered element. Before this design a lane loaded 2-byte
// elements one at a time, so the instructions per gathered element, not the
// bytes, set the pace; the core reads each row with 16-byte loads, keeps
// several in flight per lane and multiplies bf16 pairs in one instruction
// (gather_pass.cuh says how).
//
// Numerics: in static bf16 mode each product val * table is rounded to bf16
// before the f32 sum, as the plain version's bf16 multiply does (the JAX
// narrow mode multiplies in bf16 and sums in f32). In mask mode the weight is
// 1, so the sum adds the table values. In f32 the product and sum are f32
// (possibly one FMA).

#include "gather_pass.cuh"

extern "C" {

// dtype: 0 = float32 table (and values), 1 = bfloat16. unit: mask mode (no
// value read). table: (rows, ld) with ld a multiple of 16 bytes; f: the
// columns written, f <= ld. g: lanes of a row group (8, 16 or 32); parts:
// n_parts PartDescs (host memory) laid out for g, over n_blocks blocks;
// col_tiles: column tiles of g * 16 bytes. out: (num_out, f) f32. Returns
// the CUDA error code of the launch (0 = cudaSuccess); launches on `stream`,
// does not synchronise and allocates nothing.
int hyb_pass(int device, int dtype, int unit, const void* table, int ld, int f, int g,
             const void* parts, int n_parts, int n_blocks, int col_tiles, void* out,
             void* stream) {
  return dorylus::run_pass(device, dtype, unit, g, parts, n_parts, n_blocks, col_tiles, f, out,
                           stream, [&](auto tag) {
                             using T = decltype(tag);
                             return dorylus::OneTable<T>{static_cast<const T*>(table), ld};
                           });
}

const char* hyb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
