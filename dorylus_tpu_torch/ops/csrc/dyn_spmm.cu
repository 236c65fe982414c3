// Slot pass with per-edge (dynamic) values and a fused SDDMM (K7), for
// Hopper (sm_90a).
//
// Replaces the dynamic mode of dorylus_tpu/ops/hyb_spmm.py `_hyb_pass` /
// `_reduce_part` (`hyb_spmm_apply` and its backward `_apply_bwd`) and the
// dynamic entry of dorylus_tpu/ops/degree_spmm.py `_degree_pass`
// (`degree_spmm_apply` and its backward): a degree plan is a hub part whose
// vertices own runs of width-16 block rows.
//
// One launch handles one plan part, as K1 does (csrc/hyb_spmm.cu):
//
//   out[out_idx[i], :] = sum_{r in [row_ptr[i], row_ptr[i+1])}
//                        sum_{j < cnt[r]}  val[s2e[r, j]] * table[rows[r, j], :]
//
// and, with `other` given (the backward over the transposed plan, where
// table = gout and other = h):
//
//   dval[s2e[r, j]] = < table[rows[r, j], :], other[out_idx[i], :] >
//
// for every live slot. Each edge owns exactly one slot and each slot row
// belongs to one output row, which one warp handles over all of its
// columns, so every dval entry has one writer: no atomics, no e2s gather
// on the card, deterministic.
//
// What bounds it: gathered bytes, as for K1: E * F * sizeof(T) of table
// rows at data-dependent addresses, plus per slot a 4-byte slot->edge id
// and a 4-byte value read through it (scattered in the backward plan,
// whose edge ids are a permutation). The design:
//   * one warp per output row, lanes across F; slot ids, edge ids and
//     values loaded once per 32 slots, one per lane, then broadcast with
//     __shfl_sync;
//   * the backward keeps the output row's `other` values in registers and
//     forms each slot's dot from the table row it gathers anyway for dh,
//     reduced with __shfl_xor_sync; lane t keeps slot t's dot and writes it
//     after the 32-slot chunk;
//   * column tiles are walked inside the warp (not by grid.y), so a row of
//     any width keeps one warp and one writer per dval entry; the first
//     tile stores, later tiles add in the same thread.
// This is its own source and its own template, so K1 and K2 keep their
// builds and register counts.
//
// Numerics, as the JAX narrow mode: in bf16 each weight is rounded to bf16
// (`val_ext[s2e].astype(msgs_dtype)`), each product weight * table is
// rounded to bf16, each product table * other (other cast to bf16) is
// rounded to bf16, and every sum runs in f32. In f32 the products and sums
// are f32 (possibly one FMA).

#include "gather.cuh"

namespace {

using dorylus::kFullMask;
using dorylus::product;
using dorylus::round_to;
using dorylus::to_float;
using dorylus::warp_sum;

constexpr int kWarpsPerBlock = 8;

// NF: columns per lane in one tile (a tile covers 32 * NF columns). kDot:
// the backward, which also writes dval.
template <typename T, int NF, bool kDot>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dyn_part_kernel(const T* __restrict__ table, int f,
                const int32_t* __restrict__ rows,
                const int32_t* __restrict__ s2e,
                const float* __restrict__ val,
                const int32_t* __restrict__ cnt, int w,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ out_idx, int n_out,
                const T* __restrict__ other, float* __restrict__ out,
                float* __restrict__ dval) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_out) return;  // i is uniform across the warp
  const int64_t v = out_idx[i];
  const int r_begin = row_ptr ? row_ptr[i] : i;
  const int r_end = row_ptr ? row_ptr[i + 1] : i + 1;

  for (int c0 = 0; c0 < f; c0 += 32 * NF) {
    const bool first_tile = c0 == 0;
    float acc[NF];
    float oth[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      acc[k] = 0.f;
      oth[k] = 0.f;
      const int c = c0 + lane + 32 * k;
      if (kDot && c < f) oth[k] = to_float(other[v * f + c]);
    }
    for (int r = r_begin; r < r_end; ++r) {
      const int n = cnt[r];  // live prefix of slot row r
      const int32_t* slot_rows = rows + (int64_t)r * w;
      const int32_t* slot_edges = s2e + (int64_t)r * w;
      for (int j0 = 0; j0 < n; j0 += 32) {
        int my_row = 0, my_edge = 0;
        float my_val = 0.f, my_dot = 0.f;
        const bool live = j0 + lane < n;
        if (live) {
          my_row = slot_rows[j0 + lane];
          my_edge = slot_edges[j0 + lane];
          my_val = round_to<T>(val[my_edge]);
        }
        const int m = min(32, n - j0);
#pragma unroll 4
        for (int t = 0; t < m; ++t) {
          const int s = __shfl_sync(kFullMask, my_row, t);
          const float a = __shfl_sync(kFullMask, my_val, t);
          const T* src = table + (int64_t)s * f;
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < NF; ++k) {
            const int c = c0 + lane + 32 * k;
            if (c < f) {
              const float x = to_float(src[c]);
              acc[k] += product<T>(a, x);
              if (kDot) dot += product<T>(x, oth[k]);
            }
          }
          if (kDot) {
            dot = warp_sum(dot);
            if (lane == t) my_dot = dot;
          }
        }
        if (kDot && live) {
          if (first_tile) {
            dval[my_edge] = my_dot;
          } else {
            dval[my_edge] += my_dot;
          }
        }
      }
    }
    float* dst = out + v * f;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < f) dst[c] = acc[k];
    }
  }
}

template <typename T, int NF, bool kDot>
void launch(const void* table, int f, const int32_t* rows, const int32_t* s2e,
            const float* val, const int32_t* cnt, int w, const int32_t* row_ptr,
            const int32_t* out_idx, int n_out, const void* other, float* out,
            float* dval, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dyn_part_kernel<T, NF, kDot><<<grid, block, 0, stream>>>(
      static_cast<const T*>(table), f, rows, s2e, val, cnt, w, row_ptr,
      out_idx, n_out, static_cast<const T*>(other), out, dval);
}

template <typename T, bool kDot>
void launch_for_width(const void* table, int f, const int32_t* rows,
                      const int32_t* s2e, const float* val,
                      const int32_t* cnt, int w, const int32_t* row_ptr,
                      const int32_t* out_idx, int n_out, const void* other,
                      float* out, float* dval, cudaStream_t stream) {
  if (f <= 32) {
    launch<T, 1, kDot>(table, f, rows, s2e, val, cnt, w, row_ptr, out_idx,
                       n_out, other, out, dval, stream);
  } else if (f <= 64) {
    launch<T, 2, kDot>(table, f, rows, s2e, val, cnt, w, row_ptr, out_idx,
                       n_out, other, out, dval, stream);
  } else {
    launch<T, 4, kDot>(table, f, rows, s2e, val, cnt, w, row_ptr, out_idx,
                       n_out, other, out, dval, stream);
  }
}

template <typename T>
void launch_mode(const void* table, int f, const int32_t* rows,
                 const int32_t* s2e, const float* val, const int32_t* cnt,
                 int w, const int32_t* row_ptr, const int32_t* out_idx,
                 int n_out, const void* other, float* out, float* dval,
                 cudaStream_t stream) {
  if (other != nullptr) {
    launch_for_width<T, true>(table, f, rows, s2e, val, cnt, w, row_ptr,
                              out_idx, n_out, other, out, dval, stream);
  } else {
    launch_for_width<T, false>(table, f, rows, s2e, val, cnt, w, row_ptr,
                               out_idx, n_out, other, out, dval, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table (and other), 1 = bfloat16. val is float32,
// indexed by the edge ids in s2e. row_ptr may be null (one slot row per
// output row). other == nullptr runs the forward (dval must be null too);
// otherwise dval (float32, one entry per edge) receives the fused SDDMM.
// Returns the CUDA error code of the launch (0 = cudaSuccess). Launches on
// `stream`; does not synchronise and allocates nothing.
int dyn_part(int device, int dtype, const void* table, int f, const void* rows,
             const void* s2e, const void* val, const void* cnt, int w,
             const void* row_ptr, const void* out_idx, int n_out,
             const void* other, void* out, void* dval, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((other == nullptr) != (dval == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out <= 0 || f <= 0) return 0;
  const auto* rows_i = static_cast<const int32_t*>(rows);
  const auto* s2e_i = static_cast<const int32_t*>(s2e);
  const auto* val_f = static_cast<const float*>(val);
  const auto* cnt_i = static_cast<const int32_t*>(cnt);
  const auto* ptr_i = static_cast<const int32_t*>(row_ptr);
  const auto* idx_i = static_cast<const int32_t*>(out_idx);
  auto* out_f = static_cast<float*>(out);
  auto* dval_f = static_cast<float*>(dval);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_mode<float>(table, f, rows_i, s2e_i, val_f, cnt_i, w, ptr_i, idx_i,
                       n_out, other, out_f, dval_f, s);
  } else if (dtype == 1) {
    launch_mode<__nv_bfloat16>(table, f, rows_i, s2e_i, val_f, cnt_i, w,
                               ptr_i, idx_i, n_out, other, out_f, dval_f, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
