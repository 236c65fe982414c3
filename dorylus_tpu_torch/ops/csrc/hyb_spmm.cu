// Hybrid-ELL SpMM, static-value mode, for Hopper (sm_90a).
//
// Replaces dorylus_tpu/ops/hyb_spmm.py `_hyb_pass` / `_reduce_part` in
// static mode: the forward of `hyb_spmm_static_apply` and its backward
// `_static_bwd`, which is the same pass over the transposed plan.
//
// One launch handles one plan part (a bucket, or the hub top bucket):
//
//   out[out_idx[i], :] = sum_{r in [row_ptr[i], row_ptr[i+1])}
//                        sum_{j < cnt[r]}  vals[r, j] * table[rows[r, j], :]
//
// A normal bucket has one slot row per output row (row_ptr == nullptr:
// slot row i). A hub owns a contiguous run of width-512 chunk rows (the
// plan's rowv is ascending; the host derives row_ptr from it). The caller
// zero-fills `out`, which covers isolated vertices, so both output layouts
// of the JAX plan (`_n_iso` prefix, `inv` with a zero sentinel row) reduce
// to writing row out_idx[i] directly: no permutation gather, no message
// tensor, no scan chunking.
//
// What bounds it: gathered bytes. A pass reads about E * F * sizeof(T)
// bytes of table rows at data-dependent addresses (E edges, F features),
// plus E * (4 + sizeof(T)) bytes of slot indices and values, and does two
// flops per gathered element, far below the card's compute. The design
// answers that with:
//   * one warp per output row and lanes across F, so each gathered table
//     row is read by neighbouring lanes at neighbouring addresses;
//   * slot indices and values loaded once per 32 slots, one per lane, as
//     one coalesced load, then broadcast with __shfl_sync;
//   * bf16 tables (the main path's agg_dtype) halve the gathered bytes;
//     sums stay in f32 registers.
// Every output row has exactly one writer: no atomics, deterministic.
//
// Numerics: in bf16 mode each product val * table is rounded to bf16 before
// the f32 sum, as the plain version's bf16 multiply does (the JAX narrow
// mode multiplies in bf16 and sums in f32). In f32 mode the product and sum
// are f32 (the compiler may fuse them into an FMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Product;

template <>
struct Product<float> {
  static __device__ __forceinline__ float apply(float w, float x) {
    return w * x;
  }
};

template <>
struct Product<__nv_bfloat16> {
  // Both factors are bf16 values, so w * x is exact in f32; rounding it
  // to bf16 gives the bf16 product.
  static __device__ __forceinline__ float apply(float w, float x) {
    return __bfloat162float(__float2bfloat16_rn(w * x));
  }
};

// NF: columns per lane (the warp covers 32 * NF columns; blockIdx.y walks
// further column tiles when F is wider).
template <typename T, int NF>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hyb_static_part_kernel(const T* __restrict__ table, int f,
                       const int32_t* __restrict__ rows,
                       const T* __restrict__ vals,
                       const int32_t* __restrict__ cnt, int w,
                       const int32_t* __restrict__ row_ptr,
                       const int32_t* __restrict__ out_idx, int n_out,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_out) return;  // i is uniform across the warp
  const int col0 = blockIdx.y * (32 * NF) + lane;

  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.f;

  const int r_begin = row_ptr ? row_ptr[i] : i;
  const int r_end = row_ptr ? row_ptr[i + 1] : i + 1;
  for (int r = r_begin; r < r_end; ++r) {
    const int n = cnt[r];  // live prefix of slot row r
    const int32_t* slot_rows = rows + (int64_t)r * w;
    const T* slot_vals = vals + (int64_t)r * w;
    for (int j0 = 0; j0 < n; j0 += 32) {
      int my_row = 0;
      float my_val = 0.f;
      if (j0 + lane < n) {
        my_row = slot_rows[j0 + lane];
        my_val = to_float(slot_vals[j0 + lane]);
      }
      const int m = min(32, n - j0);
#pragma unroll 4
      for (int t = 0; t < m; ++t) {
        const int s = __shfl_sync(0xffffffffu, my_row, t);
        const float a = __shfl_sync(0xffffffffu, my_val, t);
        const T* src = table + (int64_t)s * f;
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const int c = col0 + 32 * k;
          if (c < f) acc[k] += Product<T>::apply(a, to_float(src[c]));
        }
      }
    }
  }

  float* dst = out + (int64_t)out_idx[i] * f;
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int c = col0 + 32 * k;
    if (c < f) dst[c] = acc[k];
  }
}

template <typename T, int NF>
void launch(const void* table, int f, const int32_t* rows, const void* vals,
            const int32_t* cnt, int w, const int32_t* row_ptr,
            const int32_t* out_idx, int n_out, float* out,
            cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (f + 32 * NF - 1) / (32 * NF));
  hyb_static_part_kernel<T, NF><<<grid, block, 0, stream>>>(
      static_cast<const T*>(table), f, rows, static_cast<const T*>(vals), cnt,
      w, row_ptr, out_idx, n_out, out);
}

template <typename T>
void launch_for_width(const void* table, int f, const int32_t* rows,
                      const void* vals, const int32_t* cnt, int w,
                      const int32_t* row_ptr, const int32_t* out_idx,
                      int n_out, float* out, cudaStream_t stream) {
  if (f <= 32) {
    launch<T, 1>(table, f, rows, vals, cnt, w, row_ptr, out_idx, n_out, out,
                 stream);
  } else if (f <= 64) {
    launch<T, 2>(table, f, rows, vals, cnt, w, row_ptr, out_idx, n_out, out,
                 stream);
  } else {
    launch<T, 4>(table, f, rows, vals, cnt, w, row_ptr, out_idx, n_out, out,
                 stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table and vals, 1 = bfloat16 table and vals.
// row_ptr may be null (one slot row per output row). Returns the CUDA error
// code of the launch (0 = cudaSuccess). Launches on `stream`; does not
// synchronise and allocates nothing.
int hyb_static_part(int device, int dtype, const void* table, int f,
                    const void* rows, const void* vals, const void* cnt,
                    int w, const void* row_ptr, const void* out_idx,
                    int n_out, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out <= 0 || f <= 0) return 0;
  const auto* rows_i = static_cast<const int32_t*>(rows);
  const auto* cnt_i = static_cast<const int32_t*>(cnt);
  const auto* ptr_i = static_cast<const int32_t*>(row_ptr);
  const auto* idx_i = static_cast<const int32_t*>(out_idx);
  auto* out_f = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_for_width<float>(table, f, rows_i, vals, cnt_i, w, ptr_i, idx_i,
                            n_out, out_f, s);
  } else if (dtype == 1) {
    launch_for_width<__nv_bfloat16>(table, f, rows_i, vals, cnt_i, w, ptr_i,
                                    idx_i, n_out, out_f, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hyb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
