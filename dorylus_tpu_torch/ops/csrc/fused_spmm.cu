// Two-table hybrid-ELL pass (K8) for Hopper (sm_90a): the mixed buckets and
// the hub top of the fused-overlap plan of the sharded engine.
//
// Replaces dorylus_tpu/ops/hyb_sharded.py `_fused_fwd_pass` (entered by
// `fused_static_apply`, `fused_unit_apply`, `fused_dst_apply`), which calls
// `_hyb_pass(concat(h, ghosts), ..., h_local=h, n_pure=...)`: the first
// n_pure buckets gather local rows only, the rest and the hub top gather
// from the concatenation of the local rows h (vp, F) and the ghost rows
// (n * max_h, F) the halo exchange delivered. The concatenation is XLA's
// need, not the math's: here a slot index s < vp reads h[s], any other
// reads ghosts[s - vp]; nothing is copied. The pure buckets run the
// one-table kernel (hyb_spmm.cu) on h.
//
// One launch handles one plan part, exactly as hyb_spmm.cu does:
//
//   out[out_idx[i], :] = sum_{r in [row_ptr[i], row_ptr[i+1])}
//                        sum_{j < cnt[r]}  w[r, j] * T(rows[r, j])[:]
//   T(s) = s < vp ? h[s] : ghosts[s - vp]
//
// with w = vals (static mode, the baked GCN norms) or 1 (mask mode, vals ==
// nullptr: GAT's unit-weight pass). row_ptr == nullptr: one slot row per
// output row; the hub top passes each hub's run of chunk rows.
//
// What bounds it: gathered bytes, as K1/K2 (about E * F * sizeof(T) of table
// rows at data-dependent addresses, E * 4 of slot indices, E * sizeof(T) of
// values in static mode; two flops per gathered element). The design is
// K1/K2's: one warp per output row, lanes across F, slot indices and values
// loaded 32 at a time and broadcast by __shfl_sync, sums in f32 registers,
// one writer per output row, no atomics. The table select is one compare
// per slot, uniform across the warp.
//
// Numerics: as K1/K2. In static bf16 mode each product is rounded to bf16
// before the f32 sum; h and ghosts arrive already cast to the gather dtype
// (each cast once by the caller, as JAX casts `tb` and `tb_local`).

#include "gather.cuh"

namespace {

using dorylus::kFullMask;
using dorylus::product;
using dorylus::to_float;

constexpr int kWarpsPerBlock = 8;

template <typename T, int NF, bool kUnit>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, NF == 2 ? 8 : 1)
fused_part_kernel(const T* __restrict__ h, const T* __restrict__ ghosts,
                  int vp, int f, const int32_t* __restrict__ rows,
                  const T* __restrict__ vals, const int32_t* __restrict__ cnt,
                  int w, const int32_t* __restrict__ row_ptr,
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
    const T* slot_vals = kUnit ? nullptr : vals + (int64_t)r * w;
    for (int j0 = 0; j0 < n; j0 += 32) {
      int my_row = 0;
      float my_val = 0.f;
      if (j0 + lane < n) {
        my_row = slot_rows[j0 + lane];
        if (!kUnit) my_val = to_float(slot_vals[j0 + lane]);
      }
      const int m = min(32, n - j0);
#pragma unroll 4
      for (int t = 0; t < m; ++t) {
        const int s = __shfl_sync(kFullMask, my_row, t);
        const float a = kUnit ? 1.f : __shfl_sync(kFullMask, my_val, t);
        const T* src = s < vp ? h + (int64_t)s * f
                              : ghosts + (int64_t)(s - vp) * f;
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          const int c = col0 + 32 * k;
          if (c < f) {
            const float x = to_float(src[c]);
            acc[k] += kUnit ? x : product<T>(a, x);
          }
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

template <typename T, int NF, bool kUnit>
void launch(const void* h, const void* ghosts, int vp, int f,
            const int32_t* rows, const void* vals, const int32_t* cnt, int w,
            const int32_t* row_ptr, const int32_t* out_idx, int n_out,
            float* out, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (f + 32 * NF - 1) / (32 * NF));
  fused_part_kernel<T, NF, kUnit><<<grid, block, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(ghosts), vp, f, rows,
      static_cast<const T*>(vals), cnt, w, row_ptr, out_idx, n_out, out);
}

template <typename T, bool kUnit>
void launch_for_width(const void* h, const void* ghosts, int vp, int f,
                      const int32_t* rows, const void* vals,
                      const int32_t* cnt, int w, const int32_t* row_ptr,
                      const int32_t* out_idx, int n_out, float* out,
                      cudaStream_t stream) {
  if (f <= 32) {
    launch<T, 1, kUnit>(h, ghosts, vp, f, rows, vals, cnt, w, row_ptr,
                        out_idx, n_out, out, stream);
  } else if (f <= 64) {
    launch<T, 2, kUnit>(h, ghosts, vp, f, rows, vals, cnt, w, row_ptr,
                        out_idx, n_out, out, stream);
  } else {
    launch<T, 4, kUnit>(h, ghosts, vp, f, rows, vals, cnt, w, row_ptr,
                        out_idx, n_out, out, stream);
  }
}

template <bool kUnit>
int launch_part(int device, int dtype, const void* h, const void* ghosts,
                int vp, int f, const void* rows, const void* vals,
                const void* cnt, int w, const void* row_ptr,
                const void* out_idx, int n_out, void* out, void* stream) {
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
    launch_for_width<float, kUnit>(h, ghosts, vp, f, rows_i, vals, cnt_i, w,
                                   ptr_i, idx_i, n_out, out_f, s);
  } else if (dtype == 1) {
    launch_for_width<__nv_bfloat16, kUnit>(h, ghosts, vp, f, rows_i, vals,
                                           cnt_i, w, ptr_i, idx_i, n_out,
                                           out_f, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32 tables (and vals), 1 = bfloat16 tables (and vals).
// h has vp rows; ghosts holds the rows a slot index >= vp addresses.
// row_ptr may be null (one slot row per output row). vals == nullptr runs
// the mask mode. Returns the CUDA error code of the launch (0 =
// cudaSuccess). Launches on `stream`; does not synchronise and allocates
// nothing.
int fused_part(int device, int dtype, const void* h, const void* ghosts,
               int vp, int f, const void* rows, const void* vals,
               const void* cnt, int w, const void* row_ptr,
               const void* out_idx, int n_out, void* out, void* stream) {
  if (vals == nullptr) {
    return launch_part<true>(device, dtype, h, ghosts, vp, f, rows, vals, cnt,
                             w, row_ptr, out_idx, n_out, out, stream);
  }
  return launch_part<false>(device, dtype, h, ghosts, vp, f, rows, vals, cnt,
                            w, row_ptr, out_idx, n_out, out, stream);
}

const char* fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
