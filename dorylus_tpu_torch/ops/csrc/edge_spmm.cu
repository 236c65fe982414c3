// Edgewise aggregation over CSR, for Hopper (sm_90a).
//
// Replaces dorylus_tpu/ops/spmm.py, the path kernel="xla" (and "auto" up to
// 8M edges) runs: `spmm_edgewise` / `aggregate` / `spmm_dst_blocked`
// (gather h[src] * val, sorted segment-sum over dst) with the backward JAX
// autodiff gives it, and `take_sorted`'s segment-sum backward. Three
// kernels, all over a CSR whose rows are contiguous edge ranges:
//
//   K3 csr_spmm     out[r] = sum_{e in [ptr[r], ptr[r+1])}
//                            val[perm(e)] * table[col[e]]
//                   forward: the dst CSR (col = src, perm = identity);
//                   dh: the src CSR (col = dst[order], perm = order), so
//                   val is read through the permutation in the kernel and
//                   no permuted copy of it is made per call.
//   K4 sddmm        dval[e] = <h[col[e]], g[r]> for e in row r of the dst
//                   CSR: the value gradient of GAT's attention.
//   K5 segment_sum  out[r] = sum_{e in [ptr[r], ptr[r+1])} g[e], for (E,)
//                   and (E, F) cotangents: take_sorted's backward.
//
// What bounds them: K3 and K4 gather E * F * sizeof(T) bytes of table rows
// at data-dependent addresses (11.6M edges at Reddit scale: 6 GB in f32 at
// F = 128, past the 50 MB L2 for a 120 MB table), plus 8-12 bytes of index
// and value per edge; K5 streams its input once. All do one or two flops
// per byte moved, far below the card's compute. The design:
//   * one warp per CSR row, lanes across F (K3, K5) or across the dot
//     (K4), so a gathered row is read by neighbouring lanes at neighbouring
//     addresses;
//   * indices and values loaded once per 32 edges, one per lane, as one
//     coalesced load, then broadcast with __shfl_sync;
//   * every output row (K3, K5) and every edge value (K4) has exactly one
//     writer: no atomics, and the same sums in the same order on every run;
//   * no (E, F) message tensor: the segment sums stay in f32 registers.
//
// Numerics (JAX forms `h[src] * val.astype(h.dtype)`): val is rounded to
// the table dtype and each product is formed in it (bf16 products are
// rounded to bf16); sums are f32. K4 forms f32 products of the two rows.

#include "gather.cuh"

namespace {

using dorylus::kFullMask;
using dorylus::product;
using dorylus::round_to;
using dorylus::to_float;
using dorylus::warp_sum;

constexpr int kWarpsPerBlock = 8;

template <typename T, int NF>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_spmm_kernel(const T* __restrict__ table, int f,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col,
                const float* __restrict__ val,
                const int32_t* __restrict__ perm, int n_rows,
                float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // r is uniform across the warp
  const int col0 = blockIdx.y * (32 * NF) + lane;

  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.f;

  const int begin = row_ptr[r];
  const int end = row_ptr[r + 1];
  for (int e0 = begin; e0 < end; e0 += 32) {
    int my_col = 0;
    float my_val = 0.f;
    if (e0 + lane < end) {
      const int e = e0 + lane;
      my_col = col[e];
      my_val = round_to<T>(val[perm ? perm[e] : e]);
    }
    const int m = min(32, end - e0);
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      const int s = __shfl_sync(kFullMask, my_col, t);
      const float a = __shfl_sync(kFullMask, my_val, t);
      const T* src = table + (int64_t)s * f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int c = col0 + 32 * k;
        if (c < f) acc[k] += product<T>(a, to_float(src[c]));
      }
    }
  }

  float* dst = out + (int64_t)r * f;
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int c = col0 + 32 * k;
    if (c < f) dst[c] = acc[k];
  }
}

// The g row of warp r lives in registers for its first 32 * NF columns;
// wider rows read the rest from memory (L1-resident: the same row for
// every edge of r).
template <typename T, int NF>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sddmm_kernel(const T* __restrict__ h, const T* __restrict__ g, int f,
             const int32_t* __restrict__ row_ptr,
             const int32_t* __restrict__ col, int n_rows,
             float* __restrict__ dval) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const T* g_row = g + (int64_t)r * f;
  float gr[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int c = lane + 32 * k;
    gr[k] = c < f ? to_float(g_row[c]) : 0.f;
  }
  const int begin = row_ptr[r];
  const int end = row_ptr[r + 1];
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int my_col = e0 + lane < end ? col[e0 + lane] : 0;
    float mine = 0.f;  // lane t keeps the dot of edge e0 + t
    const int m = min(32, end - e0);
    for (int t = 0; t < m; ++t) {
      const int s = __shfl_sync(kFullMask, my_col, t);
      const T* h_row = h + (int64_t)s * f;
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int c = lane + 32 * k;
        if (c < f) p += to_float(h_row[c]) * gr[k];
      }
      for (int c = 32 * NF + lane; c < f; c += 32) {
        p += to_float(h_row[c]) * to_float(g_row[c]);
      }
      p = warp_sum(p);
      if (lane == t) mine = p;
    }
    if (e0 + lane < end) dval[e0 + lane] = mine;  // coalesced
  }
}

template <typename T, int NF>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_kernel(const T* __restrict__ g, int f,
                   const int32_t* __restrict__ row_ptr, int n_rows,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int col0 = blockIdx.y * (32 * NF) + lane;
  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.f;
  const int end = row_ptr[r + 1];
  for (int e = row_ptr[r]; e < end; ++e) {
    const T* g_row = g + (int64_t)e * f;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      const int c = col0 + 32 * k;
      if (c < f) acc[k] += to_float(g_row[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const int c = col0 + 32 * k;
    if (c < f) out[(int64_t)r * f + c] = acc[k];
  }
}

// (E,) cotangent: lanes across the row's edges, then a warp sum.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_vec_kernel(const T* __restrict__ g,
                       const int32_t* __restrict__ row_ptr, int n_rows,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  float acc = 0.f;
  const int end = row_ptr[r + 1];
  for (int e = row_ptr[r] + lane; e < end; e += 32) acc += to_float(g[e]);
  acc = warp_sum(acc);
  if (lane == 0) out[r] = acc;
}

dim3 row_grid(int n_rows, int f, int cols_per_warp) {
  return dim3((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (f + cols_per_warp - 1) / cols_per_warp);
}

template <typename T>
void csr_spmm(const void* table, int f, const int32_t* row_ptr,
              const int32_t* col, const float* val, const int32_t* perm,
              int n_rows, float* out, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const T* tb = static_cast<const T*>(table);
  if (f <= 32) {
    csr_spmm_kernel<T, 1><<<row_grid(n_rows, f, 32), block, 0, s>>>(
        tb, f, row_ptr, col, val, perm, n_rows, out);
  } else if (f <= 64) {
    csr_spmm_kernel<T, 2><<<row_grid(n_rows, f, 64), block, 0, s>>>(
        tb, f, row_ptr, col, val, perm, n_rows, out);
  } else {
    csr_spmm_kernel<T, 4><<<row_grid(n_rows, f, 128), block, 0, s>>>(
        tb, f, row_ptr, col, val, perm, n_rows, out);
  }
}

template <typename T>
void sddmm(const void* h, const void* g, int f, const int32_t* row_ptr,
           const int32_t* col, int n_rows, float* dval, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* hp = static_cast<const T*>(h);
  const T* gp = static_cast<const T*>(g);
  if (f <= 32) {
    sddmm_kernel<T, 1><<<grid, block, 0, s>>>(hp, gp, f, row_ptr, col,
                                              n_rows, dval);
  } else if (f <= 64) {
    sddmm_kernel<T, 2><<<grid, block, 0, s>>>(hp, gp, f, row_ptr, col,
                                              n_rows, dval);
  } else {
    sddmm_kernel<T, 4><<<grid, block, 0, s>>>(hp, gp, f, row_ptr, col,
                                              n_rows, dval);
  }
}

template <typename T>
void segment_sum(const void* g, int f, const int32_t* row_ptr, int n_rows,
                 float* out, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const T* gp = static_cast<const T*>(g);
  if (f == 1) {
    segment_sum_vec_kernel<T><<<row_grid(n_rows, 1, 1), block, 0, s>>>(
        gp, row_ptr, n_rows, out);
  } else if (f <= 32) {
    segment_sum_kernel<T, 1><<<row_grid(n_rows, f, 32), block, 0, s>>>(
        gp, f, row_ptr, n_rows, out);
  } else if (f <= 64) {
    segment_sum_kernel<T, 2><<<row_grid(n_rows, f, 64), block, 0, s>>>(
        gp, f, row_ptr, n_rows, out);
  } else {
    segment_sum_kernel<T, 4><<<row_grid(n_rows, f, 128), block, 0, s>>>(
        gp, f, row_ptr, n_rows, out);
  }
}

}  // namespace

// Every entry: dtype 0 = float32, 1 = bfloat16 (of the table / h and g /
// g); int32 CSR arrays; f32 val and outputs. Returns the CUDA error code of
// the launch (0 = cudaSuccess). Launches on `stream`; does not synchronise
// and allocates nothing.
extern "C" {

// perm may be null (identity).
int edge_csr_spmm(int device, int dtype, const void* table, int f,
                  const void* row_ptr, const void* col, const void* val,
                  const void* perm, int n_rows, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || f <= 0) return 0;
  const auto* p = static_cast<const int32_t*>(row_ptr);
  const auto* c = static_cast<const int32_t*>(col);
  const auto* v = static_cast<const float*>(val);
  const auto* pm = static_cast<const int32_t*>(perm);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    csr_spmm<float>(table, f, p, c, v, pm, n_rows, o, s);
  } else if (dtype == 1) {
    csr_spmm<__nv_bfloat16>(table, f, p, c, v, pm, n_rows, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int edge_sddmm(int device, int dtype, const void* h, const void* g, int f,
               const void* row_ptr, const void* col, int n_rows, void* dval,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || f <= 0) return 0;
  const auto* p = static_cast<const int32_t*>(row_ptr);
  const auto* c = static_cast<const int32_t*>(col);
  auto* o = static_cast<float*>(dval);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sddmm<float>(h, g, f, p, c, n_rows, o, s);
  } else if (dtype == 1) {
    sddmm<__nv_bfloat16>(h, g, f, p, c, n_rows, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// f == 1 is the (E,) cotangent.
int edge_segment_sum(int device, int dtype, const void* g, int f,
                     const void* row_ptr, int n_rows, void* out,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || f <= 0) return 0;
  const auto* p = static_cast<const int32_t*>(row_ptr);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    segment_sum<float>(g, f, p, n_rows, o, s);
  } else if (dtype == 1) {
    segment_sum<__nv_bfloat16>(g, f, p, n_rows, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* edge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
