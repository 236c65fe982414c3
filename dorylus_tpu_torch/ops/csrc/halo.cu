// The halo exchange's two device passes for Hopper (sm_90a).
//
// Replaces the gathers and the segment-sum around the collective in
// dorylus_tpu/parallel/halo.py `_halo_recv_planned` and `ragged_halo_recv`
// (forward `buf = h[send_idx]` / `h[rg["rows"]]`; backward
// `segment_sum(g[order].f32, rows, vp, sorted)`). The collective itself is
// torch.distributed's; these kernels pack its send buffer, place what it
// delivered, and reduce what came back.
//
// K9, row gather:    out[i, :] = idx[i] >= 0 ? in[idx[i], :] : 0
//   Packs the rows each peer needs (idx = the send lists) and, on the exact
//   wire, places the received rows into the padded ghost layout (idx = a
//   host-built slot map, -1 for the slots past a pair's exact count, which
//   stay zero). Bound by bytes: it reads and writes each row once. A row is
//   copied in the widest unit (16, 8, 4 or 2 bytes) that divides its byte
//   width, neighbouring threads on neighbouring units, so F = 128 moves 16
//   bytes a thread and F = 41 still moves whole elements.
//
// K10, gathered sorted segment-sum:
//   out[r, :] = sum_{j in [row_ptr[r], row_ptr[r+1])} float(g[order[j], :])
//   `order` sorts the returned ghost-gradient rows by the local row they
//   belong to (a row repeats when several peers needed it); row_ptr is the
//   host-built offset of each local row's run. One warp owns one local row,
//   lanes across F, sums in f32 registers: one writer per row, no atomics,
//   the same order on every run. Rows no peer needs get zero (the kernel
//   writes every row, so the output needs no fill). Bound by bytes too: each
//   g row is read once, each out row written once. One warp walks a whole
//   run; a run holds at most one entry per peer (a peer needs a local row
//   once; the padded wire's pad slots are left out of the plan), so no run
//   is long.

#include "gather.cuh"

namespace {

using dorylus::kFullMask;
using dorylus::to_float;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 8;

template <typename U>
__device__ __forceinline__ U zero_unit();
template <>
__device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint2 zero_unit<uint2>() {
  return make_uint2(0u, 0u);
}
template <>
__device__ __forceinline__ uint32_t zero_unit<uint32_t>() {
  return 0u;
}
template <>
__device__ __forceinline__ uint16_t zero_unit<uint16_t>() {
  return 0;
}

// One thread copies one unit of one output row.
template <typename U>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const U* __restrict__ in, const int32_t* __restrict__ idx,
                  int units_per_row, int64_t total, U* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / units_per_row;
  const int c = (int)(t - row * units_per_row);
  const int s = idx[row];
  out[t] = s >= 0 ? in[(int64_t)s * units_per_row + c] : zero_unit<U>();
}

template <typename U>
void launch_gather(const void* in, const int32_t* idx, int row_bytes,
                   int n_out, void* out, cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(U);
  const int64_t total = (int64_t)n_out * units;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  row_gather_kernel<U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(in), idx, units, total, static_cast<U*>(out));
}

template <typename T, int NF>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segsum_gather_kernel(const T* __restrict__ g, int f,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ row_ptr, int n_out,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_out) return;  // r is uniform across the warp
  const int col0 = blockIdx.y * (32 * NF) + lane;

  float acc[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) acc[k] = 0.f;

  const int begin = row_ptr[r];
  const int end = row_ptr[r + 1];
  for (int j0 = begin; j0 < end; j0 += 32) {
    const int my = j0 + lane < end ? order[j0 + lane] : 0;
    const int m = min(32, end - j0);
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      const int s = __shfl_sync(kFullMask, my, t);
      const T* src = g + (int64_t)s * f;
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int c = col0 + 32 * k;
        if (c < f) acc[k] += to_float(src[c]);
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

template <typename T, int NF>
void launch_segsum(const void* g, int f, const int32_t* order,
                   const int32_t* row_ptr, int n_out, float* out,
                   cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (f + 32 * NF - 1) / (32 * NF));
  segsum_gather_kernel<T, NF><<<grid, block, 0, stream>>>(
      static_cast<const T*>(g), f, order, row_ptr, n_out, out);
}

template <typename T>
void launch_segsum_for_width(const void* g, int f, const int32_t* order,
                             const int32_t* row_ptr, int n_out, float* out,
                             cudaStream_t stream) {
  if (f <= 32) {
    launch_segsum<T, 1>(g, f, order, row_ptr, n_out, out, stream);
  } else if (f <= 64) {
    launch_segsum<T, 2>(g, f, order, row_ptr, n_out, out, stream);
  } else {
    launch_segsum<T, 4>(g, f, order, row_ptr, n_out, out, stream);
  }
}

}  // namespace

extern "C" {

// K9. in: rows of row_bytes bytes each (any element type; the copy is
// bitwise); idx: n_out int32 row ids, negative = a zero row; out: n_out rows
// of row_bytes bytes. in and out must be 16-byte aligned. Returns the CUDA
// error code of the launch. Launches on `stream`; does not synchronise and
// allocates nothing.
int halo_row_gather(int device, const void* in, int row_bytes,
                    const void* idx, int n_out, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out <= 0 || row_bytes <= 0) return 0;
  const auto* idx_i = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0) {
    launch_gather<uint4>(in, idx_i, row_bytes, n_out, out, s);
  } else if (row_bytes % 8 == 0) {
    launch_gather<uint2>(in, idx_i, row_bytes, n_out, out, s);
  } else if (row_bytes % 4 == 0) {
    launch_gather<uint32_t>(in, idx_i, row_bytes, n_out, out, s);
  } else if (row_bytes % 2 == 0) {
    launch_gather<uint16_t>(in, idx_i, row_bytes, n_out, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10. dtype: 0 = float32 g, 1 = bfloat16 g. order: int32 row ids into g,
// sorted by the local row they add into; row_ptr: n_out + 1 int32 offsets
// into order; out: (n_out, f) float32, every row written. Returns the CUDA
// error code of the launch.
int halo_segsum(int device, int dtype, const void* g, int f,
                const void* order, const void* row_ptr, int n_out, void* out,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out <= 0 || f <= 0) return 0;
  const auto* order_i = static_cast<const int32_t*>(order);
  const auto* ptr_i = static_cast<const int32_t*>(row_ptr);
  auto* out_f = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_segsum_for_width<float>(g, f, order_i, ptr_i, n_out, out_f, s);
  } else if (dtype == 1) {
    launch_segsum_for_width<__nv_bfloat16>(g, f, order_i, ptr_i, n_out, out_f,
                                           s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* halo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
