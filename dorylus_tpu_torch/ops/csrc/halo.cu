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
//   stay zero). Bound by bytes: it reads each row it names and writes each
//   output row once, 14-120 MB at rank 0's Reddit shard, a few tens of
//   microseconds. A team of g lanes owns an output row (the team sized from
//   the row's bytes, parallel/halo.py `row_gather_geometry`); one lane reads
//   the row's index and the team shares it by shuffle; a team issues the
//   loads of kRows rows before it stores any, and walks its rows
//   grid-stride, with no division. A row moves in the widest unit of 16, 8,
//   4 or 2 bytes that divides its bytes, lane j on units j, j + g, ...: the
//   rows of F = 128 move 16 bytes a lane, F = 41 4 bytes (f32) or 2 (bf16).
//   (Realigning F = 41's rows into 16-byte blocks with funnel shifts, and
//   their heads and tails an element at a time, ran 1.3-1.6x slower on the
//   H100: PERF.md, the K9 findings.) A -1 slot reads nothing and writes
//   zeros.
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
constexpr int kRows = 4;  // rows a K9 team has in flight

template <typename U>
__device__ __forceinline__ U zero_unit() {
  return U{};
}

// The lanes of this lane's team of g (a power of two, 4..32) in its warp.
template <int G>
__device__ __forceinline__ unsigned team_mask() {
  if (G == 32) return kFullMask;
  return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// Lane j of the team copies units j, j + g, ... of kRows rows, S of them a
// row before the next column chunk.
template <typename U, int G, int S>
__global__ void __launch_bounds__(kThreads)
row_gather_units(const U* __restrict__ in, const int32_t* __restrict__ idx, int units,
                 int n_out, U* __restrict__ out) {
  const int tl = threadIdx.x & (G - 1);
  const unsigned mask = team_mask<G>();
  const int n_teams = gridDim.x * (kThreads / G);
  for (int r0 = (blockIdx.x * kThreads + threadIdx.x) / G * kRows; r0 < n_out;
       r0 += n_teams * kRows) {
    const int my = tl < kRows && r0 + tl < n_out ? idx[r0 + tl] : -1;
    int src[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) src[k] = __shfl_sync(mask, my, k, G);
    for (int c0 = 0; c0 < units; c0 += G * S) {
      U v[kRows][S];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int c = c0 + s * G + tl;
          v[k][s] = src[k] >= 0 && c < units ? in[(int64_t)src[k] * units + c]
                                               : zero_unit<U>();
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r0 + k >= n_out) break;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int c = c0 + s * G + tl;
          if (c < units) out[(int64_t)(r0 + k) * units + c] = v[k][s];
        }
      }
    }
  }
}

template <typename U, int G, int S>
cudaError_t launch_units(const void* in, const int32_t* idx, int rb, int n_out, void* out,
                         int blocks, cudaStream_t s) {
  row_gather_units<U, G, S><<<blocks, kThreads, 0, s>>>(
      static_cast<const U*>(in), idx, rb / (int)sizeof(U), n_out, static_cast<U*>(out));
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_units_g(int g, int steps, const void* in, const int32_t* idx, int rb,
                           int n_out, void* out, int blocks, cudaStream_t s) {
  switch (g * 4 + steps) {
    case 4 * 4 + 1: return launch_units<U, 4, 1>(in, idx, rb, n_out, out, blocks, s);
    case 8 * 4 + 1: return launch_units<U, 8, 1>(in, idx, rb, n_out, out, blocks, s);
    case 16 * 4 + 1: return launch_units<U, 16, 1>(in, idx, rb, n_out, out, blocks, s);
    case 32 * 4 + 1: return launch_units<U, 32, 1>(in, idx, rb, n_out, out, blocks, s);
    case 32 * 4 + 2: return launch_units<U, 32, 2>(in, idx, rb, n_out, out, blocks, s);
    default: return cudaErrorInvalidValue;
  }
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
// of row_bytes bytes. in and out must be 16-byte aligned. The launch
// (parallel/halo.py `row_gather_geometry`): unit = 16, 8, 4 or 2, the bytes
// a lane moves at once (row_bytes a multiple of it); g: lanes a team (4, 8,
// 16 or 32); steps: units a lane a row per column chunk (1, or 2 with g =
// 32); blocks of 256 threads, each team kRows = 4 rows at a time,
// grid-stride. Returns the CUDA error code of the launch. Launches on
// `stream`; does not synchronise and allocates nothing.
int halo_row_gather(int device, const void* in, int row_bytes, const void* idx, int n_out,
                    void* out, int unit, int g, int steps, int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out <= 0 || row_bytes <= 0 || blocks <= 0) return 0;
  if (unit <= 0 || row_bytes % unit != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* idx_i = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: err = launch_units_g<uint4>(g, steps, in, idx_i, row_bytes, n_out, out, blocks, s);
      break;
    case 8: err = launch_units_g<uint2>(g, steps, in, idx_i, row_bytes, n_out, out, blocks, s);
      break;
    case 4: err = launch_units_g<uint32_t>(g, steps, in, idx_i, row_bytes, n_out, out, blocks,
                                           s);
      break;
    case 2: err = launch_units_g<uint16_t>(g, steps, in, idx_i, row_bytes, n_out, out, blocks,
                                           s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
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
