// The slot-gather pass for Hopper (sm_90a), shared by K1/K2
// (hyb_spmm.cu: one table) and K8 (fused_spmm.cu: local rows and ghost rows).
//
// One launch runs every part of a plan (the buckets and the hub top of a
// hybrid-ELL plan, or the one part of a degree plan):
//
//   out[out_idx[i], :] = sum_{r in [row_ptr[i], row_ptr[i+1])}
//                        sum_{j < cnt[r]}  w[r, j] * src(rows[r, j])[:]
//
// with w = the part's values (static mode) or 1 (mask mode, no value read),
// row_ptr == nullptr meaning one slot row per output row (a bucket), and
// src(s) = table + s * ld (one table) or, for K8, s < split ? h + s * ld :
// ghosts + (s - split) * ld. A part that reads local rows only carries
// split = INT_MAX. The caller zero-fills `out` (isolated rows); every written
// row has one writer, so there are no atomics and a pass gives the same bits
// on every run.
//
// The parts travel by value in the launch's parameters (PassParams): each
// with its pointers, its slot-row width, its output row count, its first
// block and whether its rows are wide. A block finds its part from the first
// blocks (uniform across the block: no divergence), so the plan's parts need
// one launch, not one each. The host builds the table once per plan and
// group size (ops/gather_parts.py).
//
// What bounds it: the gathered bytes (E * F * sizeof(T) at data-dependent
// addresses, mostly from the 50 MB L2) and, at the port's widths, the
// instructions spent per gathered element. The design:
//   * 16-byte loads across a row: a group of G lanes reads one table row,
//     each lane 16 bytes (8 bf16 or 4 f32) at column c0 = gl * kVec. G is the
//     row's 16-byte pieces rounded up to 8, 16 or 32; rows wider than 32
//     pieces walk column tiles on blockIdx.y. The host pads the gather table
//     to a leading dimension ld that is a multiple of 16 bytes.
//   * a team of R groups owns one output row: R = 1 for parts of short rows
//     (each group its own row, 32 / G rows a warp), R = 32 / G for wide
//     parts (the warp's groups split the row's slots and add their partial
//     sums by __shfl_xor_sync in a fixed order at the row's end);
//   * the team loads its slot indices (and values) one coalesced chunk of
//     R * G at a time and broadcasts them with __shfl_sync; each lane issues
//     kUnroll (4, or 8 for f32 rows of 32 lanes) independent 16-byte loads
//     before it uses any;
//   * bf16 static products are one packed multiply per two elements
//     (mul.bf16x2: the exact product rounded once to bf16, as the plain
//     version's bf16 multiply), then two f32 adds; mask mode adds the table
//     values; sums stay in f32 registers.
// Measured on the H100 and not kept (PERF.md, Findings): 2 loads in flight a
// lane, or 8 in bf16, a warp per row for every part, 2, 3 or 6 blocks an SM
// as launch bounds, L2-only loads, and P3's shape (cp.async rows into a
// shared-memory ring of 16 a lane): each tied or lost on the Reddit and
// shard plans.

#pragma once

#include <cstring>

#include "gather.cuh"

namespace dorylus {

constexpr int kPassThreads = 256;  // 8 warps a block
constexpr int kMaxParts = 56;      // parts one launch carries (64 bytes each)

struct PartDesc {
  const int32_t* rows;     // (slot rows, w)
  const void* vals;        // (slot rows, w) in the table's dtype, or null
  const int32_t* cnt;      // (slot rows,): the live prefix of each slot row
  const int32_t* row_ptr;  // (n_out + 1,) runs of slot rows, or null
  const int32_t* out_idx;  // (n_out,): the output row of each team
  int32_t w;
  int32_t n_out;
  int32_t block0;  // the part's first block; ascending over the parts
  int32_t split;   // slot indices >= split read the second table
  int32_t wide;    // 1: a warp per output row; 0: a group per output row
  int32_t pad;
};
static_assert(sizeof(PartDesc) == 64, "PartDesc must match ops/gather_parts.py");

struct PassParams {
  PartDesc parts[kMaxParts];
  int32_t n_parts;
};

template <typename T>
struct OneTable {
  const T* tab;
  int64_t ld;
  __device__ __forceinline__ const T* row(int s, int) const { return tab + s * ld; }
};

template <typename T>
struct TwoTables {
  const T* h;
  const T* ghosts;
  int64_t ld;
  __device__ __forceinline__ const T* row(int s, int split) const {
    return s < split ? h + s * ld : ghosts + (int64_t)(s - split) * ld;
  }
};

// A lane's 16 bytes of a table row: its elements, its slot weight as the
// 32 bits a shuffle moves, and the weighted add into its f32 sums.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static uint32_t weight(const void* vals, int64_t k) {
    return __float_as_uint(static_cast<const float*>(vals)[k]);
  }
  template <bool kUnit>
  __device__ __forceinline__ static void add(float (&acc)[4], uint4 x, uint32_t a) {
    const float w = __uint_as_float(a);
    const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k] += kUnit ? __uint_as_float(v[k]) : w * __uint_as_float(v[k]);
    }
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // the weight twice, as a bf16x2
  __device__ __forceinline__ static uint32_t weight(const void* vals, int64_t k) {
    const uint32_t b = static_cast<const uint16_t*>(vals)[k];
    return b | (b << 16);
  }
  __device__ __forceinline__ static uint32_t mul2(uint32_t a, uint32_t b) {
    __nv_bfloat162 x, y;
    memcpy(&x, &a, 4);
    memcpy(&y, &b, 4);
    const __nv_bfloat162 z = __hmul2(x, y);
    uint32_t r;
    memcpy(&r, &z, 4);
    return r;
  }
  template <bool kUnit>
  __device__ __forceinline__ static void add(float (&acc)[8], uint4 x, uint32_t a) {
    const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t p = kUnit ? v[k] : mul2(a, v[k]);
      acc[2 * k] += __uint_as_float(p << 16);  // the element at the lower address
      acc[2 * k + 1] += __uint_as_float(p & 0xffff0000u);
    }
  }
};

// One team of R groups of G lanes: the output rows rel * teams + team of
// part d.
template <typename T, int G, int R, bool kUnit, class Src>
__device__ __forceinline__ void team_pass(const PartDesc& d, const Src& src, int f, int rel,
                                          float* __restrict__ out) {
  constexpr int kVec = Lane<T>::kVec;
  constexpr int kTeam = G * R;  // lanes of one output row
  // 16-byte loads a lane keeps in flight: 8 for f32 rows of 32 lanes (no
  // spill there, 3% faster at F=128), 4 elsewhere (8 spills under the cap)
  constexpr int kUnroll = sizeof(T) == 4 && G == 32 ? 8 : 4;
  const int tid = threadIdx.x;
  const int tl = tid % kTeam;
  const int q = tl / G;   // the lane's group in its team
  const int gl = tl % G;  // the lane's 16 bytes in a row
  const int i = rel * (kPassThreads / kTeam) + tid / kTeam;
  if (i >= d.n_out) return;  // uniform across the team
  const unsigned mask =
      kTeam == 32 ? kFullMask : ((1u << (kTeam % 32)) - 1u) << ((tid & 31) & ~(kTeam - 1));
  const int c0 = blockIdx.y * (G * kVec) + gl * kVec;
  const bool col_live = c0 < src.ld;  // ld is a multiple of kVec

  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;

  const int r_begin = d.row_ptr ? d.row_ptr[i] : i;
  const int r_end = d.row_ptr ? d.row_ptr[i + 1] : i + 1;
  for (int r = r_begin; r < r_end; ++r) {
    const int n = d.cnt[r];  // live prefix of slot row r
    const int64_t base = (int64_t)r * d.w;
    for (int j0 = 0; j0 < n; j0 += kTeam) {
      int my_s = 0;
      uint32_t my_a = 0;
      if (j0 + tl < n) {
        my_s = d.rows[base + j0 + tl];
        if (!kUnit) my_a = Lane<T>::weight(d.vals, base + j0 + tl);
      }
      const int m = min(kTeam, n - j0);  // slots of this chunk
      const int steps = (m + R - 1) / R;  // uniform across the team
      for (int t0 = 0; t0 < steps; t0 += kUnroll) {
        uint4 x[kUnroll];
        uint32_t a[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int sl = q + R * (t0 + u);  // this group's slot of the chunk
          const int s = __shfl_sync(mask, my_s, sl % kTeam, kTeam);
          a[u] = kUnit ? 0u : __shfl_sync(mask, my_a, sl % kTeam, kTeam);
          x[u] = make_uint4(0u, 0u, 0u, 0u);
          if (col_live && sl < m) {
            x[u] = __ldg(reinterpret_cast<const uint4*>(src.row(s, d.split) + c0));
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) Lane<T>::template add<kUnit>(acc, x[u], a[u]);
      }
    }
  }

  // the groups' partial sums, in the same order on every run
#pragma unroll
  for (int o = G; o < kTeam; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] += __shfl_xor_sync(mask, acc[k], o);
  }
  if (q != 0 || c0 >= f) return;
  float* dst = out + (int64_t)d.out_idx[i] * f + c0;
  if (c0 + kVec <= f && (f & 3) == 0) {
#pragma unroll
    for (int k = 0; k < kVec; k += 4) {
      *reinterpret_cast<float4*>(dst + k) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (c0 + k < f) dst[k] = acc[k];
    }
  }
}

template <typename T, int G, bool kUnit, class Src>
__global__ void __launch_bounds__(kPassThreads, 4)
gather_pass_kernel(const __grid_constant__ PassParams p, const Src src, int f,
                   float* __restrict__ out) {
  int k = 0;
  for (int j = 1; j < p.n_parts; ++j) {
    if (static_cast<int>(blockIdx.x) >= p.parts[j].block0) k = j;
  }
  const PartDesc d = p.parts[k];
  const int rel = blockIdx.x - d.block0;
  if (G < 32 && d.wide) {
    team_pass<T, G, 32 / G, kUnit>(d, src, f, rel, out);
  } else {
    team_pass<T, G, 1, kUnit>(d, src, f, rel, out);
  }
}

template <typename T, bool kUnit, class Src>
cudaError_t launch_group(int g, const PassParams& p, const Src& src, int f, int n_blocks,
                         int col_tiles, float* out, cudaStream_t stream) {
  const dim3 grid(n_blocks, col_tiles);
  if (g == 8) {
    gather_pass_kernel<T, 8, kUnit, Src><<<grid, kPassThreads, 0, stream>>>(p, src, f, out);
  } else if (g == 16) {
    gather_pass_kernel<T, 16, kUnit, Src><<<grid, kPassThreads, 0, stream>>>(p, src, f, out);
  } else if (g == 32) {
    gather_pass_kernel<T, 32, kUnit, Src><<<grid, kPassThreads, 0, stream>>>(p, src, f, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The host side of both libraries' entries. dtype: 0 = float32, 1 =
// bfloat16 (tables and values); unit: mask mode; g: lanes of a group (8, 16
// or 32); parts: n_parts PartDescs in host memory, their block0 laid out for
// g; make(T{}) builds the row source of dtype T. Returns the CUDA error code
// of the launch (0 = cudaSuccess); launches on `stream`, does not
// synchronise, allocates nothing.
template <class Make>
int run_pass(int device, int dtype, int unit, int g, const void* parts, int n_parts,
             int n_blocks, int col_tiles, int f, void* out, void* stream, Make make) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts > kMaxParts || n_parts < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_parts == 0 || n_blocks <= 0 || f <= 0) return 0;
  PassParams p;
  memcpy(p.parts, parts, n_parts * sizeof(PartDesc));
  p.n_parts = n_parts;
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto src = make(float{});
    err = unit ? launch_group<float, true>(g, p, src, f, n_blocks, col_tiles, o, s)
               : launch_group<float, false>(g, p, src, f, n_blocks, col_tiles, o, s);
  } else if (dtype == 1) {
    const auto src = make(__nv_bfloat16{});
    err = unit ? launch_group<__nv_bfloat16, true>(g, p, src, f, n_blocks, col_tiles, o, s)
               : launch_group<__nv_bfloat16, false>(g, p, src, f, n_blocks, col_tiles, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace dorylus
