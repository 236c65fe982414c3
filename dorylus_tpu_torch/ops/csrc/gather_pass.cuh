// The slot-gather pass for Hopper (sm_90a), shared by K1/K2
// (hyb_spmm.cu: one table) and K8 (fused_spmm.cu: local rows and ghost rows),
// its CSR sibling for K3/K4 (edge_spmm.cu; `csr_pass_kernel` below) and its
// dynamic-value sibling for K7 (dyn_spmm.cu; `dyn_pass_kernel` below).
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
  int32_t slot0;   // the flat slot of (0, 0): the slots of the plan's earlier parts
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
  // an f32 value as the weight: itself
  __device__ __forceinline__ static uint32_t weight_of(float v) { return __float_as_uint(v); }
  __device__ __forceinline__ static void unpack(uint4 x, float (&y)[4]) {
    y[0] = __uint_as_float(x.x);
    y[1] = __uint_as_float(x.y);
    y[2] = __uint_as_float(x.z);
    y[3] = __uint_as_float(x.w);
  }
  // <x, y> over the lane's 16 bytes, f32 products and sums
  __device__ __forceinline__ static float dot(uint4 x, const float (&y)[4]) {
    float d = __uint_as_float(x.x) * y[0];
    d = fmaf(__uint_as_float(x.y), y[1], d);
    d = fmaf(__uint_as_float(x.z), y[2], d);
    return fmaf(__uint_as_float(x.w), y[3], d);
  }
  // <x, y> with each product in T (f32 here), sums in f32
  __device__ __forceinline__ static float dot_in_t(uint4 x, uint4 y) {
    float d = __uint_as_float(x.x) * __uint_as_float(y.x);
    d = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), d);
    d = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), d);
    return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), d);
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
  // an f32 value rounded to bf16, twice
  __device__ __forceinline__ static uint32_t weight_of(float v) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    return b | (b << 16);
  }
  __device__ __forceinline__ static void unpack(uint4 x, float (&y)[8]) {
    const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      y[2 * k] = __uint_as_float(v[k] << 16);
      y[2 * k + 1] = __uint_as_float(v[k] & 0xffff0000u);
    }
  }
  // <x, y> over the lane's 16 bytes: each bf16 element exact in f32, f32
  // products and sums
  __device__ __forceinline__ static float dot(uint4 x, const float (&y)[8]) {
    const uint32_t v[4] = {x.x, x.y, x.z, x.w};
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d = fmaf(__uint_as_float(v[k] << 16), y[2 * k], d);
      d = fmaf(__uint_as_float(v[k] & 0xffff0000u), y[2 * k + 1], d);
    }
    return d;
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
  // <x, y> with each product rounded to bf16 (mul.bf16x2), sums in f32: the
  // plain version's bf16 multiply of the two rows
  __device__ __forceinline__ static float dot_in_t(uint4 x, uint4 y) {
    const uint32_t a[4] = {x.x, x.y, x.z, x.w};
    const uint32_t b[4] = {y.x, y.y, y.z, y.w};
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t p = mul2(a[k], b[k]);
      d += __uint_as_float(p << 16);
      d += __uint_as_float(p & 0xffff0000u);
    }
    return d;
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

// The part of the block: the last whose first block is at or below it
// (uniform across the block).
__device__ __forceinline__ int part_of_block(const PassParams& p) {
  int k = 0;
  for (int j = 1; j < p.n_parts; ++j) {
    if (static_cast<int>(blockIdx.x) >= p.parts[j].block0) k = j;
  }
  return k;
}

template <typename T, int G, bool kUnit, class Src>
__global__ void __launch_bounds__(kPassThreads, 4)
gather_pass_kernel(const __grid_constant__ PassParams p, const Src src, int f,
                   float* __restrict__ out) {
  const PartDesc d = p.parts[part_of_block(p)];
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

// ---- The CSR team: K3 (sum) and K4 (dot), alone or in one pass ----
//
// A CSR is one part of a new kind: output row i owns the edge range
// [row_ptr[i], row_ptr[i+1]) (no slot rows, no live counts), and edge e
// reads table row col[e]. With w(e) = perm ? perm[e] : e:
//
//   sum (kSum): out[i, :] = sum_e round_T(val[w(e)]) * tab[col[e], :]
//   dot (kDot): dval[e] = <tab[col[e], :], own[i, :]>
//
// K3's forward is the sum over the dst CSR (perm = identity); its dh the
// sum over the src CSR with perm = order, so val is read through the
// permutation and no permuted copy is made. With both flags the dh pass
// also writes the value gradient <gout[dst], h[src]> of each of its edges:
// own = h, kept in registers for the row, and the gout rows the pass
// gathers anyway (no second gather of h). It writes dval at the edge's
// place in the src CSR, coalesced (scattered to order[e'], the 4-byte
// stores cost 0.66-0.76 ms more on an H100 at the Reddit shape, PERF.md
// §6): the caller puts it in the dst order with one gather by the inverse
// permutation. K4
// alone is the dot over the dst CSR with own = gout (g[r] in registers).
//
// Lanes, loads and weights as team_pass above: a group of G lanes reads a
// row 16 bytes a lane, kUnroll loads in flight a lane, a team of R groups a
// row (R = 32 / G for CSRs whose rows average WIDE_SLOTS edges), the
// weights rounded to T (a bf16x2 for mul.bf16x2: K3's product rounded once
// to bf16), the sums in f32. Rows wider than G * 16 bytes walk their column
// tiles inside the team (one launch a pass); a tile past the first adds
// its partial dots to the dval its lane wrote for the tile before.
//
// The dots: each lane forms kUnroll partial dots (one per slot in flight,
// over its 16 bytes), then the group reduce-scatters them: log2(kUnroll)
// halving exchanges (kUnroll - 1 shuffles) leave lane gl the dot of slot
// brev(gl) summed over kUnroll lanes, log2(G / kUnroll) butterfly steps add
// the rest, and one more shuffle hands each slot's dot to the lane that
// loaded the slot's index: about 1.1-1.3 shuffles a slot, where a warp sum
// per slot costs log2(G). That lane writes dval[e] once at the chunk's end:
// one writer per edge, no atomics, the same bits on every run.

struct CsrParams {
  const void* tab;         // (rows, ld) in T: the gathered table
  const void* own;         // (own_rows, ld) in T: the output rows' own rows (dot)
  const int32_t* row_ptr;  // (n_rows + 1,)
  const int32_t* col;      // (E,)
  const float* val;        // f32 values, read at w(e) (sum)
  const int32_t* perm;     // (E,) or null: w(e) = e
  float* out;              // (n_rows, f) f32 (sum)
  float* dval;             // (E,) f32, in the CSR's edge order (dot)
  int32_t ld;              // a multiple of 16 bytes
  int32_t f;               // out's columns, f <= ld
  int32_t n_rows;
  int32_t own_rows;        // rows of own; a row past them has no edges
  int32_t wide;
};

// The slot whose dot lane gl holds after the halving exchanges (bit
// reversal of its log2(U) low bits, an involution).
template <int U>
__device__ __forceinline__ int brev_low(int x) {
  constexpr int kBits = U == 2 ? 1 : U == 4 ? 2 : U == 8 ? 3 : U == 16 ? 4 : 5;
  static_assert(U >= 2 && U <= 32 && (U & (U - 1)) == 0, "U: a power of two in [2, 32]");
  return static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - kBits));
}

// d[u]: lane gl's partial dot of slot u. Returns the full dot of slot
// brev_low<U>(gl % U) over the group's G lanes.
template <int G, int U>
__device__ __forceinline__ float reduce_scatter(float (&d)[U], int gl, unsigned mask) {
#pragma unroll
  for (int o = 1; o < U; o <<= 1) {
    const int half = U / (2 * o);  // values a lane keeps after this exchange
    const bool up = gl & o;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? d[k] : d[k + half];
      const float keep = up ? d[k + half] : d[k];
      d[k] = keep + __shfl_xor_sync(mask, send, o);
    }
  }
  float v = d[0];
#pragma unroll
  for (int o = U; o < G; o <<= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

template <typename T, int G, int R, bool kSum, bool kDot>
__device__ __forceinline__ void csr_team(const CsrParams& p) {
  constexpr int kVec = Lane<T>::kVec;
  constexpr int kTeam = G * R;
  // 8 loads in flight for f32 rows of 32 lanes, as team_pass; 4 with the
  // dot (8 spilled 40 bytes there and ran 6% slower)
  constexpr int kUnroll = sizeof(T) == 4 && G == 32 && !kDot ? 8 : 4;
  static_assert(kUnroll <= G, "the reduce-scatter needs a slot per lane at most");
  const int tid = threadIdx.x;
  const int tl = tid % kTeam;
  const int q = tl / G;
  const int gl = tl % G;
  const int i = blockIdx.x * (kPassThreads / kTeam) + tid / kTeam;
  if (i >= p.n_rows) return;  // uniform across the team
  const unsigned mask =
      kTeam == 32 ? kFullMask : ((1u << (kTeam % 32)) - 1u) << ((tid & 31) & ~(kTeam - 1));
  const T* tab = static_cast<const T*>(p.tab);
  const int r_begin = p.row_ptr[i];
  const int r_end = p.row_ptr[i + 1];
  // the lane that holds slot step u's dot, and the step of the lane's own slot
  const int my_step = tl / R;
  const int holder = (tl % R) * G + brev_low<kUnroll>(my_step % kUnroll);

  for (int tile = 0; tile < p.ld; tile += G * kVec) {
    const int c0 = tile + gl * kVec;
    const bool col_live = c0 < p.ld;
    float acc[kVec];
    float own[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = own[k] = 0.f;
    if (kDot && col_live && i < p.own_rows && r_begin < r_end) {
      const T* o = static_cast<const T*>(p.own) + (int64_t)i * p.ld + c0;
      Lane<T>::unpack(__ldg(reinterpret_cast<const uint4*>(o)), own);
    }
    for (int e0 = r_begin; e0 < r_end; e0 += kTeam) {
      int my_s = 0;
      uint32_t my_a = 0;
      if (e0 + tl < r_end) {
        my_s = p.col[e0 + tl];
        if (kSum) my_a = Lane<T>::weight_of(p.val[p.perm ? p.perm[e0 + tl] : e0 + tl]);
      }
      const int m = min(kTeam, r_end - e0);  // edges of this chunk
      const int steps = (m + R - 1) / R;     // uniform across the team
      float mine = 0.f;                      // the dot of the lane's edge
      for (int t0 = 0; t0 < steps; t0 += kUnroll) {
        uint4 x[kUnroll];
        uint32_t a[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int sl = q + R * (t0 + u);  // this group's slot of the chunk
          const int s = __shfl_sync(mask, my_s, sl % kTeam, kTeam);
          a[u] = kSum ? __shfl_sync(mask, my_a, sl % kTeam, kTeam) : 0u;
          x[u] = make_uint4(0u, 0u, 0u, 0u);
          if (col_live && sl < m) {
            x[u] = __ldg(reinterpret_cast<const uint4*>(tab + (int64_t)s * p.ld + c0));
          }
        }
        float d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (kSum) Lane<T>::template add<false>(acc, x[u], a[u]);
          d[u] = kDot ? Lane<T>::dot(x[u], own) : 0.f;
        }
        if (kDot) {
          const float v = reduce_scatter<G, kUnroll>(d, gl, mask);
          const float got = __shfl_sync(mask, v, holder, kTeam);
          if (my_step >= t0 && my_step < t0 + kUnroll) mine = got;
        }
      }
      if (kDot && tl < m) {
        float* d = p.dval + e0 + tl;  // coalesced
        *d = tile == 0 ? mine : *d + mine;
      }
    }
    if (kSum) {
      // the groups' partial sums, in the same order on every run
#pragma unroll
      for (int o = G; o < kTeam; o <<= 1) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] += __shfl_xor_sync(mask, acc[k], o);
      }
      if (q == 0 && c0 < p.f) {
        float* dst = p.out + (int64_t)i * p.f + c0;
        if (c0 + kVec <= p.f && (p.f & 3) == 0) {
#pragma unroll
          for (int k = 0; k < kVec; k += 4) {
            *reinterpret_cast<float4*>(dst + k) =
                make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            if (c0 + k < p.f) dst[k] = acc[k];
          }
        }
      }
    }
  }
}

template <typename T, int G, bool kSum, bool kDot>
__global__ void __launch_bounds__(kPassThreads, 4)
csr_pass_kernel(const __grid_constant__ CsrParams p) {
  if (G < 32 && p.wide) {
    csr_team<T, G, 32 / G, kSum, kDot>(p);
  } else {
    csr_team<T, G, 1, kSum, kDot>(p);
  }
}

// ---- The dynamic-value team: K7's forward, its dh, and dh with the value gradient ----
//
// The slot plans of team_pass with per-edge values (JAX's dynamic mode):
// slot (r, j) of a part weighs its table row by val[s2e[slot0 + r*w + j]],
// rounded to T, with s2e the plan's slot->edge map in flat slot order (the
// plan's parts in plan order, each row-major: JAX's order, in which its e2s
// names an edge's slot). With kDot, the pass over the transposed plan (tab =
// gout, own = h) also forms each live slot's value gradient
//
//   flat[slot0 + r*w + j] = < tab[rows[r, j], :], own[out_idx[i], :] >
//
// with each product in T, as the plain version's (and JAX's) bf16 multiply
// of the two rows; the caller gathers dval = flat[e2s]. The stores are
// coalesced, one writer a slot: the lane that loaded the slot's index.
//
// Lanes, loads, weights and the dots' reduce-scatter as team_pass and
// csr_team above; the part of a block as gather_pass_kernel. Rows wider than
// G * 16 bytes walk their column tiles inside the team (as csr_team), so that
// one lane writes a slot's dot: a tile past the first adds to the value its
// lane stored for the tile before. A hub's slot rows run through row_ptr;
// each slot's dot is its own (the runs are summed for out, not for flat).
// A slot's weight comes from wslot (T, in flat slot order, gathered by the
// caller) where given, else from val through s2e.

struct DynArgs {
  const void* tab;      // (rows, ld) in T: the gathered table
  const void* own;      // (own_rows, ld) in T: the output rows' own rows (kDot)
  const int32_t* s2e;   // (slots,): the edge of each slot, flat slot order
  const float* val;     // (E,) f32 values, read at s2e (wslot null)
  const void* wslot;    // (slots,) in T: each slot's weight, or null
  float* out;           // (num_out, f) f32
  float* flat;          // (slots,) f32: each live slot's dot (kDot)
  int32_t ld;           // a multiple of 16 bytes
  int32_t f;            // out's columns, f <= ld
  int32_t own_rows;     // rows of own; an output row past them has dot 0
};

template <typename T, int G, int R, bool kDot>
__device__ __forceinline__ void dyn_team(const PartDesc& d, const DynArgs& p, int rel) {
  constexpr int kVec = Lane<T>::kVec;
  constexpr int kTeam = G * R;
  // as csr_team: 8 loads in flight for f32 rows of 32 lanes, 4 with the dot
  constexpr int kUnroll = sizeof(T) == 4 && G == 32 && !kDot ? 8 : 4;
  static_assert(kUnroll <= G, "the reduce-scatter needs a slot per lane at most");
  const int tid = threadIdx.x;
  const int tl = tid % kTeam;
  const int q = tl / G;
  const int gl = tl % G;
  const int i = rel * (kPassThreads / kTeam) + tid / kTeam;
  if (i >= d.n_out) return;  // uniform across the team
  const unsigned mask =
      kTeam == 32 ? kFullMask : ((1u << (kTeam % 32)) - 1u) << ((tid & 31) & ~(kTeam - 1));
  const T* tab = static_cast<const T*>(p.tab);
  const int v = d.out_idx[i];
  const int r_begin = d.row_ptr ? d.row_ptr[i] : i;
  const int r_end = d.row_ptr ? d.row_ptr[i + 1] : i + 1;
  // the lane that holds slot step u's dot, and the step of the lane's own slot
  const int my_step = tl / R;
  const int holder = (tl % R) * G + brev_low<kUnroll>(my_step % kUnroll);

  for (int tile = 0; tile < p.ld; tile += G * kVec) {
    const int c0 = tile + gl * kVec;
    const bool col_live = c0 < p.ld;
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    uint4 own = make_uint4(0u, 0u, 0u, 0u);
    if (kDot && col_live && v < p.own_rows) {
      own = __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(p.own) +
                                                 (int64_t)v * p.ld + c0));
    }
    for (int r = r_begin; r < r_end; ++r) {
      const int n = d.cnt[r];  // live prefix of slot row r
      const int64_t row0 = (int64_t)r * d.w;
      const int64_t slot = d.slot0 + row0;  // flat slot of (r, 0)
      for (int j0 = 0; j0 < n; j0 += kTeam) {
        int my_s = 0;
        uint32_t my_a = 0;
        if (j0 + tl < n) {
          my_s = d.rows[row0 + j0 + tl];
          my_a = p.wslot ? Lane<T>::weight(p.wslot, slot + j0 + tl)
                         : Lane<T>::weight_of(p.val[p.s2e[slot + j0 + tl]]);
        }
        const int m = min(kTeam, n - j0);   // slots of this chunk
        const int steps = (m + R - 1) / R;  // uniform across the team
        float mine = 0.f;                   // the dot of the lane's slot
        for (int t0 = 0; t0 < steps; t0 += kUnroll) {
          uint4 x[kUnroll];
          uint32_t a[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int sl = q + R * (t0 + u);  // this group's slot of the chunk
            const int s = __shfl_sync(mask, my_s, sl % kTeam, kTeam);
            x[u] = make_uint4(0u, 0u, 0u, 0u);
            if (col_live && sl < m) {
              x[u] = __ldg(reinterpret_cast<const uint4*>(tab + (int64_t)s * p.ld + c0));
            }
          }
          // the weights after the row loads are issued: a value read through
          // s2e arrives a load after the slot's index
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            a[u] = __shfl_sync(mask, my_a, (q + R * (t0 + u)) % kTeam, kTeam);
          }
          float dd[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            Lane<T>::template add<false>(acc, x[u], a[u]);
            dd[u] = kDot ? Lane<T>::dot_in_t(x[u], own) : 0.f;
          }
          if (kDot) {
            const float got = __shfl_sync(mask, reduce_scatter<G, kUnroll>(dd, gl, mask),
                                          holder, kTeam);
            if (my_step >= t0 && my_step < t0 + kUnroll) mine = got;
          }
        }
        if (kDot && tl < m) {
          float* o = p.flat + slot + j0 + tl;  // coalesced
          *o = tile == 0 ? mine : *o + mine;
        }
      }
    }
    // the groups' partial sums, in the same order on every run
#pragma unroll
    for (int o = G; o < kTeam; o <<= 1) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] += __shfl_xor_sync(mask, acc[k], o);
    }
    if (q == 0 && c0 < p.f) {
      float* dst = p.out + (int64_t)v * p.f + c0;
      if (c0 + kVec <= p.f && (p.f & 3) == 0) {
#pragma unroll
        for (int k = 0; k < kVec; k += 4) {
          *reinterpret_cast<float4*>(dst + k) =
              make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (c0 + k < p.f) dst[k] = acc[k];
        }
      }
    }
  }
}

template <typename T, int G, bool kDot>
__global__ void __launch_bounds__(kPassThreads, 4)
dyn_pass_kernel(const __grid_constant__ PassParams p, const __grid_constant__ DynArgs a) {
  const PartDesc d = p.parts[part_of_block(p)];
  const int rel = blockIdx.x - d.block0;
  if (G < 32 && d.wide) {
    dyn_team<T, G, 32 / G, kDot>(d, a, rel);
  } else {
    dyn_team<T, G, 1, kDot>(d, a, rel);
  }
}

}  // namespace dorylus
