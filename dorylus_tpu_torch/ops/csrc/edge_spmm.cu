// Edgewise aggregation over CSR, for Hopper (sm_90a).
//
// Replaces dorylus_tpu/ops/spmm.py, the path kernel="xla" (and "auto" up to
// 8M edges) runs: `spmm_edgewise` / `aggregate` / `spmm_dst_blocked`
// (gather h[src] * val, sorted segment-sum over dst) with the backward JAX
// autodiff gives it, and `take_sorted`'s segment-sum backward. Over a CSR
// whose rows are contiguous edge ranges:
//
//   K3 csr_spmm     out[r] = sum_{e in [ptr[r], ptr[r+1])}
//                            round_T(val[perm(e)]) * table[col[e]]
//                   forward: the dst CSR (col = src, perm = identity);
//                   dh: the src CSR (col = dst[order], perm = order), so
//                   val is read through the permutation in the kernel and
//                   no permuted copy of it is made per call.
//   K4 sddmm        dval[e] = <h[col[e]], g[r]> for e in row r of the dst
//                   CSR: the value gradient of GAT's attention, alone where
//                   only val needs a gradient;
//   K3 + K4 fused   the dh pass that also writes <gout[t_col[e']], h[s]>
//                   for the edges e' of src row s, at e' (coalesced; the
//                   caller gathers it into the edges' order): one gather of
//                   the gout rows serves dh and dval (GAT on the edgewise
//                   path, every layer);
//   K5 segment_sum  out[r] = sum_{e in [ptr[r], ptr[r+1])} g[e], for (E,)
//                   and (E, F) cotangents: take_sorted's backward. The
//                   (E,) form (GAT's attention cotangent, 11.65M edges at
//                   Reddit scale, 47 MB) reads g in 16-byte chunks, a team
//                   of 4-32 lanes a row sized from the mean row length,
//                   and a warp for a row of more than 128 chunks (see
//                   `segment_sum_team_kernel`); the (E, F) form gives a
//                   warp a row, lanes across F.
//
// K3 and K4 are the CSR team of the gather core (gather_pass.cuh,
// `csr_pass_kernel`): one launch a pass, a group of 8-32 lanes reads a row
// with 16-byte loads from a table padded to a multiple of 16 bytes
// (ops/gather_parts.py `gather_table`), 4 loads in flight a lane (8 for f32
// rows of 32 lanes; 4 with the dot), each edge's dot reduce-scattered
// across its group.
//
// What bounds them: K3 and K4 gather E * F * sizeof(T) bytes of table rows
// at data-dependent addresses (11.6M edges at Reddit scale: 6 GB in f32 at
// F = 128, past the 50 MB L2 for a 120 MB table), plus 8-12 bytes of index
// and value per edge; K5 streams its input once. All do one or two flops
// per byte moved, far below the card's compute. Every output row (K3, K5)
// and every edge value (K4) has exactly one writer: no atomics, and the
// same sums in the same order on every run.
//
// Numerics (JAX forms `h[src] * val.astype(h.dtype)`): val is rounded to
// the table dtype and each product is formed in it (bf16 products are
// rounded to bf16, by mul.bf16x2); sums are f32. K4 forms f32 products of
// the two rows and sums them in f32.

#include "gather_pass.cuh"

namespace {

using dorylus::csr_pass_kernel;
using dorylus::kFullMask;
using dorylus::CsrParams;
using dorylus::kPassThreads;
using dorylus::to_float;
using dorylus::warp_sum;

constexpr int kWarpsPerBlock = 8;

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

// (E,) cotangent. A team of G lanes sums a row: the row's edges lie in
// 16-byte chunks of g (chunk c holds the elements [c*V - head, c*V - head +
// V), V = 16 / sizeof(T), head = the elements between g and the 16-byte
// boundary below it, so a view of any alignment reads whole aligned
// chunks), lane j takes chunks j, j + G, ..., two in flight, keeps the
// elements of its row, and the team adds its lanes in a fixed butterfly;
// the team's first lane writes the row. A chunk that reaches past either
// end of g is read element by element. A row of more than kHubChunks chunks
// is left by its team to the whole warp, which walks the warp's hub rows
// one after the other after its teams' rows (a warp's 32 lanes, 32 chunks a
// step). One writer a row, the same order on every run.
constexpr int kHubChunks = 128;

template <typename T>
struct Chunk {
  static constexpr int V = 16 / sizeof(T);
  // The sum of the elements of chunk c that lie in [b, e), in order.
  static __device__ __forceinline__ float sum(const T* __restrict__ g, int64_t n, int head,
                                              int64_t c, int64_t b, int64_t e) {
    const int64_t lo = c * V - head;
    float acc = 0.f;
    if (lo >= 0 && lo + V <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + lo);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (lo + k >= b && lo + k < e) acc += to_float(x[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (lo + k >= b && lo + k < e) acc += to_float(g[lo + k]);
      }
    }
    return acc;
  }
};

// The sum of g over [b, e) by the n lanes tl = 0..n-1 that share `mask`,
// chunks tl, tl + n, ... of the row, two a step; each lane's share.
template <typename T>
__device__ __forceinline__ float lane_share(const T* __restrict__ g, int64_t n_el, int head,
                                            int64_t b, int64_t e, int tl, int n) {
  constexpr int V = Chunk<T>::V;
  float acc = 0.f;
  if (b >= e) return acc;
  const int64_t c_lo = (b + head) / V, c_hi = (e - 1 + head) / V;
  for (int64_t c = c_lo + tl; c <= c_hi; c += 2 * n) {
    const float a0 = Chunk<T>::sum(g, n_el, head, c, b, e);
    const float a1 = c + n <= c_hi ? Chunk<T>::sum(g, n_el, head, c + n, b, e) : 0.f;
    acc += a0;
    acc += a1;
  }
  return acc;
}

template <typename T, int G>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_team_kernel(const T* __restrict__ g, int64_t n_el, int head,
                        const int32_t* __restrict__ row_ptr, int n_rows,
                        float* __restrict__ out) {
  constexpr int V = Chunk<T>::V;
  const int lane = threadIdx.x & 31;
  const int tl = lane & (G - 1);
  const unsigned mask = G == 32 ? kFullMask : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int r = (blockIdx.x * 32 * kWarpsPerBlock + threadIdx.x) / G;
  int64_t b = 0, e = 0;
  if (r < n_rows) {
    b = row_ptr[r];
    e = row_ptr[r + 1];
  }
  const bool hub = G < 32 && e > b && (e - 1 + head) / V - (b + head) / V >= kHubChunks;
  if (r < n_rows && !hub) {
    float acc = lane_share(g, n_el, head, b, e, tl, G);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(mask, acc, o);
    if (tl == 0) out[r] = acc;
  }
  if (G < 32) {
    // the warp's hub rows, by the whole warp
    unsigned hubs = __ballot_sync(kFullMask, hub && tl == 0);
    while (hubs) {
      const int leader = __ffs(hubs) - 1;
      hubs &= hubs - 1;
      const int64_t hb = __shfl_sync(kFullMask, b, leader);
      const int64_t he = __shfl_sync(kFullMask, e, leader);
      const float acc = warp_sum(lane_share(g, n_el, head, hb, he, lane, 32));
      if (lane == leader) out[r] = acc;
    }
  }
}

template <typename T>
cudaError_t launch_segment_sum_vec(int team, const void* g, int64_t n_el,
                                   const int32_t* row_ptr, int n_rows, float* out,
                                   cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  // the elements between g and the 16-byte boundary at or below it
  const int head = (int)((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T));
  const dim3 block(32 * kWarpsPerBlock);
  const int rows_a_block = 32 * kWarpsPerBlock / team;
  const int blocks = (n_rows + rows_a_block - 1) / rows_a_block;
  switch (team) {
    case 4: segment_sum_team_kernel<T, 4><<<blocks, block, 0, s>>>(gp, n_el, head, row_ptr,
                                                                    n_rows, out); break;
    case 8: segment_sum_team_kernel<T, 8><<<blocks, block, 0, s>>>(gp, n_el, head, row_ptr,
                                                                    n_rows, out); break;
    case 16: segment_sum_team_kernel<T, 16><<<blocks, block, 0, s>>>(gp, n_el, head, row_ptr,
                                                                      n_rows, out); break;
    case 32: segment_sum_team_kernel<T, 32><<<blocks, block, 0, s>>>(gp, n_el, head, row_ptr,
                                                                      n_rows, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

dim3 row_grid(int n_rows, int f, int cols_per_warp) {
  return dim3((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (f + cols_per_warp - 1) / cols_per_warp);
}

// (E, F) cotangent: a warp a row, lanes across F.
template <typename T>
cudaError_t segment_sum_rows(const void* g, int f, const int32_t* row_ptr, int n_rows,
                             float* out, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const T* gp = static_cast<const T*>(g);
  if (f <= 32) {
    segment_sum_kernel<T, 1><<<row_grid(n_rows, f, 32), block, 0, s>>>(
        gp, f, row_ptr, n_rows, out);
  } else if (f <= 64) {
    segment_sum_kernel<T, 2><<<row_grid(n_rows, f, 64), block, 0, s>>>(
        gp, f, row_ptr, n_rows, out);
  } else {
    segment_sum_kernel<T, 4><<<row_grid(n_rows, f, 128), block, 0, s>>>(
        gp, f, row_ptr, n_rows, out);
  }
  return cudaGetLastError();
}

template <typename T, bool kSum, bool kDot>
cudaError_t launch_csr_group(int g, const CsrParams& p, int n_blocks, cudaStream_t s) {
  if (g == 8) {
    csr_pass_kernel<T, 8, kSum, kDot><<<n_blocks, kPassThreads, 0, s>>>(p);
  } else if (g == 16) {
    csr_pass_kernel<T, 16, kSum, kDot><<<n_blocks, kPassThreads, 0, s>>>(p);
  } else if (g == 32) {
    csr_pass_kernel<T, 32, kSum, kDot><<<n_blocks, kPassThreads, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// mode: 1 K3's sum, 2 K4's dot, 3 both.
template <typename T>
cudaError_t launch_csr_mode(int mode, int g, const CsrParams& p, int n_blocks, cudaStream_t s) {
  switch (mode) {
    case 1: return launch_csr_group<T, true, false>(g, p, n_blocks, s);
    case 2: return launch_csr_group<T, false, true>(g, p, n_blocks, s);
    case 3: return launch_csr_group<T, true, true>(g, p, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry: dtype 0 = float32, 1 = bfloat16 (of the tables / g);
// int32 CSR arrays; f32 val and outputs. Returns the CUDA error code of the
// launch (0 = cudaSuccess). Launches on `stream`; does not synchronise and
// allocates nothing.
extern "C" {

// K3, K4 or both in one pass (gather_pass.cuh `CsrParams`). mode: 1 the
// sum into out (n_rows, f), 2 the dot into dval, 3 both. tab and own:
// (rows, ld) with ld a multiple of 16 bytes, f <= ld; own may be null in
// mode 1, val and out in mode 2; perm null is the identity; dval (E,) in
// the CSR's edge order. g: lanes of a
// group (8, 16 or 32); wide: a warp per row; n_blocks: of 256 threads,
// 256 / (wide or g == 32 ? 32 : g) rows a block.
int edge_csr_pass(int device, int dtype, int mode, int g, int wide, int n_blocks,
                  const void* tab, const void* own, int ld, int f, const void* row_ptr,
                  const void* col, const void* val, const void* perm, int n_rows, int own_rows,
                  void* out, void* dval, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks <= 0 || n_rows <= 0) return 0;
  CsrParams p;
  p.tab = tab;
  p.own = own;
  p.row_ptr = static_cast<const int32_t*>(row_ptr);
  p.col = static_cast<const int32_t*>(col);
  p.val = static_cast<const float*>(val);
  p.perm = static_cast<const int32_t*>(perm);
  p.out = static_cast<float*>(out);
  p.dval = static_cast<float*>(dval);
  p.ld = ld;
  p.f = f;
  p.n_rows = n_rows;
  p.own_rows = own_rows;
  p.wide = wide;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_csr_mode<float>(mode, g, p, n_blocks, s);
  } else if (dtype == 1) {
    err = launch_csr_mode<__nv_bfloat16>(mode, g, p, n_blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// K5. g: (n_edges,) when f == 1 (the (E,) cotangent, any alignment of its
// element type; team: lanes a row, 4, 8, 16 or 32, ops/spmm.py
// `segment_sum_geometry`), else (n_edges, f) (a warp a row, team unused); row_ptr: n_rows + 1 int32 offsets; out: n_rows f32
// (times f), every row written.
int edge_segment_sum(int device, int dtype, const void* g, int f, long long n_edges,
                     const void* row_ptr, int n_rows, int team, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0 || f <= 0) return 0;
  const auto* p = static_cast<const int32_t*>(row_ptr);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = f == 1 ? launch_segment_sum_vec<float>(team, g, n_edges, p, n_rows, o, s)
                 : segment_sum_rows<float>(g, f, p, n_rows, o, s);
  } else if (dtype == 1) {
    err = f == 1 ? launch_segment_sum_vec<__nv_bfloat16>(team, g, n_edges, p, n_rows, o, s)
                 : segment_sum_rows<__nv_bfloat16>(g, f, p, n_rows, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* edge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
