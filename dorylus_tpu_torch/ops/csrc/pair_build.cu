// Pair-table build for pair-reuse aggregation (K6), for Hopper (sm_90a).
//
// Replaces dorylus_tpu/ops/reuse_spmm.py `_build_table`, which appends one
// block of pair rows per mining level:
//
//   tbl = concat(tbl, tbl[p[:, 0]] + tbl[p[:, 1]])
//
// Here the table is one (table_size, F) buffer that the caller allocates
// once and fills with h in its first rows; one launch per level writes
//
//   tbl[base + i, :] = tbl[pairs[i, 0], :] + tbl[pairs[i, 1], :]
//
// with base = the rows below this level. Level k reads only rows below its
// base, which earlier launches on the same stream have written, so the
// levels need no synchronisation beyond stream order and no copy of the
// table is ever made.
//
// What bounds it: a few bytes per pair row (two gathered rows, one
// written) and one launch per level: at the Reddit-scale pair budgets a
// level is tens of thousands of rows, so it is launch-bound. One warp per
// pair row, lanes across F, keeps every row access coalesced.
//
// Numerics: the sum is formed in f32 and rounded once to the table's
// dtype, as a bf16 add rounds in both frameworks. The table is built in
// h's own dtype before any cast to the gather dtype, so a pair row of an
// f32 table is bf16(a + b) after the pass's cast, not bf16(a) + bf16(b).

#include "gather.cuh"

namespace {

using dorylus::to_float;

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pair_level_kernel(T* tbl, int f,
                  const int32_t* __restrict__ pairs, int n_pairs,
                  int64_t base) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_pairs) return;
  const int64_t a = pairs[2 * (int64_t)i];
  const int64_t b = pairs[2 * (int64_t)i + 1];
  const T* ra = tbl + a * f;
  const T* rb = tbl + b * f;
  T* dst = tbl + (base + i) * (int64_t)f;
  for (int c = lane; c < f; c += 32) {
    store(dst + c, to_float(ra[c]) + to_float(rb[c]));
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table, 1 = bfloat16. pairs: (n_pairs, 2) int32 row
// ids, all below `base`. Returns the CUDA error code of the launch (0 =
// cudaSuccess). Launches on `stream`; does not synchronise and allocates
// nothing.
int pair_level(int device, int dtype, void* tbl, int f, const void* pairs,
               int n_pairs, long long base, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs <= 0 || f <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* p = static_cast<const int32_t*>(pairs);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    pair_level_kernel<float><<<grid, block, 0, s>>>(
        static_cast<float*>(tbl), f, p, n_pairs, base);
  } else if (dtype == 1) {
    pair_level_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<__nv_bfloat16*>(tbl), f, p, n_pairs, base);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
