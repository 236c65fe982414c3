// Device helpers shared by the port's gather kernels (hyb_spmm.cu,
// edge_spmm.cu): conversions, the product rule of each table dtype, and a
// warp-wide sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dorylus {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The value a float takes in dtype T, back as a float: what
// `val.astype(table.dtype)` gives in the JAX package.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// w * x formed in the table's dtype. Both factors hold values of T, so in
// bf16 the f32 product is exact and rounding it gives the bf16 product.
template <typename T>
__device__ __forceinline__ float product(float w, float x) {
  return round_to<T>(w * x);
}

// Sum over the warp's 32 lanes; every lane gets the same value, in the
// same order on every run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

}  // namespace dorylus
