// Device helpers shared by the port's attention kernels (K1, K2, K5, K6).
//
// "round" below is a cast to the I/O type T and back to f32 (a no-op in
// f32): the points where the Pallas kernels round to the array's dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oetr {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float round_t(float v);
template <>
__device__ __forceinline__ float round_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// elu(x) + 1 in f32, as the Pallas kernels compute it (exp, not expm1).
__device__ __forceinline__ float elu_p1(float x) {
  return x > 0.f ? x + 1.f : expf(x);
}

// Four consecutive f32. p must be 16-byte aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace oetr
