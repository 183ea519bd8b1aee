// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel source is compiled on its own into a shared library
// with a plain C interface (nvcc -shared, loaded with ctypes by
// mxnet_tpu_torch/_build.py), so nothing here may define an
// exported symbol: header-only, inline, device-side.
#pragma once

#include <cuda_runtime.h>

// The reference's masked score (ops/attention.py NEG_INF): a large
// finite negative, never -inf, so that exp(s - m) stays 0 and
// m - m stays 0 for rows that see no key yet.
#define MXTT_NEG_INF (-1e30f)

namespace mxtt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Four int8 values packed in a 32-bit word, widened to fp32 (char4's
// members are signed char).
__device__ __forceinline__ float4 s8x4_to_float4(int w) {
  const char4 c = *reinterpret_cast<const char4*>(&w);
  return make_float4(c.x, c.y, c.z, c.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

}  // namespace mxtt
