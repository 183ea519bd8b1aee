// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel source is compiled on its own into a shared library
// with a plain C interface (nvcc -shared, loaded with ctypes by
// mxnet_tpu_torch/_build.py), so nothing here may define an
// exported symbol: header-only, inline, device-side.
#pragma once

#include <cuda_bf16.h>
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

// ---- bf16 ---------------------------------------------------------------
// A bf16 value is the top half of an fp32 one, so widening it is a
// shift (or a mask) and exact; two bf16 values packed in a 32-bit word
// (the lower address in the low half) widen to lo and hi.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// four consecutive bf16 values (8 bytes, 8-byte aligned), widened
__device__ __forceinline__ float4 bf16x4_widen(uint2 w) {
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}

// fp32 -> bf16 bits, rounded to nearest even (torch's .to(bfloat16))
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// ---- TF32 tensor cores (mma.sync m16n8k8) ------------------------------
// Fragments of one warp, lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// The k index of A and B is summed over, so a kernel may map it to any
// permutation of its keys or features, as long as A and B agree.

// fp32 -> tf32 as cvt.rna.tf32.f32 rounds (10 mantissa bits, to nearest,
// ties away from zero), done on the bit pattern: add half a TF32 ulp to
// the magnitude bits and clear the low 13 (two integer instructions;
// ptxas expands cvt.rna into a compare-and-select sequence several
// times as long, and the split sits in the inner loops). For finite x
// the bits equal cvt.rna's, and they are also the fp32 value of the
// rounded number. A NaN may come out as a number: split_tf32 carries
// it in the small part.
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split: x = big + small. big is x rounded to TF32; small =
// x - big is exact in fp32 (at most 13 significant bits) and goes to
// the tensor core as it is: the core reads the top 19 bits of a TF32
// operand, so small keeps its leading 11 bits, and big + small is x to
// about 2^-22 relative. A non-finite x gives a NaN small, so it
// propagates through the product.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a * b on the tensor cores, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the two small cross terms first, then the big
// product (small * small, ~2^-22 relative, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4],
                                           const unsigned (&b_big)[2],
                                           const unsigned (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// ---- cp.async (global -> shared, 16 bytes, bypassing L1) ----------------
// With ``fill`` false the 16 shared bytes are zeroed and nothing is read
// from ``gmem`` (source size 0), which must still be a valid address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mxtt
