// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel source is compiled on its own into a shared library
// with a plain C interface (nvcc -shared, loaded with ctypes by
// mxnet_tpu_torch/_build.py), so nothing here may define an
// exported symbol: header-only, inline or internal.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// 2^x on the SFU alone (ex2.approx.ftz: about 2 ulp; a result below
// 2^-126 flushes to 0, which no sum of terms near 1 can see). exp2f adds
// the instructions that keep such results subnormal.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// ---- float16 --------------------------------------------------------------
// A float16 value is not a truncated fp32 one (5 exponent bits, 10
// mantissa bits), so it widens by a conversion (cvt.f32.f16, exact).
using f16 = __half;

__device__ __forceinline__ float2 f16x2_widen(unsigned w) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// four consecutive float16 values (8 bytes, 8-byte aligned), widened
__device__ __forceinline__ float4 f16x4_widen(uint2 w) {
  const float2 lo = f16x2_widen(w.x), hi = f16x2_widen(w.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four consecutive values of a 16-bit type (bf16 or float16), widened
template <class T>
__device__ __forceinline__ float4 half4_widen(uint2 w) {
  static_assert(std::is_same_v<T, bf16> || std::is_same_v<T, f16>,
                "a 16-bit float type");
  if constexpr (std::is_same_v<T, bf16>)
    return bf16x4_widen(w);
  else
    return f16x4_widen(w);
}

// fp32 -> 16-bit bits of type T, rounded to nearest even
template <class T>
__device__ __forceinline__ unsigned half_bits(float x) {
  if constexpr (std::is_same_v<T, bf16>)
    return bf16_bits(x);
  else
    return __half_as_ushort(__float2half_rn(x));
}

template <class T>
__device__ __forceinline__ unsigned half_pack(float lo, float hi) {
  return half_bits<T>(lo) | (half_bits<T>(hi) << 16);
}

// x0, x1 split as hi + lo in the 16-bit type T, each pair packed as a
// wgmma A fragment register (x0 in the low half): hi = T(x), lo =
// T(x - hi)
template <class T>
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  if constexpr (std::is_same_v<T, bf16>) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const unsigned*>(&h);
    lo = bf16_pack(x0 - hf.x, x1 - hf.y);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    hi = *reinterpret_cast<const unsigned*>(&h);
    lo = half_pack<T>(x0 - hf.x, x1 - hf.y);
  }
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


// ---- mbarriers (sm_90) ----------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Make this thread's earlier mbarrier inits visible to the block and to
// the async proxy (TMA, bulk copies): once after a thread's inits (the
// fence costs hundreds of cycles).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ``fence`` false leaves the fence to one mbar_init_fence after several
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count,
                                          bool fence = true) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  if (fence) mbar_init_fence();
}

// announce ``bytes`` of copies completing on the barrier's current phase
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, announcing ``bytes`` of transfers completing on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase ``phase`` to complete; kCluster acquires
// at cluster scope (arrivals from other blocks). A phase that never
// completes faults the launch (after ~2^34 cycles, about 9 s) instead
// of hanging the card.
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    if constexpr (kCluster) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(phase)
          : "memory");
    } else {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(phase)
          : "memory");
    }
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA tile loads (cp.async.bulk.tensor, sm_90) -------------------------
// One box of a 4-d tensor map (``map``: the generic address of a
// __grid_constant__ CUtensorMap) at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory at ``dst``, completing its bytes
// on ``bar``. Elements outside the map's extents arrive as zeros and
// are not read; the box's full size still counts.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// One box of a 1-d tensor map at coordinate c0 (see tma_load_4d).
__device__ __forceinline__ void tma_load_1d(void* dst, const void* map,
                                            int c0, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(bar)
      : "memory");
}

// Fetch a tensor map (the generic address of a __grid_constant__
// CUtensorMap) into the descriptor cache ahead of its first copy.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// ---- warpgroup products (wgmma, sm_90a) -----------------------------------
// A shared-memory operand descriptor: the tile's address, the leading and
// stride byte offsets and the swizzle of the layout TMA wrote (kSwizzle
// 128, 64 or 32 bytes). K-major (rows of the contracted axis contiguous):
// SBO steps between 8-row groups, LBO is unused. MN-major (the transpose
// bit): SBO steps between 8-row groups along the contracted axis, LBO
// between swizzle-wide column blocks.
template <int kSwizzle>
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's committed products are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it (after wgmma_wait).
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Fragments, lane = 4 g + t of warp w of the warpgroup: accumulator entry
// d[4 i + e] is row 16 w + g + 8 (e / 2), column 8 i + 2 t + (e % 2); a
// register A fragment of k step j holds rows 16 w + g (a[0], a[2]) and
// + 8 (a[1], a[3]), columns 16 j + 2 t, + 1 (a[0], a[1]) and + 8 (a[2],
// a[3]), two 16-bit values a register (the lower column in the low
// half): the accumulator's entries 8 j .. 8 j + 7, rounded and packed in
// order. The products take bf16 or float16 operands (``T``), fp32
// accumulation; the element type is part of the instruction, so each
// wrapper holds one asm statement a type.
#define MXTT_WGMMA_SS_N64(TY)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                          \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31])                                           \
      : "l"(a), "l"(b), "r"(acc))

#define MXTT_WGMMA_RS_N16(TY)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                 \
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

#define MXTT_WGMMA_RS_N32(TY)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                            \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15])                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

#define MXTT_WGMMA_RS_N64(TY)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                          \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31])                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d (64 x 64, fp32) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major), both T through smem descriptors; ``acc`` false overwrites d
template <class T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  if constexpr (std::is_same_v<T, bf16>)
    MXTT_WGMMA_SS_N64("bf16");
  else
    MXTT_WGMMA_SS_N64("f16");
}

// d (64 x 16, fp32) += A (64 x 16, T fragments in registers) * B (16 x
// 16, shared, MN-major: the transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  if constexpr (std::is_same_v<T, bf16>)
    MXTT_WGMMA_RS_N16("bf16");
  else
    MXTT_WGMMA_RS_N16("f16");
}

// d (64 x 32, fp32) += A (64 x 16, T fragments in registers) * B (16 x
// 32, shared, MN-major: the transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  if constexpr (std::is_same_v<T, bf16>)
    MXTT_WGMMA_RS_N32("bf16");
  else
    MXTT_WGMMA_RS_N32("f16");
}

// d (64 x 64, fp32) += A (64 x 16, T fragments in registers) * B (16 x
// 64, shared, MN-major: the transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  if constexpr (std::is_same_v<T, bf16>)
    MXTT_WGMMA_RS_N64("bf16");
  else
    MXTT_WGMMA_RS_N64("f16");
}

#undef MXTT_WGMMA_SS_N64
#undef MXTT_WGMMA_RS_N16
#undef MXTT_WGMMA_RS_N32
#undef MXTT_WGMMA_RS_N64

// d (64 x N, fp32) += A (registers) * B (shared, MN-major), N = 64, 32
// or 16
template <int N, class T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const unsigned (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 64)
    wgmma_rs_n64<T>(d, a, b);
  else if constexpr (N == 32)
    wgmma_rs_n32<T>(d, a, b);
  else
    wgmma_rs_n16<T>(d, a, b);
}

namespace {

// Per-device caches of the host-side launch helpers hold this many
// devices; a device past it is served uncached.
constexpr int kMaxDevices = 64;

// The dynamic shared-memory limit of a kernel instance, raised once per
// device.
template <auto kKernel, size_t kBytes>
cudaError_t raise_smem_limit(int dev) {
  static int raised[kMaxDevices] = {};   // 0: not yet, 1: done
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = 1;
  return err;
}

// cuTensorMapEncodeTiled, found through the runtime (nothing links
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (!found) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// The tensor map of a (B, H, rows, D) bf16 or float16 (T) view with
// (b, h, s) element strides ``st``, over its first ``rows`` rows: boxes
// of kSwizzle / 2 head dims x 64 rows in a kSwizzle-byte swizzle (128,
// 64 or 32), the layout wgmma reads; elements outside it read as zeros.
// An axis of extent 1 gets a stride of one row (its coordinate is
// always 0).
template <class T, int kSwizzle>
cudaError_t tensor_map_rows(CUtensorMap* map, const void* base, int D, int B,
                            int H, int rows, const long long* st) {
  static_assert(sizeof(T) == 2, "a 16-bit element type");
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)H, (cuuint64_t)B};
  const long long el[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)el[i] * 2 : (cuuint64_t)D * 2;
  const cuuint32_t box[4] = {(cuuint32_t)kSwizzle / 2, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      kSwizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map,
      std::is_same_v<T, bf16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

}  // namespace mxtt
