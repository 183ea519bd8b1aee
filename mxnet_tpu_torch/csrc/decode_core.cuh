// The decode-attention block body of K2 (decode_attention.cu, a dense
// cache), in an fp32 and an int8 instance. K3 (paged_decode_attention.cu)
// ran it through a paged policy until its cluster split-KV redesign;
// the mentions of K3 below describe that policy.
//
// One thread block computes NR query rows of one (slot, head) against
// the slot's keys [0, len). Instances differ only in where key row t
// lives and how it is scaled, which the ``Rows`` policy answers:
// ``offsets(t, ko, vo, ks, vs)`` gives the element offsets of K row t
// from ``rows.k`` and of V row t from ``rows.v`` (a strided cache row
// for K2, a page looked up in the slot's page table for K3) and, for an
// int8 cache, the row's K and V scales; the type of ``rows.k`` /
// ``rows.v`` is the cache's element type (float or int8_t);
// ``kIndirect`` says whether the V loop takes each row's offset from
// its key's lane by shuffle instead of computing it in place;
// ``kKeyScales`` marks an int8 cache: each lane gets its key's two
// scales with its offsets (a page's for K3, the slot's for K2), the
// score is multiplied by the K scale and p by the V scale, which the V
// loop takes by shuffle beside the row offset.
//
// Everything else is the same arithmetic:
//
// - 8 warps split [0, len) into interleaved 32-key chunks, so 256 key
//   rows are in flight per block; each warp keeps an online-softmax
//   state and the states merge once, through shared memory, at the
//   end (the TPU kernel's sequential kv-block grid axis becomes this
//   loop).
// - No K or V row at or past ``len`` is ever loaded, and no scale of a
//   key at or past it is read, so garbage (even NaN) in a cache tail, a
//   scrap page, a recycled page or their scales cannot reach a sum —
//   the Hopper form of the TPU kernel's "skip blocks past ceil(len /
//   block)" and "zero the V overhang".
// - K rows are read with 16-byte loads, one row per lane (4 floats or
//   16 int8 values a load, widened to fp32 in registers); V rows are
//   read coalesced, one row per step across the warp, each lane owning
//   D / 32 output columns; p reaches the lanes by shuffle. Each lane
//   computes its key's row offsets once per chunk; with an indirect
//   policy (K3: one table load and one division; K2's int8 instance)
//   the V loop takes row j's offset from lane j by shuffle, so no step
//   waits on a table load, while K2's fp32 instance computes it in
//   place.
// - len == 0 writes zeros (an empty slot attends nothing).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mxtt {

constexpr int kDecodeWarps = 8;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeChunk = 32;   // keys per warp step: one per lane

// s[r] += q_s[r] . K row, for a row of D floats (16-byte loads).
template <int D, int NR>
__device__ __forceinline__ void dot_row(const float* __restrict__ krow,
                                        const float (&q_s)[NR][D],
                                        float (&s)[NR]) {
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float4 kx = load4(krow + c);
#pragma unroll
    for (int r = 0; r < NR; ++r)
      s[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][c]), kx, s[r]);
  }
}

// The same for a row of D int8 values: one 16-byte load per 16 values,
// widened to fp32 in registers (the caller applies the scale).
template <int D, int NR>
__device__ __forceinline__ void dot_row(const int8_t* __restrict__ krow,
                                        const float (&q_s)[NR][D],
                                        float (&s)[NR]) {
  static_assert(D % 16 == 0, "int8 K rows are read 16 bytes at a time");
#pragma unroll 2
  for (int c = 0; c < D; c += 16) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(krow + c));
    const float4 k4[4] = {s8x4_to_float4(raw.x), s8x4_to_float4(raw.y),
                          s8x4_to_float4(raw.z), s8x4_to_float4(raw.w)};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
        s[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][c + 4 * u]),
                    k4[u], s[r]);
    }
  }
}

__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_elem(const int8_t* p) {
  return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p)));
}

// qb: this (slot, head)'s first query row; q_ss its row stride. r0/nr:
// the block's first query row and its count (<= NR). ob: the output
// rows of this block, contiguous (nr, D).
template <int D, int NR, class Rows>
__device__ __forceinline__ void decode_block(const float* __restrict__ qb,
                                             long long q_ss, int r0, int nr,
                                             int len, float scale,
                                             const Rows& rows,
                                             float* __restrict__ ob) {
  constexpr bool kScaled = Rows::kKeyScales;
  static_assert(!kScaled || Rows::kIndirect,
                "per-key scales travel with the shuffled row offsets");
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output columns per lane
  constexpr int V4 = D / 4;
  __shared__ __align__(16) float q_s[NR][D];
  __shared__ float m_s[kDecodeWarps][NR];
  __shared__ float l_s[kDecodeWarps][NR];
  __shared__ float acc_s[kDecodeWarps][NR][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (len == 0) {
    for (int i = tid; i < nr * D; i += kDecodeThreads) ob[i] = 0.f;
    return;
  }

  for (int i = tid; i < NR * V4; i += kDecodeThreads) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr) {
      x = load4(qb + (long long)(r0 + r) * q_ss + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(&q_s[r][c]) = x;
  }
  __syncthreads();

  float m[NR], l[NR], acc[NR][DPL];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = MXTT_NEG_INF;
    l[r] = 0.f;   // this lane's share of the denominator
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = warp * kDecodeChunk; k0 < len;
       k0 += kDecodeWarps * kDecodeChunk) {
    const int key = k0 + lane;
    const bool valid = key < len;
    float s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] = 0.f;
    long long koff = 0, voff = 0;
    float ks = 1.f, vs = 1.f;   // this lane's key scales (int8 only)
    if (valid) {
      rows.offsets(key, koff, voff, ks, vs);
      dot_row<D, NR>(rows.k + koff, q_s, s);
      if constexpr (kScaled) {
#pragma unroll
        for (int r = 0; r < NR; ++r) s[r] *= ks;
      }
    }
    float p[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float sv = valid ? s[r] : MXTT_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      p[r] = valid ? expf(sv - m_new) : 0.f;   // re-mask
      l[r] = l[r] * alpha + p[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
    // P @ V over this chunk's valid rows only (nk is warp-uniform)
    const int nk = min(kDecodeChunk, len - k0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      long long vo;
      if constexpr (Rows::kIndirect) {
        vo = __shfl_sync(kFullMask, voff, j);
      } else {
        long long ko_unused;
        float ks_unused, vs_unused;
        rows.offsets(k0 + j, ko_unused, vo, ks_unused, vs_unused);
      }
      float vsj = 1.f;
      if constexpr (kScaled) vsj = __shfl_sync(kFullMask, vs, j);
      const auto* vrow = rows.v + vo;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? load_elem(vrow + d) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float pj = __shfl_sync(kFullMask, p[r], j);
        if constexpr (kScaled) pj *= vsj;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  // merge the warps' partial states: out = sum_w acc_w e^(m_w - M) /
  // sum_w l_w e^(m_w - M); a warp that saw no key has l = 0, acc = 0
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float lt = warp_sum(l[r]);
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = lt;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc_s[warp][r][d] = acc[r][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += kDecodeThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float mx = MXTT_NEG_INF;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float a = expf(m_s[w][r] - mx);
      lsum = fmaf(l_s[w][r], a, lsum);
      o = fmaf(acc_s[w][r][d], a, o);
    }
    const float l_safe = lsum > 0.f ? lsum : 1.f;
    ob[r * D + d] = o / l_safe;
  }
}

}  // namespace mxtt
