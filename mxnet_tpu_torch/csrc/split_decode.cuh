// The split-KV decode-attention body that K2 (decode_attention.cu, a
// dense cache) and K3 (paged_decode_attention.cu, a page pool) instance,
// each in an fp32, an int8, a bf16 and a float16 instance, and the Hopper
// primitives it is built from: mbarriers, 1D bulk copies
// (cp.async.bulk), mapa, st.async and the two halves of the cluster
// barrier.
//
// One cluster of S <= kMaxRanks blocks computes NR query rows of one
// (slot, head) against the slot's keys [0, len). Rank r owns the
// logical key rows [r * rows_per_rank, (r + 1) * rows_per_rank) cut at
// len; it passes them through shared memory at most batch_rows at a
// time. The instances differ only in where those rows come from and
// how an int8 row is scaled, which the row source ``Src`` answers:
//
//   int  length()                  the slot's length, clamped to the
//                                  cache (loaded first)
//   void prefetch(int warp, int lane)
//                                  loads that need no length, issued
//                                  beside it (K3: warp 0's table
//                                  entries; K2-int8: the slot's scales)
//   void issue(int bi, int rb, int nk, T* k_buf, T* v_buf,
//              float* sc_buf, unsigned bar, int lane)
//                                  warp 0: announce and issue the copies
//                                  of the rank's batch bi, key rows
//                                  [rb, rb + nk), into k_buf / v_buf row
//                                  0 onwards, all completing on ``bar``,
//                                  then arrive on it once. A source may
//                                  copy more rows than nk (K3 copies
//                                  whole pages) but never more than
//                                  batch_rows.
//   void scales(int j, const float* sc_buf, float& ks, float& vs)
//                                  int8: K and V scale of buffer row j
//
// and the launch gives the body ``rows_per_rank``, ``batch_rows`` and
// ``batch_rows * 2 * D * sizeof(T)`` bytes of dynamic shared memory
// plus what the source keeps after the rows (``sc_buf``).
//
// The arithmetic, the same for every instance:
// - Four warps each keep their own online softmax over 32-key chunks
//   (keys warp * 32 + lane, + 128, ...) of every batch, with no
//   block-wide barrier in the loop: a key a lane for the scores
//   (16-byte loads, columns rotated per lane so the lanes of a load
//   phase hit different bank groups), then P.V with each lane on 4
//   columns of every (32 / (D / 4))-th key (16-byte fp32, 8-byte bf16
//   or 4-byte int8 loads along a row, p by shuffle). int8 is widened in
//   registers by byte permutes; the K scale multiplies the score and
//   the V scale p, once per key. bf16 is widened by a shift and float16
//   by a conversion (cvt.f32.f16, two a word), with no scale: every
//   product and sum is fp32, so a 16-bit instance equals the fp32 one
//   on the widened cache.
// - q and the output: q is read as fp32, or (a 16-bit instance,
//   ``q_half``) in the cache's type and widened; a 16-bit instance
//   writes its output rounded to the cache's type, the others fp32.
// - Rows at or past the length never reach a sum: no score is computed
//   for them and no V row of them is read (skipped, not multiplied by
//   0: 0 x NaN is NaN), whether or not the source copied them.
// - A rank whose range starts at or past the length copies nothing and
//   leaves after one relaxed cluster arrive/wait, freeing its SM.
// - Merge in the cluster, in one launch: the warps' states merge in
//   shared memory, then each active rank sends (m, l, acc[NR][D]) to
//   its slot in rank 0's shared memory with st.async, which completes
//   its bytes on rank 0's merge mbarrier, so no rank waits on a
//   cluster-scope fence (under a burst of copies such a fence took
//   microseconds); rank 0 combines the slots in rank order and writes
//   the output. No second launch, no global scratch, no atomics:
//   deterministic. len == 0 gives zeros.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mxtt {

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxRanks = 8;
// shared memory a rank may hold for its K and V rows (two blocks fit an
// SM beside the static state)
constexpr int kBudget = 112 * 1024;
// Blocks an SM must hold, for the launch bounds, which caps a thread's
// registers at 65536 / (128 * n). Shared memory holds an fp32 instance
// to three blocks an SM at the engine's shapes (64 KB of rows each), so
// its registers are left free (no spills); an int8 instance's rows take
// a quarter of that, and five blocks an SM (at most 102 registers) timed
// best of 1, 5, 6 and 8 (scripts/torch_kernel_ab.py, PERF.md).
// A 16-bit instance's rows (bf16 or float16) take half an fp32 one's
// (32 KB at the engine's shapes), so its one-row instances take the int8
// rule; its four-row instances spilled under that cap (96 registers)
// and take four blocks (at most 128 registers).
template <class T, int NR>
constexpr int kSplitMinBlocks =
    sizeof(T) == 4 ? 1 : (sizeof(T) == 2 && NR > 1 ? 4 : 5);

// a 16-bit float cache: bf16 or float16, told apart by type, not size
template <class T>
constexpr bool kHalf = std::is_same_v<T, bf16> || std::is_same_v<T, f16>;

// the output's element type: the cache's for a bf16 or float16 cache
// (the attended V's type, as the reference's jnp path gives), fp32
// otherwise
template <class T>
using split_out_t = std::conditional_t<kHalf<T>, T, float>;

// q of one (slot, head) at element offset ``off``: fp32, or of the
// cache's type where ``q_half`` (a 16-bit instance only)
template <class T>
__device__ __forceinline__ const void* q_at(const void* q, bool q_half,
                                            long long off) {
  if constexpr (kHalf<T>) {
    if (q_half) return static_cast<const T*>(q) + off;
  }
  return static_cast<const float*>(q) + off;
}

// ---- 1D bulk copies (cp.async.bulk, sm_90); the mbarriers are common.cuh's
// the shared::cluster address of ``addr`` (a shared::cta address) in
// block ``rank`` of the cluster
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// Stores into another block's shared memory that complete their bytes
// on that block's mbarrier (st.async): the receiver sees them when the
// barrier's phase completes, and the sender needs no fence.
__device__ __forceinline__ void st_async(unsigned remote, float4 v,
                                         unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned remote, float v,
                                         unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(remote),
      "f"(v), "r"(remote_bar)
      : "memory");
}

// The cluster barrier in two halves. The relaxed arrival orders nothing
// but earlier mbarrier inits (with fence.mbarrier_init), so it does not
// wait for this thread's memory traffic.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- one K row against the NR query rows (rotated column order) --------
// Four int8 values packed in a 32-bit word, widened to fp32 exactly
// without the quarter-rate I2F: each byte, offset by 128, goes into the
// low mantissa bits of 2^23 (a byte permute), and 2^23 + 128 is
// subtracted.
__device__ __forceinline__ float4 s8x4_widen(unsigned w) {
  const unsigned u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7651)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7652)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7653)) - kBias);
}

// s[r] = q_s[r] . K row, in two interleaved partial sums (half the FMA
// chain)
template <int D, int NR>
__device__ __forceinline__ void score_row(const float* __restrict__ krow,
                                          const float (&q_s)[NR][D], int rot,
                                          float (&s)[NR]) {
  constexpr int C4 = D / 4;
  float t[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) t[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C4; c += 2) {
    const int c0 = (c + rot) & (C4 - 1);
    const int c1 = (c + 1 + rot) & (C4 - 1);
    const float4 k0 = *reinterpret_cast<const float4*>(krow + 4 * c0);
    const float4 k1 = *reinterpret_cast<const float4*>(krow + 4 * c1);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][4 * c0]), k0,
                  s[r]);
      t[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][4 * c1]), k1,
                  t[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r] += t[r];
}

template <int D, int NR>
__device__ __forceinline__ void score_row(const int8_t* __restrict__ krow,
                                          const float (&q_s)[NR][D], int rot,
                                          float (&s)[NR]) {
  static_assert(D % 16 == 0, "int8 K rows are read 16 bytes at a time");
  constexpr int C16 = D / 16;
  float t[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) t[r] = 0.f;
#pragma unroll
  for (int c = 0; c < C16; ++c) {
    const int cc = (c + rot) % C16;
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + 16 * cc);
    const float4 k4[4] = {s8x4_widen(raw.x), s8x4_widen(raw.y),
                          s8x4_widen(raw.z), s8x4_widen(raw.w)};
#pragma unroll
    for (int u = 0; u < 4; u += 2) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        s[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][16 * cc + 4 * u]),
                    k4[u], s[r]);
        t[r] = dot4(
            *reinterpret_cast<const float4*>(&q_s[r][16 * cc + 4 * u + 4]),
            k4[u + 1], t[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r] += t[r];
}

template <int D, int NR, class T,
          std::enable_if_t<kHalf<T>, int> = 0>
__device__ __forceinline__ void score_row(const T* __restrict__ krow,
                                          const float (&q_s)[NR][D], int rot,
                                          float (&s)[NR]) {
  static_assert(D % 8 == 0, "16-bit K rows are read 16 bytes at a time");
  constexpr int C8 = D / 8;
  float t[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) t[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C8; ++c) {
    const int cc = (c + rot) & (C8 - 1);
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + 8 * cc);
    const float4 k0 = half4_widen<T>(make_uint2(raw.x, raw.y));
    const float4 k1 = half4_widen<T>(make_uint2(raw.z, raw.w));
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][8 * cc]), k0,
                  s[r]);
      t[r] = dot4(*reinterpret_cast<const float4*>(&q_s[r][8 * cc + 4]), k1,
                  t[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r] += t[r];
}

// 4 consecutive elements of a V row, widened to fp32
__device__ __forceinline__ float4 load_v4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_v4(const int8_t* p) {
  return s8x4_widen(*reinterpret_cast<const unsigned*>(p));
}

template <class T, std::enable_if_t<kHalf<T>, int> = 0>
__device__ __forceinline__ float4 load_v4(const T* p) {
  return half4_widen<T>(*reinterpret_cast<const uint2*>(p));
}

// four consecutive query elements, fp32 or (``half``) of the 16-bit type
// T, widened
template <class T>
__device__ __forceinline__ float4 load_q4(const void* p, bool half) {
  return half ? half4_widen<T>(__ldg(reinterpret_cast<const uint2*>(p)))
              : load4(static_cast<const float*>(p));
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store_out(f16* p, float x) {
  *p = __float2half_rn(x);
}

// ---- the cluster body ----------------------------------------------------
// qb: this (slot, head)'s first query row, q_ss its row stride, both in
// elements of q's type (the cache's where ``q_half``, which only a
// 16-bit instance takes; fp32 otherwise); r0/nr: the cluster's first
// query row and its count (<= NR); ob: the output rows, contiguous
// (nr, D), split_out_t<T>. Launched with kSplitThreads threads a block
// in clusters along x.
template <int D, int NR, class T, class Src, class TO>
__device__ __forceinline__ void split_decode(Src& src,
                                             const void* __restrict__ qb,
                                             bool q_half, long long q_ss,
                                             int r0, int nr,
                                             int rows_per_rank, int batch_rows,
                                             float scale,
                                             TO* __restrict__ ob) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr bool k16 = kHalf<T>;
  constexpr int kThreads = kSplitThreads;
  constexpr int kWarps = kSplitWarps;
  constexpr int C4 = D / 4;    // 4-column groups of a row
  constexpr int LPR = C4;      // P.V: lanes on one V row, 4 columns each
  constexpr int KPI = 32 / LPR;   // P.V: keys a warp takes per step
  constexpr int kRot = kInt8 ? D / 16 : k16 ? D / 8 : C4;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  __shared__ __align__(16) float q_s[NR][D];
  // the warps' states, merged into the rank's
  __shared__ __align__(16) float wst_acc[kWarps][NR][D];
  __shared__ float wst_m[kWarps][NR], wst_l[kWarps][NR];
  // rank 0's: every active rank's state, pushed there
  __shared__ __align__(16) float mrg_acc[kMaxRanks][NR][D];
  __shared__ float mrg_m[kMaxRanks][NR], mrg_l[kMaxRanks][NR];
  __shared__ __align__(8) unsigned long long bar_s, mrg_bar_s;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_buf = reinterpret_cast<T*>(smem);
  T* v_buf = k_buf + (size_t)batch_rows * D;
  float* sc_buf = reinterpret_cast<float*>(v_buf + (size_t)batch_rows * D);
  const unsigned bar = smem_addr(&bar_s);
  const unsigned mrg_bar = smem_addr(&mrg_bar_s);
  if (tid == 0) {
    // the copies' barrier, and rank 0's merge barrier (one arrival, its
    // own, plus the bytes the other ranks store)
    mbar_init(bar, 1);
    if (rank == 0) mbar_init(mrg_bar, 1);
  }

  // Every load that needs no length goes out at once: the length, the
  // source's prefetch and q (the warps past the first). Arithmetic on
  // the length comes after them (n_active only in rank 0's merge): a
  // division placed ahead held the loads behind the length's latency.
  const int len = src.length();
  src.prefetch(warp, lane);
  if (warp > 0) {
    for (int i = tid - 32; i < NR * C4; i += kThreads - 32) {
      const int r = i / C4;
      const int c = (i - r * C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        const long long e = (long long)(r0 + r) * q_ss + c;
        if constexpr (k16)
          x = load_q4<T>(q_half ? static_cast<const void*>(
                                      static_cast<const T*>(qb) + e)
                                : static_cast<const void*>(
                                      static_cast<const float*>(qb) + e),
                         q_half);
        else
          x = load4(static_cast<const float*>(qb) + e);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
      *reinterpret_cast<float4*>(&q_s[r][c]) = x;
    }
  }
  const int row_begin = rank * rows_per_rank;
  const int row_end = min(row_begin + rows_per_rank, len);

  const bool active = row_begin < row_end;
  if (active && warp == 0)
    src.issue(0, row_begin, min(batch_rows, row_end - row_begin), k_buf,
              v_buf, sc_buf, bar, lane);
  __syncthreads();   // q is in shared memory
  // rank 0's merge barrier is initialised before any rank's wait
  // returns; a rank with no keys leaves after it
  cluster_arrive_relaxed();
  if (!active) {
    cluster_wait();
    if (rank != 0) return;
  }

  if (active) {
    // in P.V lane (g, c) sums columns 4c .. 4c + 3 over keys g, g + KPI,
    // ... of each 32-key chunk
    const int pv_g = lane / LPR;
    const int pv_c = (lane - pv_g * LPR) * 4;
    float m[NR], l[NR];
    float4 acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      m[r] = MXTT_NEG_INF;
      l[r] = 0.f;   // this lane's share of the denominator
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int bi = 0;; ++bi) {
      const int rb = row_begin + bi * batch_rows;
      if (rb >= row_end) break;
      const int nk = min(batch_rows, row_end - rb);   // keys of the batch
      if (bi > 0) {
        __syncthreads();   // every read of the previous batch is done
        if (warp == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          src.issue(bi, rb, nk, k_buf, v_buf, sc_buf, bar, lane);
        }
      }
      mbar_wait<false>(bar, bi & 1);
      for (int k0 = warp * 32; k0 < nk; k0 += kThreads) {
        const int j = k0 + lane;
        const bool valid = j < nk;   // rows at or past len: no score
        float s[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) s[r] = 0.f;
        float vs = 1.f;
        if (valid) {
          score_row<D, NR>(k_buf + (size_t)j * D, q_s, j % kRot, s);
          if constexpr (kInt8) {
            float ks;
            src.scales(j, sc_buf, ks, vs);
#pragma unroll
            for (int r = 0; r < NR; ++r) s[r] *= ks;
          }
        }
        float pv[NR];   // p, times the V scale of an int8 key
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float sv = valid ? s[r] : MXTT_NEG_INF;
          const float m_new = fmaxf(m[r], warp_max(sv));
          const float alpha = expf(m[r] - m_new);
          const float p = valid ? expf(sv - m_new) : 0.f;
          l[r] = fmaf(l[r], alpha, p);
          acc[r].x *= alpha;
          acc[r].y *= alpha;
          acc[r].z *= alpha;
          acc[r].w *= alpha;
          m[r] = m_new;
          pv[r] = p * vs;
        }
        // P.V over the chunk's keys before len only (nkc is
        // warp-uniform): their rows past len are never read
        const int nkc = min(32, nk - k0);
#pragma unroll 4
        for (int j0 = 0; j0 < nkc; j0 += KPI) {
          const int jj = j0 + pv_g;
          // a key past nkc: its lane's p is 0, and it reads the chunk's
          // first row (a row before len) instead of its own
          const float4 v =
              load_v4(v_buf + (size_t)(k0 + (jj < nkc ? jj : 0)) * D + pv_c);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float pj = __shfl_sync(kFullMask, pv[r], jj & 31);
            acc[r].x = fmaf(pj, v.x, acc[r].x);
            acc[r].y = fmaf(pj, v.y, acc[r].y);
            acc[r].z = fmaf(pj, v.z, acc[r].z);
            acc[r].w = fmaf(pj, v.w, acc[r].w);
          }
        }
      }
    }

    // merge the warps (a warp that saw no key has m = NEG_INF, l = 0,
    // acc = 0) into the rank's state, and send it to rank 0's slot
    // ``rank``: rank 0 writes its own, the others store theirs with
    // st.async, completing on rank 0's merge barrier
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float lt = warp_sum(l[r]);
      // the KPI key groups' sums of each column group
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1) {
        acc[r].x += __shfl_xor_sync(kFullMask, acc[r].x, o);
        acc[r].y += __shfl_xor_sync(kFullMask, acc[r].y, o);
        acc[r].z += __shfl_xor_sync(kFullMask, acc[r].z, o);
        acc[r].w += __shfl_xor_sync(kFullMask, acc[r].w, o);
      }
      if (lane == 0) {
        wst_m[warp][r] = m[r];
        wst_l[warp][r] = lt;
      }
      if (pv_g == 0)
        *reinterpret_cast<float4*>(&wst_acc[warp][r][pv_c]) = acc[r];
    }
    __syncthreads();
    cluster_wait();   // rank 0's merge barrier is initialised
    const unsigned mrg_bar0 = mapa(mrg_bar, 0);
    for (int i = tid; i < NR * C4; i += kThreads) {
      const int r = i / C4;
      const int d = (i - r * C4) * 4;
      float mx = MXTT_NEG_INF;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wst_m[w][r]);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float a = expf(wst_m[w][r] - mx);
        o.x = fmaf(wst_acc[w][r][d], a, o.x);
        o.y = fmaf(wst_acc[w][r][d + 1], a, o.y);
        o.z = fmaf(wst_acc[w][r][d + 2], a, o.z);
        o.w = fmaf(wst_acc[w][r][d + 3], a, o.w);
        lsum = fmaf(wst_l[w][r], a, lsum);
      }
      if (rank == 0) {
        *reinterpret_cast<float4*>(&mrg_acc[0][r][d]) = o;
        if (d == 0) {
          mrg_m[0][r] = mx;
          mrg_l[0][r] = lsum;
        }
      } else {
        st_async(mapa(smem_addr(&mrg_acc[rank][r][d]), 0), o, mrg_bar0);
        if (d == 0) {
          st_async(mapa(smem_addr(&mrg_m[rank][r]), 0), mx, mrg_bar0);
          st_async(mapa(smem_addr(&mrg_l[rank][r]), 0), lsum, mrg_bar0);
        }
      }
    }
  }

  if (rank == 0) {
    // the active ranks' states, combined in rank order, once the
    // others' stores have landed
    const int n_active = min(S, (len + rows_per_rank - 1) / rows_per_rank);
    if (tid == 0)
      mbar_arrive_expect_tx(
          mrg_bar, (unsigned)max(n_active - 1, 0) * (NR * D + 2 * NR) * 4);
    __syncthreads();   // rank 0's own state is in place
    mbar_wait<true>(mrg_bar, 0);
    if (warp == 0) {
      // lane k * NR + r holds rank k's row r; the reductions over k run
      // across lanes NR apart
      static_assert(kMaxRanks * NR <= 32, "one lane per (rank, row)");
      const int k = lane / NR;
      const int r = lane - k * NR;
      const bool on = k < n_active;
      float M = on ? mrg_m[k][r] : MXTT_NEG_INF;
#pragma unroll
      for (int o = 16; o >= NR; o >>= 1)
        M = fmaxf(M, __shfl_xor_sync(kFullMask, M, o));
      const float w = on ? expf(mrg_m[k][r] - M) : 0.f;
      float L = on ? mrg_l[k][r] * w : 0.f;
#pragma unroll
      for (int o = 16; o >= NR; o >>= 1)
        L += __shfl_xor_sync(kFullMask, L, o);
      if (on) mrg_m[k][r] = w;
      if (k == 0) wst_l[0][r] = L > 0.f ? 1.f / L : 0.f;   // len 0: zeros
    }
    __syncthreads();
    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      float o = 0.f;
      for (int k = 0; k < n_active; ++k)
        o = fmaf(mrg_acc[k][r][d], mrg_m[k][r], o);
      store_out(ob + i, o * wst_l[0][r]);
    }
  }
}

namespace {

// Launch ``Kernel`` over ``grid`` in clusters of ``ranks`` blocks along
// x, kSplitThreads threads a block, with ``smem`` bytes of dynamic
// shared memory. Above 48 KB only after raising the kernel's limit, once
// per kernel and card (a launch asks at most kBudget + 8 KB).
template <auto Kernel, class... Args>
cudaError_t launch_split(dim3 grid, int ranks, size_t smem,
                         cudaStream_t stream, Args... args) {
  static unsigned long long raised = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(raised >> dev & 1ull)) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBudget + 16 * 1024);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

}  // namespace mxtt
