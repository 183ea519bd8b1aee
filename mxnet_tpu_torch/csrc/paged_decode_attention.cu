// K3 — decode attention over a PAGED KV cache, fp32 or int8, for Hopper
// (sm_90a): a split-KV (flash-decoding) kernel in one launch, each
// (slot, head, group of query rows) split across a thread-block cluster.
//
// Replaces: mxnet_tpu/ops/attention.py paged_decode_attention_pallas
// (kernel body _paged_decode_fwd_kernel -> _decode_fwd_kernel), both
// variants: an fp32 pool, and an int8 pool with (n_pages, H) fp32
// scales. Same function: every query row of slot b attends the slot's
// keys [0, lengths[b]), where logical key t lives in pool page
// table[b, t / ps] at row t % ps (dequantized with that page's per-head
// scales in the int8 instance); lengths[b] == 0 gives zeros. It equals
// decode attention over the gathered (and dequantized) view
// (gather_pages, expand_page_scales), which is the plain version it is
// held to.
//
// What bounds it on the H100: bytes. Each valid page's K and V rows of
// one head are read once, 2 * sum(len) * H * D * 4 bytes per layer in
// fp32 (a quarter of that in int8), plus q, the table and the output,
// at one to four FLOP per byte; at 8 slots x 12 heads x lengths up to
// 1024 that is 16 MB, 4.8 us at 3.35 TB/s.
//
// What the design does about it. The earlier kernel ran one block per
// (slot, head): 96 blocks on 132 SMs, a few hundred bytes in flight per
// warp, and two dependent loads, a table entry and then the row, before
// any K byte. Here:
// - Split-KV across a cluster. The launch sizes a cluster of S <= 8
//   blocks from P_max (plan()): each rank owns ceil(P_max / S) logical
//   pages (8 pages, 128 keys, at the engine's P_max = 64). A long slot
//   is read by S SMs; a rank whose range starts at or past the slot's
//   length copies nothing and leaves after the cluster's first barrier,
//   freeing its SM for the next clusters.
// - One memory latency before the copies. The length, warp 0's table
//   entries for the rank's pages (read whatever the length: the table
//   row is valid memory) and q all go out at once. Then warp 0 issues
//   every page of the rank at once, one lane a page: its entry (clamped
//   to [0, n_pages)), in the int8 instance its page's two scales (once
//   per page, loaded ahead of the copies so they do not queue behind
//   them), and the page's K and V copies into shared memory with
//   cp.async.bulk (the TMA's 1D form: one instruction per head page of
//   ps x D contiguous elements, 4 KB fp32 or 1 KB int8 at 16 x 64), all
//   completing on one mbarrier; 64 KB in flight per rank at the
//   engine's fp32 shapes.
// - Shared memory feeds the arithmetic, with no block-wide barrier in
//   the loop: each warp keeps its own online-softmax state over 32-key
//   chunks, a key a lane for the scores (16-byte loads, columns rotated
//   per lane so the lanes of a load phase hit different bank groups),
//   then P.V with each lane on 4 columns of every (32 / (D / 4))-th key
//   (16-byte fp32 or 4-byte int8 loads along a row, p by shuffle).
//   int8 is widened in registers by byte permutes; the K scale
//   multiplies the score and the V scale p, once per key, from the
//   page's entry in shared memory.
// - Rows past the length never reach a sum: the last valid page
//   arrives whole, so its rows at or past len (garbage, even NaN) are
//   in shared memory, but no score is computed for them and no V row of
//   them is read (skipped, not multiplied by 0: 0 x NaN is NaN). Pages
//   at or past ceil(len / ps) are never copied and their scales never
//   read; the scrap page 0 is never touched through them.
// - Merge in the cluster, in one launch: the warps' states merge in
//   shared memory, then each active rank sends (m, l, acc[NR][D]) to
//   its slot in rank 0's shared memory with st.async, which completes
//   its bytes on rank 0's merge mbarrier, so no rank waits on a
//   cluster-scope fence (under a burst of copies such a fence took
//   microseconds); rank 0 combines the slots in rank order and writes
//   the output. No second launch, no global scratch, no atomics:
//   deterministic.
// - A rank holds at most kBudget bytes of pages; a longer range runs in
//   batches through the same buffers (the warps' online softmax runs on
//   across batches), and a page too large for the budget is copied in
//   parts of ps / parts rows. At the engine's shapes one batch holds all.
// - 2..R query rows run four rows per cluster (the pages are read once
//   for the four); the peek (prefix hits) is the same kernel at B = 1.
// - A corrupt table entry reads a wrong page instead of faulting the
//   card. An inactive engine row's table may alias pages another slot
//   owns; the kernel only reads them and the engine ignores that row's
//   logits.
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRanks = 8;
// shared memory a rank may hold for its pages' K and V rows (two blocks
// fit an SM beside the static state)
constexpr int kBudget = 112 * 1024;

// ---- mbarrier and 1D bulk copies (cp.async.bulk, sm_90) -----------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
      s[r] = mxtt::dot4(*reinterpret_cast<const float4*>(&q_s[r][4 * c0]),
                        k0, s[r]);
      t[r] = mxtt::dot4(*reinterpret_cast<const float4*>(&q_s[r][4 * c1]),
                        k1, t[r]);
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
        s[r] = mxtt::dot4(
            *reinterpret_cast<const float4*>(&q_s[r][16 * cc + 4 * u]), k4[u],
            s[r]);
        t[r] = mxtt::dot4(
            *reinterpret_cast<const float4*>(&q_s[r][16 * cc + 4 * u + 4]),
            k4[u + 1], t[r]);
      }
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

// How a launch splits the pages: a cluster of S ranks, each owning
// ``upr`` units of ps / parts rows (a unit is a whole page unless a page
// exceeds the budget), at most ``batch`` units in shared memory at once.
struct Plan {
  int S, parts, upr, batch;
  size_t smem;
};

Plan plan(int P_max, int ps, int D, int elem, int NR) {
  Plan p;
  const int ppr = (P_max + kMaxRanks - 1) / kMaxRanks;   // pages per rank
  p.S = (P_max + ppr - 1) / ppr;
  const int row_bytes = 2 * D * elem;   // K and V of one key
  // a unit's K and V (unit * D * elem is a multiple of 16) and its two
  // scales fit the budget
  p.parts = 1;
  while ((ps / p.parts) * row_bytes + 8 > kBudget || ps % p.parts) ++p.parts;
  const int unit = ps / p.parts;
  p.upr = ppr * p.parts;
  p.batch = std::min(p.upr, kBudget / (unit * row_bytes + 8));
  p.smem = (size_t)p.batch * (unit * row_bytes + 8);
  return p;
}

template <int D, int NR, class T>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int H, int Sq, int ps, int P_max, int n_pages, int parts,
                   int upr, int batch, float scale, long long q_sb,
                   long long q_sh, long long q_ss) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int C4 = D / 4;    // 4-column groups of a row
  constexpr int LPR = C4;      // P.V: lanes on one V row, 4 columns each
  constexpr int KPI = 32 / LPR;   // P.V: keys a warp takes per step
  constexpr int kRot = kInt8 ? D / 16 : C4;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / S;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const int nr = min(NR, Sq - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int unit = ps / parts;   // rows per unit
  const int u_begin = rank * upr;

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
  T* v_buf = k_buf + (size_t)batch * unit * D;
  float* ks_buf = reinterpret_cast<float*>(v_buf + (size_t)batch * unit * D);
  float* vs_buf = ks_buf + batch;
  const unsigned bar = smem_addr(&bar_s);
  const unsigned mrg_bar = smem_addr(&mrg_bar_s);
  if (tid == 0) {
    // the copies' barrier, and rank 0's merge barrier (one arrival, its
    // own, plus the bytes the other ranks store)
    mbar_init(bar, 1);
    if (rank == 0) mbar_init(mrg_bar, 1);
  }

  // Every load that needs no length goes out at once: the length, warp
  // 0's table entries for the rank's first units (the table row is
  // valid memory whatever the length) and q (the other warps).
  const int len = max(0, min(__ldg(lengths + b), P_max * ps));
  int pg_first = 0;
  if (warp == 0 && lane < min(upr, batch) &&
      (u_begin + lane) / parts < P_max)
    pg_first = __ldg(table + (long long)b * P_max + (u_begin + lane) / parts);
  if (warp > 0) {
    for (int i = tid - 32; i < NR * C4; i += kThreads - 32) {
      const int r = i / C4;
      const int c = (i - r * C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        x = mxtt::load4(q + b * q_sb + h * q_sh + (long long)(r0 + r) * q_ss +
                        c);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
      *reinterpret_cast<float4*>(&q_s[r][c]) = x;
    }
  }
  const int n_units = (len + unit - 1) / unit;   // units holding keys
  const int u_end = min(u_begin + upr, n_units);
  const int n_active = min(S, (n_units + upr - 1) / upr);
  const long long page_stride = (long long)H * ps * D;
  const unsigned unit_bytes = (unsigned)(unit * D * sizeof(T));

  // warp 0: one unit a lane (its table entry, its page's scales, loaded
  // ahead of its two copies so that they do not queue behind them), then
  // the batch's one arrival
  auto issue = [&](int ub, bool first) {
    const int nu = min(batch, u_end - ub);
    if (lane == 0) mbar_expect_tx(bar, 2u * nu * unit_bytes);
    __syncwarp();
    for (int i = lane; i < nu; i += 32) {
      const int u = ub + i;
      const int lp = u / parts;
      const int raw = first && i == lane
                          ? pg_first
                          : __ldg(table + (long long)b * P_max + lp);
      const int pg = min(max(raw, 0), n_pages - 1);
      float ks = 0.f, vs = 0.f;
      if constexpr (kInt8) {
        ks = __ldg(k_scale + (long long)pg * H + h);
        vs = __ldg(v_scale + (long long)pg * H + h);
      }
      const long long off = (long long)pg * page_stride +
                            (long long)h * ps * D +
                            (long long)(u - lp * parts) * unit * D;
      bulk_copy(k_buf + (size_t)i * unit * D, k_pool + off, unit_bytes, bar);
      bulk_copy(v_buf + (size_t)i * unit * D, v_pool + off, unit_bytes, bar);
      if constexpr (kInt8) {
        ks_buf[i] = ks;
        vs_buf[i] = vs;
      }
    }
    __syncwarp();   // the scales are stored before the arrival releases
    if (lane == 0) mbar_arrive(bar);
  };

  const bool active = u_begin < u_end;
  if (active && warp == 0) issue(u_begin, true);
  __syncthreads();   // q is in shared memory
  // rank 0's merge barrier is initialised before any rank's wait
  // returns; a rank with no keys leaves after it
  cluster_arrive_relaxed();
  if (!active) {
    cluster_wait();
    if (rank != 0) return;
  }

  if (active) {
    // each warp keeps an online-softmax state over 32-key chunks
    // (keys warp * 32 + lane, + 128, ...) of every batch; in P.V lane
    // (g, c) sums columns 4c .. 4c + 3 over keys g, g + KPI, ...
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
    unsigned phase = 0;
    for (int ub = u_begin; ub < u_end; ub += batch) {
      if (ub != u_begin) {
        __syncthreads();   // every read of the previous batch is done
        if (warp == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(ub, false);
        }
      }
      mbar_wait<false>(bar, phase);
      phase ^= 1;
      const int nk = min(min(batch, u_end - ub) * unit, len - ub * unit);
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
            const float ks = ks_buf[j / unit];
            vs = vs_buf[j / unit];
#pragma unroll
            for (int r = 0; r < NR; ++r) s[r] *= ks;
          }
        }
        float pv[NR];   // p, times the V scale of an int8 key
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float sv = valid ? s[r] : MXTT_NEG_INF;
          const float m_new = fmaxf(m[r], mxtt::warp_max(sv));
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
            const float pj = __shfl_sync(mxtt::kFullMask, pv[r], jj & 31);
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
      const float lt = mxtt::warp_sum(l[r]);
      // the KPI key groups' sums of each column group
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1) {
        acc[r].x += __shfl_xor_sync(mxtt::kFullMask, acc[r].x, o);
        acc[r].y += __shfl_xor_sync(mxtt::kFullMask, acc[r].y, o);
        acc[r].z += __shfl_xor_sync(mxtt::kFullMask, acc[r].z, o);
        acc[r].w += __shfl_xor_sync(mxtt::kFullMask, acc[r].w, o);
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
        M = fmaxf(M, __shfl_xor_sync(mxtt::kFullMask, M, o));
      const float w = on ? expf(mrg_m[k][r] - M) : 0.f;
      float L = on ? mrg_l[k][r] * w : 0.f;
#pragma unroll
      for (int o = 16; o >= NR; o >>= 1)
        L += __shfl_xor_sync(mxtt::kFullMask, L, o);
      if (on) mrg_m[k][r] = w;
      if (k == 0) wst_l[0][r] = L > 0.f ? 1.f / L : 0.f;   // len 0: zeros
    }
    __syncthreads();
    float* ob = out + (((long long)b * H + h) * Sq + r0) * D;
    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      float o = 0.f;
      for (int k = 0; k < n_active; ++k)
        o = fmaf(mrg_acc[k][r][d], mrg_m[k][r], o);
      ob[i] = o * wst_l[0][r];
    }
  }
}

template <int D, int NR, class T>
cudaError_t launch_rows(const float* q, const T* k_pool, const T* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* table, const int* lengths, float* out,
                        int B, int H, int Sq, int ps, int P_max, int n_pages,
                        float scale, const long long* st,
                        cudaStream_t stream) {
  const Plan p = plan(P_max, ps, D, (int)sizeof(T), NR);
  auto kernel = paged_split_kernel<D, NR, T>;
  // above 48 KB only after raising the kernel's limit, once per
  // instance and card (the plan asks at most kBudget + 8 KB)
  static unsigned long long raised = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(raised >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBudget + 16 * 1024);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H * p.S, B, (Sq + NR - 1) / NR);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, q, k_pool, v_pool, k_scale, v_scale, table, lengths, out,
      H, Sq, ps, P_max, n_pages, p.parts, p.upr, p.batch, scale, st[0], st[1],
      st[2]);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D, class T>
cudaError_t launch(const float* q, const T* k_pool, const T* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* lengths, float* out, int B,
                   int H, int Sq, int ps, int P_max, int n_pages, float scale,
                   const long long* st, cudaStream_t stream) {
  if (Sq == 1)
    return launch_rows<D, 1, T>(q, k_pool, v_pool, k_scale, v_scale, table,
                                lengths, out, B, H, Sq, ps, P_max, n_pages,
                                scale, st, stream);
  return launch_rows<D, 4, T>(q, k_pool, v_pool, k_scale, v_scale, table,
                              lengths, out, B, H, Sq, ps, P_max, n_pages,
                              scale, st, stream);
}

template <class T>
int dispatch(const float* q, const T* k_pool, const T* v_pool,
             const float* k_scale, const float* v_scale, const int* table,
             const int* lengths, float* out, int B, int H, int Sq, int D,
             int ps, int P_max, int n_pages, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (ps < 1 || P_max < 1 || n_pages < 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                        out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    case 32:
      return launch<32>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                        out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    case 64:
      return launch<64>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                        out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    case 128:
      return launch<128>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                         out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D) fp32 with a contiguous last axis; ``strides`` holds
// its (b, h, s) element strides. k_pool / v_pool: contiguous
// (n_pages, H, ps, D) fp32, 16-byte aligned. table: contiguous
// (B, P_max) int32; lengths: (B,) int32; both on the device. out:
// (B, H, Sq, D) contiguous fp32. Returns the launch's cudaError_t.
int mxtt_paged_decode_attention(const float* q, const float* k_pool,
                                const float* v_pool, const int* table,
                                const int* lengths, float* out, int B, int H,
                                int Sq, int D, int ps, int P_max, int n_pages,
                                float scale, const long long* strides,
                                void* stream) {
  return dispatch<float>(q, k_pool, v_pool, nullptr, nullptr, table, lengths,
                         out, B, H, Sq, D, ps, P_max, n_pages, scale, strides,
                         stream);
}

// The int8 instance: k_pool / v_pool are contiguous (n_pages, H, ps, D)
// int8, 16-byte aligned; k_scale / v_scale contiguous (n_pages, H) fp32
// on the device. The rest as above.
int mxtt_paged_decode_attention_int8(
    const float* q, const int8_t* k_pool, const int8_t* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, float* out, int B, int H, int Sq, int D, int ps,
    int P_max, int n_pages, float scale, const long long* strides,
    void* stream) {
  return dispatch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                          out, B, H, Sq, D, ps, P_max, n_pages, scale, strides,
                          stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
