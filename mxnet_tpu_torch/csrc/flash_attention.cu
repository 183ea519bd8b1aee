// K1 — flash attention forward (fp32 and bf16) for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py flash_attention_pallas
// (kernel body _flash_fwd_kernel). Same function: blockwise
// online-softmax attention over (B, H, S, D), causal or not, keys at or
// past kv_len masked, the causal diagonal end-aligned at
// offset = kv_len - Sq, fp32 running max / denominator / numerator,
// the masked score -1e30 with p re-masked to 0 after the exp, the
// l_safe guard, and outputs (out, lse).
//
// What bounds it on the H100: operations. The two products do 4 * D
// FLOP per (query, visible key) pair against 16 * D bytes per row of q,
// k, v and out, so the work per byte grows with the sequence. The
// inputs and the contract are fp32 (2e-5 on the output). Single TF32
// keeps 10 mantissa bits and misses that; the 3xTF32 split
// (x = big + small, big * big + big * small + small * big, common.cuh)
// keeps about 21 and runs on the TF32 tensor cores: its bound is
// 3 x FLOP at 495 TFLOP/s, 2.5x below the 67 TFLOP/s fp32 cores'.
// This kernel replaces one that ran both products on the CUDA cores,
// one warp per 8 rows, with each K/V tile loaded and then used behind
// two barriers.
//
// What the design does about it:
// - Both products on the tensor cores as mma.sync m16n8k8 TF32 in
//   3xTF32. A block owns 32 query rows: 2 row warps of 16 rows (the
//   mma's m) times G key groups; group i takes the K/V tiles i, i + G,
//   i + 2G.. of the block's range, so the chain of tiles a warp walks
//   is 1/G of the range, and the partial softmax states (m, l, o) meet
//   in shared memory at the end. The prefill shape (1, 12, 512, 64)
//   gives 192 blocks for the 132 SMs: while the grid fits in one wave
//   of two blocks per SM, the launch takes G = 4 on 16-key tiles (the
//   work per block sets the time), else G = 2 on 32-key tiles (less
//   work per key; the 1024-token context's 384 blocks).
// - The mma's k index is summed over, so each product maps it to the
//   layout that lets a lane load with the widest shared-memory reads:
//   * S = Q K^T: over a pair of k steps lane (g, t) takes head dims
//     16 c + 4 t .. + 3 of its rows (A: Q) and of key g (B: K), one
//     16-byte load each. Rows are padded to D + 16 floats (48 at
//     D = 16), so the 8 lanes of a quarter warp hit 8 distinct 16-byte
//     bank groups. Q is scaled, split and kept in registers as A
//     fragments (D <= 64; at D = 128 it is re-read from shared memory,
//     which keeps the kernel out of spills).
//   * O += P V: the accumulator of S holds, in lane (g, t), keys 2t and
//     2t + 1 of each 8-key slice, so A's column t is key 2t and column
//     t + 4 key 2t + 1: the S accumulator IS P's A fragment (no shared
//     memory, no shuffle). B's column g of the 4 n tiles 4c .. 4c + 3 is
//     head dim 32 c + 4 g + r, one 16-byte load of V row 2t (and 2t + 1)
//     per 4 n tiles (8 bytes per 2 at D = 16); V rows padded to D + 4
//     floats keep a quarter warp on distinct bank groups. The epilogue
//     undoes the map: a lane stores 4 consecutive outputs at a time.
// - The online softmax on the accumulator fragments, in the log2
//   domain (q pre-scaled by scale * log2(e), exp2 on the SFU): a row
//   lives in the 4 lanes of a quad, so its max and sum take two
//   shuffles.
// - K/V tiles in a ring of 2G stages filled by cp.async.cg 16-byte
//   copies: a round's G tiles are computed while the next round's are
//   in flight, and the copies of the round after are issued as soon as
//   this one is consumed. A row at or past kv_len is zero-filled with a
//   source size of 0, so it is never read (NaN there stays out).
// - Causal: the loop stops at the last tile the block's last row may
//   see, a warp skips a tile none of its rows sees, and the grid runs
//   the heaviest q-tiles first (q-tile index reversed on the slow grid
//   axis), so the blocks the scheduler places second on an SM are the
//   lightest.
// - The dynamic shared-memory limit is raised once per device and
//   instance, not on every launch.
// - The bf16 instance (q, k, v and out bf16, lse fp32; the reference's
//   kernel is dtype-generic: it widens the bf16 blocks to fp32 and
//   rounds its fp32 result to q's type) is the same kernel on bf16
//   tiles: the K/V ring holds half the bytes, and a bf16 value widened
//   by a shift is exact in TF32, so Q K^T is one TF32 product (exact
//   products, fp32 sums) with the scale applied to the fp32 scores
//   (the reference scales q in fp32 first: the two differ by fp32
//   rounding only), and P V two (P, fp32, in 2xTF32: big and small
//   times the exact V). Its bound is those 3 products at 495 TFLOP/s,
//   or the bf16 FLOP at 989 TFLOP/s on bf16 tensor cores.
// Later work (ROADMAP.md): wgmma / TMA tiles on bf16 inputs.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 2;                // warps along the query rows
constexpr int kRows = 16;                   // query rows per warp (mma m)
constexpr int kBlockQ = kRowWarps * kRows;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block of G key groups walking K/V tiles of BK keys of element type
// T (float or bf16; shared memory holds the tiles in T).
template <int D, int G, int BK, class T>
struct FlashSmem {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kGroups = G;          // warp groups splitting keys
  static constexpr int kBlockK = BK;         // keys per K/V tile
  static constexpr int kStages = 2 * G;      // K/V ring depth
  static constexpr int kThreads = kRowWarps * G * 32;
  // Q and K rows: 16 mod 32 elements (16-byte fp32 or 8-byte bf16
  // fragment loads on distinct bank groups)
  static constexpr int kPadK = (D + 16) % 32 == 16 ? D + 16 : D + 32;
  // V rows: 4 mod 32 floats, 8 mod 32 bf16 (loads of rows 2t and 2t + 1)
  static constexpr int kPadV = kBf16 ? D + 8 : D + 4;
  static constexpr int kTileK = kBlockK * kPadK;
  static constexpr int kTileV = kBlockK * kPadV;
  static constexpr int kElems =
      kBlockQ * kPadK + kStages * (kTileK + kTileV);
  static constexpr size_t kBytes = kElems * sizeof(T);
  static constexpr bool kQInRegs = D <= 64;
  // n tiles of O per 16-byte (or 8-byte) V load
  static constexpr int kVec = D >= 32 ? 4 : 2;
  // floats a lane hands over when the key groups meet
  static constexpr int kXch = 4 + D / 2;
  static_assert((kGroups - 1) * kRowWarps * kXch * 32 * sizeof(float) <=
                    kStages * (kTileK + kTileV) * sizeof(T),
                "the exchange fits in the ring");
  static_assert(kBlockQ * kPadK * sizeof(T) % 16 == 0 &&
                    kPadK * sizeof(T) % 16 == 0 &&
                    kPadV * sizeof(T) % 16 == 0,
                "rows start on 16-byte boundaries");
};

// A fragment operand as the tensor core reads it: fp32 bits of a value
// that is exact in TF32 (a widened bf16)
__device__ __forceinline__ unsigned tf32_exact(float x) {
  return __float_as_uint(x);
}

template <int D, int G, int BK, class T>
__global__ void __launch_bounds__(kRowWarps * G * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int kv_len,
                 int causal, float scale, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh,
                 long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss) {
  using S = FlashSmem<D, G, BK, T>;
  constexpr bool kBf16 = S::kBf16;
  constexpr int kGroups = S::kGroups;
  constexpr int kBlockK = S::kBlockK;
  constexpr int kStages = S::kStages;
  constexpr int kThreads = S::kThreads;
  constexpr int PK = S::kPadK;
  constexpr int PV = S::kPadV;
  constexpr int EC = 16 / (int)sizeof(T);   // elements per 16-byte copy
  constexpr int V4 = D / EC;         // 16-byte chunks per row
  constexpr int KD = D / 8;          // mma k steps over the head dim
  constexpr int NK = kBlockK / 8;    // 8-key slices per tile
  constexpr int VEC = S::kVec;
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);   // [kBlockQ][PK]
  T* k_s = q_s + kBlockQ * PK;            // [kStages][kBlockK][PK]
  T* v_s = k_s + kStages * S::kTileK;     // [kStages][kBlockK][PV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int grp = warp / kRowWarps;   // takes tiles grp, grp + kGroups..
  const int wr = warp % kRowWarps;    // owns rows 16 wr .. 16 wr + 15
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_q = gridDim.y;
  // heaviest causal q-tile first
  const int q0 = (causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kBlockQ;
  const int offset = kv_len - Sq;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // last key any row of this block (and of this warp) may see
  int last = kv_len - 1;
  int warp_last = kv_len - 1;
  if (causal) {
    last = min(last, q0 + kBlockQ - 1 + offset);
    warp_last = min(warp_last, q0 + wr * kRows + kRows - 1 + offset);
  }
  const int n_tiles = last < 0 ? 0 : last / kBlockK + 1;

  auto load_kv = [&](int tile) {
    const int k0 = tile * kBlockK;
    T* ks = k_s + (tile % kStages) * S::kTileK;
    T* vs = v_s + (tile % kStages) * S::kTileV;
    for (int i = tid; i < kBlockK * V4; i += kThreads) {
      const int r = i / V4;
      const int c = (i - r * V4) * EC;
      const bool live = k0 + r < kv_len;   // never read past kv_len
      const long long row = live ? k0 + r : 0;
      mxtt::cp_async16(ks + r * PK + c, kb + row * k_ss + c, live);
      mxtt::cp_async16(vs + r * PV + c, vb + row * v_ss + c, live);
    }
  };

  // copy group 0: the query tile (rows past Sq zero) and the K/V tiles
  // of round 0; copy group 1: those of round 1
  for (int i = tid; i < kBlockQ * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i - r * V4) * EC;
    const bool live = q0 + r < Sq;
    mxtt::cp_async16(q_s + r * PK + c,
                     qb + (long long)(live ? q0 + r : 0) * q_ss + c, live);
  }
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) load_kv(i);
    if (i % kGroups == kGroups - 1) mxtt::cp_async_commit();
  }

  // four consecutive elements of a shared row, as fp32
  auto row4 = [](const T* p) -> float4 {
    if constexpr (S::kBf16)
      return mxtt::bf16x4_widen(*reinterpret_cast<const uint2*>(p));
    else
      return *reinterpret_cast<const float4*>(p);
  };

  // this warp's 16 query rows as A fragments of k steps 2c (head dims
  // 16c + 4t, +1) and 2c + 1 (16c + 4t + 2, +3): fp32 q scaled into the
  // log2 domain and split; bf16 q as it is (exact in TF32; the scale
  // goes on the scores), with no small part
  const T* qw = q_s + wr * kRows * PK;
  const float qscale = scale * kLog2e;
  unsigned qa_big[S::kQInRegs ? KD : 1][4];
  unsigned qa_small[S::kQInRegs && !kBf16 ? KD : 1][4];
  auto q_frags = [&](int c, unsigned (&big)[2][4], unsigned (&small)[2][4]) {
    const float4 lo = row4(qw + g * PK + 16 * c + 4 * t);
    const float4 hi = row4(qw + (g + 8) * PK + 16 * c + 4 * t);
    if constexpr (S::kBf16) {
      big[0][0] = tf32_exact(lo.x);
      big[0][1] = tf32_exact(hi.x);
      big[0][2] = tf32_exact(lo.y);
      big[0][3] = tf32_exact(hi.y);
      big[1][0] = tf32_exact(lo.z);
      big[1][1] = tf32_exact(hi.z);
      big[1][2] = tf32_exact(lo.w);
      big[1][3] = tf32_exact(hi.w);
    } else {
      mxtt::split_tf32(lo.x * qscale, big[0][0], small[0][0]);
      mxtt::split_tf32(hi.x * qscale, big[0][1], small[0][1]);
      mxtt::split_tf32(lo.y * qscale, big[0][2], small[0][2]);
      mxtt::split_tf32(hi.y * qscale, big[0][3], small[0][3]);
      mxtt::split_tf32(lo.z * qscale, big[1][0], small[1][0]);
      mxtt::split_tf32(hi.z * qscale, big[1][1], small[1][1]);
      mxtt::split_tf32(lo.w * qscale, big[1][2], small[1][2]);
      mxtt::split_tf32(hi.w * qscale, big[1][3], small[1][3]);
    }
  };
  if constexpr (S::kQInRegs) {
    mxtt::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KD / 2; ++c) {
      unsigned bg[2][4], sm[2][4];
      q_frags(c, bg, sm);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa_big[2 * c][i] = bg[0][i];
        qa_big[2 * c + 1][i] = bg[1][i];
        if constexpr (!kBf16) {
          qa_small[2 * c][i] = sm[0][i];
          qa_small[2 * c + 1][i] = sm[1][i];
        }
      }
    }
  }

  // rows g and g + 8 of the warp: running max (log2 domain), this
  // lane's share of the denominator, and the output accumulator
  const int row0 = q0 + wr * kRows + g;
  const int row1 = row0 + 8;
  float m0 = MXTT_NEG_INF, m1 = MXTT_NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int round = 0; round * kGroups < n_tiles; ++round) {
    mxtt::cp_async_wait<1>();   // this thread's copies of the round landed
    __syncthreads();            // everyone's
    const int tile = round * kGroups + grp;
    const int k0 = tile * kBlockK;
    // a warp computes when its tile exists and one of its rows sees it
    if (tile < n_tiles && k0 <= warp_last) {
      const T* ks = k_s + (tile % kStages) * S::kTileK;
      const T* vs = v_s + (tile % kStages) * S::kTileV;

      // S = (scale log2e Q) K^T: 16 rows x 32 keys in 4 accumulators
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < KD / 2; ++c) {
        unsigned ab[2][4], as[2][4];
        if constexpr (S::kQInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[0][i] = qa_big[2 * c][i];
            ab[1][i] = qa_big[2 * c + 1][i];
            if constexpr (!kBf16) {
              as[0][i] = qa_small[2 * c][i];
              as[1][i] = qa_small[2 * c + 1][i];
            }
          }
        } else {
          q_frags(c, ab, as);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float4 kx = row4(ks + (j * 8 + g) * PK + 16 * c + 4 * t);
          unsigned bb[2][2], bs[2][2];
          if constexpr (kBf16) {
            bb[0][0] = tf32_exact(kx.x);
            bb[0][1] = tf32_exact(kx.y);
            bb[1][0] = tf32_exact(kx.z);
            bb[1][1] = tf32_exact(kx.w);
            mxtt::mma_tf32(s[j], ab[0], bb[0]);
            mxtt::mma_tf32(s[j], ab[1], bb[1]);
          } else {
            mxtt::split_tf32(kx.x, bb[0][0], bs[0][0]);
            mxtt::split_tf32(kx.y, bb[0][1], bs[0][1]);
            mxtt::split_tf32(kx.z, bb[1][0], bs[1][0]);
            mxtt::split_tf32(kx.w, bb[1][1], bs[1][1]);
            mxtt::mma_3xtf32(s[j], ab[0], as[0], bb[0], bs[0]);
            mxtt::mma_3xtf32(s[j], ab[1], as[1], bb[1], bs[1]);
          }
        }
      }
      if constexpr (kBf16) {
        // the scale, into the log2 domain, on the fp32 scores
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] *= qscale;
      }

      // mask (only tiles that cross kv_len or the diagonal), then the
      // online softmax on the fragments: row g in s[j][0..1], row g + 8
      // in s[j][2..3], keys k0 + 8j + 2t + {0, 1}
      const bool edge = k0 + kBlockK > kv_len ||
                        (causal && k0 + kBlockK - 1 > row0 - g + offset);
      float mx0 = MXTT_NEG_INF, mx1 = MXTT_NEG_INF;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (edge) {
            const int key = k0 + j * 8 + 2 * t + e;
            const bool in = key < kv_len;
            if (!(in && (!causal || key <= row0 + offset)))
              s[j][e] = MXTT_NEG_INF;
            if (!(in && (!causal || key <= row1 + offset)))
              s[j][2 + e] = MXTT_NEG_INF;
          }
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(mxtt::kFullMask, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(mxtt::kFullMask, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // re-mask after the exp: a masked score gives exactly 0
          const float p0 =
              s[j][e] == MXTT_NEG_INF ? 0.f : exp2f(s[j][e] - mn0);
          const float p1 =
              s[j][2 + e] == MXTT_NEG_INF ? 0.f : exp2f(s[j][2 + e] - mn1);
          s[j][e] = p0;
          s[j][2 + e] = p1;
          ps0 += p0;
          ps1 += p1;
        }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }

      // O += P V: the P fragment of slice j is s[j] (A's column t is key
      // 2t, t + 4 key 2t + 1); B's column g of n tile VEC * c + r is
      // head dim 8 VEC c + VEC g + r
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        unsigned pb[4], ps[4];
        mxtt::split_tf32(s[j][0], pb[0], ps[0]);
        mxtt::split_tf32(s[j][2], pb[1], ps[1]);
        mxtt::split_tf32(s[j][1], pb[2], ps[2]);
        mxtt::split_tf32(s[j][3], pb[3], ps[3]);
        const T* v0 = vs + (j * 8 + 2 * t) * PV + VEC * g;
#pragma unroll
        for (int c = 0; c < KD / VEC; ++c) {
          float va[VEC], vb2[VEC];
          if constexpr (VEC == 4) {
            const float4 x0 = row4(v0 + 32 * c);
            const float4 x1 = row4(v0 + PV + 32 * c);
            va[0] = x0.x; va[1] = x0.y; va[2] = x0.z; va[3] = x0.w;
            vb2[0] = x1.x; vb2[1] = x1.y; vb2[2] = x1.z; vb2[3] = x1.w;
          } else if constexpr (kBf16) {
            const unsigned x0 =
                *reinterpret_cast<const unsigned*>(v0 + 16 * c);
            const unsigned x1 =
                *reinterpret_cast<const unsigned*>(v0 + PV + 16 * c);
            va[0] = mxtt::bf16_lo(x0); va[1] = mxtt::bf16_hi(x0);
            vb2[0] = mxtt::bf16_lo(x1); vb2[1] = mxtt::bf16_hi(x1);
          } else {
            const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * c);
            const float2 x1 =
                *reinterpret_cast<const float2*>(v0 + PV + 16 * c);
            va[0] = x0.x; va[1] = x0.y;
            vb2[0] = x1.x; vb2[1] = x1.y;
          }
#pragma unroll
          for (int r = 0; r < VEC; ++r) {
            unsigned bb[2], bs[2];
            if constexpr (kBf16) {
              // V exact in TF32: P's big and small parts times it
              bb[0] = tf32_exact(va[r]);
              bb[1] = tf32_exact(vb2[r]);
              mxtt::mma_tf32(o[VEC * c + r], ps, bb);
              mxtt::mma_tf32(o[VEC * c + r], pb, bb);
            } else {
              mxtt::split_tf32(va[r], bb[0], bs[0]);
              mxtt::split_tf32(vb2[r], bb[1], bs[1]);
              mxtt::mma_3xtf32(o[VEC * c + r], pb, ps, bb, bs);
            }
          }
        }
      }
    }
    __syncthreads();            // the round's stages are consumed
    for (int i = 0; i < kGroups; ++i)
      if ((round + 2) * kGroups + i < n_tiles)
        load_kv((round + 2) * kGroups + i);
    mxtt::cp_async_commit();
  }
  mxtt::cp_async_wait<0>();

  // the key groups' partial states meet: groups 1.. hand (m, l, o) of
  // each lane to the same lane of group 0's warp over the same rows,
  // which folds them in in group order
  __syncthreads();              // the ring is free
  float* xch = reinterpret_cast<float*>(k_s) +
               ((grp > 0 ? grp - 1 : 0) * kRowWarps + wr) * S::kXch * 32 +
               lane;
  if (grp > 0) {
    xch[0] = m0;
    xch[32] = m1;
    xch[64] = l0;
    xch[96] = l1;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) xch[(4 + 4 * n + i) * 32] = o[n][i];
  }
  __syncthreads();
  if (grp > 0) return;
  for (int src = 1; src < kGroups; ++src) {
    const float* in = xch + (src - 1) * kRowWarps * S::kXch * 32;
    const float pm0 = in[0], pm1 = in[32];
    const float nm0 = fmaxf(m0, pm0), nm1 = fmaxf(m1, pm1);
    const float a0 = exp2f(m0 - nm0), c0 = exp2f(pm0 - nm0);
    const float a1 = exp2f(m1 - nm1), c1 = exp2f(pm1 - nm1);
    l0 = l0 * a0 + in[64] * c0;
    l1 = l1 * a1 + in[96] * c1;
    m0 = nm0;
    m1 = nm1;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      o[n][0] = o[n][0] * a0 + in[(4 + 4 * n) * 32] * c0;
      o[n][1] = o[n][1] * a0 + in[(5 + 4 * n) * 32] * c0;
      o[n][2] = o[n][2] * a1 + in[(6 + 4 * n) * 32] * c1;
      o[n][3] = o[n][3] * a1 + in[(7 + 4 * n) * 32] * c1;
    }
  }

  // epilogue: out = o / l_safe (rounded to bf16 in the bf16 instance),
  // lse = m ln 2 + log(l_safe) (a row that saw no key keeps m = -1e30);
  // o[VEC c + r][e] (and [2 + e] for row g + 8) is head dim
  // 8 VEC c + VEC (2t + e) + r
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(mxtt::kFullMask, l0, sh);
    l1 += __shfl_xor_sync(mxtt::kFullMask, l1, sh);
  }
  const float ls0 = l0 > 0.f ? l0 : 1.f;
  const float ls1 = l1 > 0.f ? l1 : 1.f;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  const long long base = (long long)bh * Sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= Sq) continue;
    const float inv = half ? inv1 : inv0;
    T* orow = out + (base + row) * D;
#pragma unroll
    for (int c = 0; c < KD / VEC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        T* dst = orow + 8 * VEC * c + VEC * (2 * t + e);
        const int i = 2 * half + e;
        if constexpr (kBf16 && VEC == 4) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(
              mxtt::bf16_pack(o[4 * c][i] * inv, o[4 * c + 1][i] * inv),
              mxtt::bf16_pack(o[4 * c + 2][i] * inv, o[4 * c + 3][i] * inv));
        } else if constexpr (kBf16) {
          *reinterpret_cast<unsigned*>(dst) =
              mxtt::bf16_pack(o[2 * c][i] * inv, o[2 * c + 1][i] * inv);
        } else if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              o[4 * c][i] * inv, o[4 * c + 1][i] * inv,
              o[4 * c + 2][i] * inv, o[4 * c + 3][i] * inv);
        } else {
          *reinterpret_cast<float2*>(dst) =
              make_float2(o[2 * c][i] * inv, o[2 * c + 1][i] * inv);
        }
      }
    if (t == 0) {
      const float m = half ? m1 : m0;
      lse[base + row] = (m == MXTT_NEG_INF ? m : m * kLn2) +
                        logf(half ? ls1 : ls0);
    }
  }
}

constexpr int kMaxDevices = 64;

// The dynamic shared-memory limit of an instance, raised once per device.
template <int D, int G, int BK, class T>
cudaError_t raise_smem_limit(int dev) {
  static int raised[kMaxDevices] = {};   // 0: not yet, 1: done
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, G, BK, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FlashSmem<D, G, BK, T>::kBytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = 1;
  return err;
}

// The device's SM count, read once per device.
cudaError_t sm_count(int dev, int* n) {
  static int count[kMaxDevices] = {};
  if (dev < kMaxDevices && count[dev]) {
    *n = count[dev];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) count[dev] = *n;
  return err;
}

template <int D, int G, int BK, class T>
cudaError_t launch_shape(const T* q, const T* k, const T* v, T* out,
                         float* lse, int dev, int B, int H, int Sq,
                         int kv_len, int causal, float scale,
                         const long long* st, cudaStream_t stream) {
  using S = FlashSmem<D, G, BK, T>;
  const cudaError_t err = raise_smem_limit<D, G, BK, T>(dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, G, BK, T><<<grid, S::kThreads, S::kBytes, stream>>>(
      q, k, v, out, lse, H, Sq, kv_len, causal, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// Four key groups on 16-key tiles while the grid fits in one wave of two
// blocks per SM (the prefill's 512 tokens: 192 blocks): the work per
// block then sets the time, and splitting its keys four ways shortens
// it. Past that (1024 tokens: 384 blocks) two groups on 32-key tiles do
// less work per key and win.
template <int D, class T>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, float* lse,
                   int B, int H, int Sq, int kv_len, int causal, float scale,
                   const long long* st, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)B * H * ((Sq + kBlockQ - 1) / kBlockQ);
  if (blocks <= 2LL * sms)
    return launch_shape<D, 4, 16>(q, k, v, out, lse, dev, B, H, Sq, kv_len,
                                  causal, scale, st, stream);
  return launch_shape<D, 2, 32>(q, k, v, out, lse, dev, B, H, Sq, kv_len,
                                causal, scale, st, stream);
}

template <class T>
int dispatch(const T* q, const T* k, const T* v, T* out, float* lse, int B,
             int H, int Sq, int D, int kv_len, int causal, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if ((Sq + kBlockQ - 1) / kBlockQ > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, out, lse, B, H, Sq, kv_len, causal, scale,
                        strides, s);
    case 32:
      return launch<32>(q, k, v, out, lse, B, H, Sq, kv_len, causal, scale,
                        strides, s);
    case 64:
      return launch<64>(q, k, v, out, lse, B, H, Sq, kv_len, causal, scale,
                        strides, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, H, Sq, kv_len, causal, scale,
                         strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D), k / v: (B, H, Sk, D), all fp32 with a contiguous
// last axis and 16-byte aligned rows; ``strides`` holds the (b, h, s)
// element strides of q, k and v in that order. out: (B, H, Sq, D) and
// lse: (B, H, Sq), contiguous fp32. Returns the cudaError_t of the
// launch.
int mxtt_flash_attention_fwd(const float* q, const float* k, const float* v,
                             float* out, float* lse, int B, int H, int Sq,
                             int D, int kv_len, int causal, float scale,
                             const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, out, lse, B, H, Sq, D, kv_len, causal,
                         scale, strides, stream);
}

// The bf16 instance: q, k, v and out bf16 (the same layouts, strides in
// bf16 elements), lse fp32.
int mxtt_flash_attention_fwd_bf16(const mxtt::bf16* q, const mxtt::bf16* k,
                                  const mxtt::bf16* v, mxtt::bf16* out,
                                  float* lse, int B, int H, int Sq, int D,
                                  int kv_len, int causal, float scale,
                                  const long long* strides, void* stream) {
  return dispatch<mxtt::bf16>(q, k, v, out, lse, B, H, Sq, D, kv_len, causal,
                              scale, strides, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
