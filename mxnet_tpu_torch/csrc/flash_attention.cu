// K1 — flash attention forward (fp32, bf16 and float16) for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py flash_attention_pallas
// (kernel body _flash_fwd_kernel). Same function: blockwise
// online-softmax attention over (B, H, S, D), causal or not, keys at or
// past kv_len masked, the causal diagonal end-aligned at
// offset = kv_len - Sq, fp32 running max / denominator / numerator,
// the masked score -1e30 with p re-masked to 0 after the exp, the
// l_safe guard, and outputs (out, lse).
//
// The fp32 instance. What bounds it on the H100: operations. The two
// products do 4 * D FLOP per (query, visible key) pair against 16 * D
// bytes per row of q, k, v and out, so the work per byte grows with the
// sequence. The
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
//
// The bf16 instance (q, k, v and out bf16, lse fp32; the reference's
// kernel is dtype-generic: it widens the bf16 blocks to fp32 and rounds
// its fp32 result to q's type) is a kernel of its own,
// flash_fwd_wg_kernel<D, bf16>, on Hopper's bf16 tensor cores:
// - Bound: the bf16 FLOP at 989 TFLOP/s against the bytes of q, k, v
//   and out at 3.35 TB/s; at the prefill's 512 tokens the bytes set it.
//   It runs the equivalent of three bf16 products per tile pair (below).
//   What sets its time is the chain a block walks: a 64-row query tile
//   against up to S / 64 key tiles, each a product, a softmax and a
//   product that depend on each other.
// - Tiles by TMA. The wrapper's strided (B, H, S, D) views are described
//   per call by three 4-d tensor maps (D, S, H, B) with their byte
//   strides (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
//   nothing links libcuda), passed as __grid_constant__ parameters. A
//   box is 64 rows of a 128-byte swizzled span of the row (D = 64; two
//   boxes at D = 128; 64- and 32-byte swizzles at D = 32 and 16), the
//   layout wgmma reads. The K and V maps end at kv_len: rows at or past
//   it arrive as zeros and are never read.
// - Work per block: one 64-row query tile, whose K/V tiles its NW
//   warpgroups (4 at D <= 64, 3 at D = 128) take round-robin; their
//   states (m, l, o) meet in shared memory at the end, folded in in
//   order, as the fp32 kernel's key groups do. Splitting the keys
//   shortens the chain: at 512 tokens the grid (8 q-tiles x 12 heads) is
//   under one wave of SMs, and at 1024 it beat warpgroups that each own
//   64 rows over a shared ring by 1.7x (PERF.md). The heaviest causal
//   tiles run first; a tile above the diagonal is never loaded.
// - The ring: stage t % (2 NW) holds K/V tile t, so each warpgroup owns
//   two stages. Thread 0 sets up the mbarriers and starts the copies of
//   the query tile and tile 0; each warpgroup's lane 0 those of its
//   first two tiles, and once its four warps have released a stage (an
//   arrival each), refills it with the tile 2 NW further on. No producer warp: its 32 threads
//   would cap a 512-thread block's registers below what the warpgroups
//   keep.
// - Products as wgmma m64nNk16 bf16 with fp32 accumulation. S = Q K^T
//   reads Q and K from shared memory (both K-major; a k step moves the
//   descriptor 32 bytes along the swizzled row). bf16 x bf16 is exact
//   in fp32, so S is the fp32 product of the widened values up to the
//   order of the sums; the scale, into the log2 domain, goes on the fp32
//   scores (folded into the exp's FFMA).
// - O += P V takes P from registers: the S accumulator's layout is the
//   A fragment's, so P is rounded and packed in place. The reference
//   keeps P in fp32; one bf16 P would cost about 2^-9 of the output,
//   half of the output's own bf16 step, so P is split as
//   hi = bf16(P), lo = bf16(P - hi) and both go through one accumulator
//   against V (MN-major, the transpose bit): within about 2^-16 of the
//   fp32 product (tests/test_torch_flash_bf16.py emulates both).
// - A warpgroup runs its tiles in order (S, softmax, P V); the block's
//   warpgroups overlap each other's products and softmax on the SM. An
//   order within the warpgroup that started the next tile's S before its
//   softmax of this one timed 1-5 % slower: ptxas serialized all its
//   wgmma (C7515), as the softmax wrote s while P V was in flight. ptxas
//   also serializes wgmma that sit in a branch it takes as divergent
//   (C7520), so the warpgroup and warp indices are made warp-uniform
//   with a shuffle. `_build.build_info` keeps such warnings.
// - Masks only on tiles that cross kv_len or the diagonal, as -inf on
//   the raw scores (exp gives exactly 0); a non-positive scale takes the
//   reference's steps instead (scale, -1e30, exp, re-mask to 0).
// - Epilogue: out = o / l_safe rounded to bf16, lse = m ln 2 +
//   log(l_safe) in fp32.
//
// The float16 instance is the same kernel, flash_fwd_wg_kernel, on the
// element type T = float16: wgmma's .f16 form (fp32 accumulation, so
// S = Q K^T is again the fp32 product of the widened values), TMA maps
// of type FLOAT16, and the P split hi = f16(P), lo = f16(P - hi).
// float16 keeps 11 significant bits to bf16's 8, so the split P is
// within about 2^-22 of fp32 where it is normal; below float16's 2^-14
// hi and lo lose bits (subnormal), and below about 2^-24 a p becomes 0,
// an error under 2^-24 of the row's largest p, which is 1. The epilogue
// rounds to float16. Bound and design as the bf16 instance's (float16
// runs at the bf16 rate).
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRowWarps = 2;                // warps along the query rows
constexpr int kRows = 16;                   // query rows per warp (mma m)
constexpr int kBlockQ = kRowWarps * kRows;  // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block of G key groups walking fp32 K/V tiles of BK keys.
template <int D, int G, int BK>
struct FlashSmem {
  static constexpr int kGroups = G;          // warp groups splitting keys
  static constexpr int kBlockK = BK;         // keys per K/V tile
  static constexpr int kStages = 2 * G;      // K/V ring depth
  static constexpr int kThreads = kRowWarps * G * 32;
  // Q and K rows: 16 mod 32 floats (16-byte fragment loads on distinct
  // bank groups)
  static constexpr int kPadK = (D + 16) % 32 == 16 ? D + 16 : D + 32;
  // V rows: 4 mod 32 floats (loads of rows 2t and 2t + 1)
  static constexpr int kPadV = D + 4;
  static constexpr int kTileK = kBlockK * kPadK;
  static constexpr int kTileV = kBlockK * kPadV;
  static constexpr int kElems =
      kBlockQ * kPadK + kStages * (kTileK + kTileV);
  static constexpr size_t kBytes = kElems * sizeof(float);
  static constexpr bool kQInRegs = D <= 64;
  // n tiles of O per 16-byte (or 8-byte) V load
  static constexpr int kVec = D >= 32 ? 4 : 2;
  // floats a lane hands over when the key groups meet
  static constexpr int kXch = 4 + D / 2;
  static_assert((kGroups - 1) * kRowWarps * kXch * 32 * sizeof(float) <=
                    kStages * (kTileK + kTileV) * sizeof(float),
                "the exchange fits in the ring");
  static_assert(kBlockQ * kPadK % 4 == 0 && kPadK % 4 == 0 &&
                    kPadV % 4 == 0,
                "rows start on 16-byte boundaries");
};

template <int D, int G, int BK>
__global__ void __launch_bounds__(kRowWarps * G * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int kv_len,
                 int causal, float scale, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh,
                 long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss) {
  using S = FlashSmem<D, G, BK>;
  constexpr int kGroups = S::kGroups;
  constexpr int kBlockK = S::kBlockK;
  constexpr int kStages = S::kStages;
  constexpr int kThreads = S::kThreads;
  constexpr int PK = S::kPadK;
  constexpr int PV = S::kPadV;
  constexpr int EC = 4;              // floats per 16-byte copy
  constexpr int V4 = D / EC;         // 16-byte chunks per row
  constexpr int KD = D / 8;          // mma k steps over the head dim
  constexpr int NK = kBlockK / 8;    // 8-key slices per tile
  constexpr int VEC = S::kVec;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBlockQ][PK]
  float* k_s = q_s + kBlockQ * PK;             // [kStages][kBlockK][PK]
  float* v_s = k_s + kStages * S::kTileK;      // [kStages][kBlockK][PV]

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
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

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
    float* ks = k_s + (tile % kStages) * S::kTileK;
    float* vs = v_s + (tile % kStages) * S::kTileV;
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

  // four consecutive floats of a shared row
  auto row4 = [](const float* p) -> float4 {
    return *reinterpret_cast<const float4*>(p);
  };

  // this warp's 16 query rows as A fragments of k steps 2c (head dims
  // 16c + 4t, +1) and 2c + 1 (16c + 4t + 2, +3): q scaled into the log2
  // domain and split
  const float* qw = q_s + wr * kRows * PK;
  const float qscale = scale * kLog2e;
  unsigned qa_big[S::kQInRegs ? KD : 1][4];
  unsigned qa_small[S::kQInRegs ? KD : 1][4];
  auto q_frags = [&](int c, unsigned (&big)[2][4], unsigned (&small)[2][4]) {
    const float4 lo = row4(qw + g * PK + 16 * c + 4 * t);
    const float4 hi = row4(qw + (g + 8) * PK + 16 * c + 4 * t);
    mxtt::split_tf32(lo.x * qscale, big[0][0], small[0][0]);
    mxtt::split_tf32(hi.x * qscale, big[0][1], small[0][1]);
    mxtt::split_tf32(lo.y * qscale, big[0][2], small[0][2]);
    mxtt::split_tf32(hi.y * qscale, big[0][3], small[0][3]);
    mxtt::split_tf32(lo.z * qscale, big[1][0], small[1][0]);
    mxtt::split_tf32(hi.z * qscale, big[1][1], small[1][1]);
    mxtt::split_tf32(lo.w * qscale, big[1][2], small[1][2]);
    mxtt::split_tf32(hi.w * qscale, big[1][3], small[1][3]);
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
        qa_small[2 * c][i] = sm[0][i];
        qa_small[2 * c + 1][i] = sm[1][i];
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
      const float* ks = k_s + (tile % kStages) * S::kTileK;
      const float* vs = v_s + (tile % kStages) * S::kTileV;

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
            as[0][i] = qa_small[2 * c][i];
            as[1][i] = qa_small[2 * c + 1][i];
          }
        } else {
          q_frags(c, ab, as);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float4 kx = row4(ks + (j * 8 + g) * PK + 16 * c + 4 * t);
          unsigned bb[2][2], bs[2][2];
          mxtt::split_tf32(kx.x, bb[0][0], bs[0][0]);
          mxtt::split_tf32(kx.y, bb[0][1], bs[0][1]);
          mxtt::split_tf32(kx.z, bb[1][0], bs[1][0]);
          mxtt::split_tf32(kx.w, bb[1][1], bs[1][1]);
          mxtt::mma_3xtf32(s[j], ab[0], as[0], bb[0], bs[0]);
          mxtt::mma_3xtf32(s[j], ab[1], as[1], bb[1], bs[1]);
        }
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
        const float* v0 = vs + (j * 8 + 2 * t) * PV + VEC * g;
#pragma unroll
        for (int c = 0; c < KD / VEC; ++c) {
          float va[VEC], vb2[VEC];
          if constexpr (VEC == 4) {
            const float4 x0 = row4(v0 + 32 * c);
            const float4 x1 = row4(v0 + PV + 32 * c);
            va[0] = x0.x; va[1] = x0.y; va[2] = x0.z; va[3] = x0.w;
            vb2[0] = x1.x; vb2[1] = x1.y; vb2[2] = x1.z; vb2[3] = x1.w;
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
            mxtt::split_tf32(va[r], bb[0], bs[0]);
            mxtt::split_tf32(vb2[r], bb[1], bs[1]);
            mxtt::mma_3xtf32(o[VEC * c + r], pb, ps, bb, bs);
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

  // epilogue: out = o / l_safe, lse = m ln 2 + log(l_safe) (a row that saw no key keeps m = -1e30);
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
    float* orow = out + (base + row) * D;
#pragma unroll
    for (int c = 0; c < KD / VEC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = orow + 8 * VEC * c + VEC * (2 * t + e);
        const int i = 2 * half + e;
        if constexpr (VEC == 4) {
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

// ---- the bf16 instance: wgmma on tiles brought by TMA ---------------------
constexpr int kWgRows = 64;   // query rows of a block (the wgmma m)
constexpr int kWgKeys = 64;   // keys per K/V tile (the n of S = Q K^T)

// The warpgroups of a block at head dim D: they split the block's K/V
// tiles round-robin, and each keeps two stages of the ring in flight.
// Four (512 threads, at most 128 registers a thread) at D <= 64, which
// timed 3 % faster than three at 512 and 1024 tokens
// (scripts/torch_kernel_ab.py, PERF.md); three at D = 128, whose o takes
// 64 registers and whose eight stages would not fit.
template <int D>
constexpr int kWgConsumers = D <= 64 ? 4 : 3;

// Shared memory of a block: the query tile, a ring of K/V stages (two a
// warpgroup), the mbarriers.
template <int D>
struct WgSmem {
  static constexpr int kNW = kWgConsumers<D>;
  static constexpr int kThreads = kNW * 128;
  static constexpr int kStages = 2 * kNW;
  static constexpr int kSwizzle = D * 2 >= 128 ? 128 : D * 2;  // bytes
  static constexpr int kBoxD = kSwizzle / 2;   // head dims of a TMA box
  static constexpr int kParts = D / kBoxD;     // boxes across a row
  static constexpr int kPart = kWgRows * kSwizzle;   // bytes of a box
  static constexpr int kTile = kParts * kPart;       // bytes of 64 rows
  static constexpr int kK = kTile;                   // the K ring
  static constexpr int kV = kK + kStages * kTile;    // the V ring
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kNumBars = 1 + 2 * kStages;   // q, full, empty
  // + slack to align the base to the 128-byte swizzle's 1024 bytes
  static constexpr size_t kBytes = kBars + 8 * kNumBars + 1024;
  // floats a lane hands over when the warpgroups meet
  static constexpr int kXch = 4 + D / 2;
  static_assert((kNW - 1) * kXch * 128 * 4 <= 2 * kStages * kTile,
                "the exchange fits in the ring");
};

template <int D, class T>
__global__ void __launch_bounds__(WgSmem<D>::kThreads, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    T* __restrict__ out, float* __restrict__ lse, int H,
                    int Sq, int kv_len, int causal, float scale) {
  using S = WgSmem<D>;
  constexpr int kNW = S::kNW;
  constexpr int kStages = S::kStages;
  constexpr int kSteps = D / 16;                   // k steps of Q K^T
  constexpr int kStepsPerBox = S::kSwizzle / 32;   // of them in one box
  constexpr int kN = D < 64 ? D : 64;              // n of one P V product
  constexpr int kNC = D / kN;                      // P V products a k step
  constexpr int kPSteps = kWgKeys / 16;            // k steps of P V
  constexpr unsigned kSbo = 8 * S::kSwizzle;       // 8-row group stride
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = mxtt::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const unsigned sbase = mxtt::smem_addr(smem);
  const unsigned bar_q = sbase + S::kBars;
  auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + kStages + st); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  // heaviest causal q-tile first
  const int q0 = (causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                         : (int)blockIdx.y) * kWgRows;
  const int offset = kv_len - Sq;
  int last = kv_len - 1;   // the last key a row of the block sees
  if (causal) last = min(last, q0 + kWgRows - 1 + offset);
  const int n_tiles = last < 0 ? 0 : last / kWgKeys + 1;

  // Thread 0 sets up the mbarriers (one fence for all) and starts the
  // copies of the query tile and K/V tile 0 before the block's barrier. A warpgroup
  // takes tiles wg, wg + kNW, .. and stage t % kStages holds tile t, so
  // each warpgroup owns two stages: its leader starts its first two
  // tiles, and refills a stage with tile t + kStages once its four warps
  // have released tile t.
  const bool leader = (tid & 127) == 0;
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    mxtt::mbar_arrive_expect_tx(bar_full(st), 2 * S::kTile);
    for (int p = 0; p < S::kParts; ++p) {
      mxtt::tma_load_4d(smem + S::kK + st * S::kTile + p * S::kPart, &k_map,
                        p * S::kBoxD, t * kWgKeys, h, b, bar_full(st));
      mxtt::tma_load_4d(smem + S::kV + st * S::kTile + p * S::kPart, &v_map,
                        p * S::kBoxD, t * kWgKeys, h, b, bar_full(st));
    }
  };
  if (tid == 0) {
    mxtt::prefetch_tensormap(&q_map);
    mxtt::prefetch_tensormap(&k_map);
    mxtt::prefetch_tensormap(&v_map);
    // q, full (one arrival each), empty (the warpgroup's four warps)
    for (int i = 0; i < S::kNumBars; ++i)
      mxtt::mbar_init(bar_q + 8 * i, i <= kStages ? 1 : 4, false);
    mxtt::mbar_init_fence();
    if (n_tiles > 0) {
      mxtt::mbar_arrive_expect_tx(bar_q, S::kTile);
      for (int p = 0; p < S::kParts; ++p)
        mxtt::tma_load_4d(smem + p * S::kPart, &q_map, p * S::kBoxD, q0, h,
                          b, bar_q);
      load_kv(0);
    }
  }
  __syncthreads();

  // the warpgroup index, made warp-uniform for the compiler (a shuffle
  // from lane 0): the wgmma products below sit in branches on it, and in
  // a branch it must take as divergent ptxas serializes them
  const int wg = __shfl_sync(mxtt::kFullMask, tid >> 7, 0);
  if (leader) {
    if (wg > 0 && wg < n_tiles) load_kv(wg);
    if (wg + kNW < n_tiles) load_kv(wg + kNW);
  }

  // this warpgroup: tiles wg, wg + kNW, .. of the block's range
  const int warp = __shfl_sync(mxtt::kFullMask, (tid >> 5) & 3, 0);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float qscale = scale * kLog2e;

  // rows g and g + 8 of the warp: running max (log2 domain), this lane's
  // share of the row sum, and the output accumulator: o[c][4 i + e] is
  // head dim 64 c + 8 i + 2 t + e % 2 of row g (e < 2) or g + 8
  float m0 = MXTT_NEG_INF, m1 = MXTT_NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[kNC][kN / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o[c][i] = 0.f;
  // the scores of a tile: s[4 i + e] is key k0 + 8 i + 2 t + e % 2 of
  // row g (e < 2) or g + 8; then its P, split in bf16 hi + lo as the A
  // fragments of P V's k steps (register r of step j: s[8 j + 2 r], + 1)
  float s[kWgKeys / 2];
#pragma unroll
  for (int i = 0; i < kWgKeys / 2; ++i) s[i] = 0.f;
  unsigned ph[kPSteps][4], pl[kPSteps][4];

  // S = Q K^T into s (started, not waited for)
  auto start_scores = [&](int st) {
    const unsigned k_s = sbase + S::kK + st * S::kTile;
    mxtt::wgmma_fence_operand(s);
    mxtt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const unsigned off =
          (j / kStepsPerBox) * S::kPart + (j % kStepsPerBox) * 32;
      mxtt::wgmma_ss_n64<T>(
          s, mxtt::wgmma_desc<S::kSwizzle>(sbase + off, 16, kSbo),
          mxtt::wgmma_desc<S::kSwizzle>(k_s + off, 16, kSbo), j > 0);
    }
    mxtt::wgmma_commit();
  };
  // O += P_hi V + P_lo V (started): V is B, MN-major; a k step, 16 rows
  auto start_pv = [&](int st) {
    const unsigned v_s = sbase + S::kV + st * S::kTile;
#pragma unroll
    for (int c = 0; c < kNC; ++c) mxtt::wgmma_fence_operand(o[c]);
    mxtt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const uint64_t dv = mxtt::wgmma_desc<S::kSwizzle>(
            v_s + c * S::kPart + j * 16 * S::kSwizzle, S::kPart, kSbo);
        mxtt::wgmma_rs<kN, T>(o[c], ph[j], dv);
        mxtt::wgmma_rs<kN, T>(o[c], pl[j], dv);
      }
    mxtt::wgmma_commit();
  };
  // the online softmax on s, in the log2 domain (a row lives in a quad);
  // the factors that rescale o come back in al0, al1. With a positive
  // scale the max of the raw scores, scaled, is the max of the scaled
  // ones, and each p is one FFMA and one exp; a tile that crosses kv_len
  // or the diagonal first sets its masked scores to -inf, whose exp is
  // exactly 0 (a row with no key yet keeps m = -1e30, so alpha stays 1).
  // Any other scale takes the reference's steps: scale, mask to -1e30,
  // exp, re-mask to 0.
  auto softmax = [&](int t, float& al0, float& al1) {
    const int k0 = t * kWgKeys;
    const bool edge = k0 + kWgKeys > kv_len ||
                      (causal && k0 + kWgKeys - 1 > q0 + offset);
    // the last key of each row, relative to this lane's first column
    const int c0 = k0 + 2 * t4;
    const int lim0 = (causal ? min(row0 + offset, kv_len - 1) : kv_len - 1)
                     - c0;
    const int lim1 = (causal ? min(row1 + offset, kv_len - 1) : kv_len - 1)
                     - c0;
    const bool pos = qscale > 0.f;
    if (pos) {
      if (edge) {
#pragma unroll
        for (int i = 0; i < kWgKeys / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * i + e > lim0) s[4 * i + e] = -INFINITY;
            if (8 * i + e > lim1) s[4 * i + 2 + e] = -INFINITY;
          }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWgKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& a0 = s[4 * i + e];
          float& a1 = s[4 * i + 2 + e];
          a0 = 8 * i + e > lim0 ? MXTT_NEG_INF : a0 * qscale;
          a1 = 8 * i + e > lim1 ? MXTT_NEG_INF : a1 * qscale;
        }
    }
    // -inf: a row whose keys are all masked here leaves m as it is
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWgKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, s[4 * i + e]);
        mx1 = fmaxf(mx1, s[4 * i + 2 + e]);
      }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(mxtt::kFullMask, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(mxtt::kFullMask, mx1, sh));
    }
    if (pos) {
      mx0 *= qscale;
      mx1 *= qscale;
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = mxtt::exp2_ftz(m0 - mn0);
    al1 = mxtt::exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < kWgKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a0 = s[4 * i + e];
        float& a1 = s[4 * i + 2 + e];
        if (pos) {
          a0 = mxtt::exp2_ftz(fmaf(a0, qscale, -mn0));
          a1 = mxtt::exp2_ftz(fmaf(a1, qscale, -mn1));
        } else {
          a0 = a0 == MXTT_NEG_INF ? 0.f : mxtt::exp2_ftz(a0 - mn0);
          a1 = a1 == MXTT_NEG_INF ? 0.f : mxtt::exp2_ftz(a1 - mn1);
        }
        ps0 += a0;
        ps1 += a1;
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
  };
  // o *= alpha, and P into its fragments
  auto rescale_and_split = [&](float al0, float al1) {
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        o[c][4 * i] *= al0;
        o[c][4 * i + 1] *= al0;
        o[c][4 * i + 2] *= al1;
        o[c][4 * i + 3] *= al1;
      }
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mxtt::split_pair<T>(s[8 * j + 2 * r], s[8 * j + 2 * r + 1],
                            ph[j][r], pl[j][r]);
  };
  // tile t's stage is free: each warp arrives; warp 0 waits for the four
  // (the whole warp: a wait loop in a branch ptxas takes as divergent
  // serializes the products) and its lane 0 refills the stage with tile
  // t + kStages
  auto release = [&](int t) {
    const int st = t % kStages;
    __syncwarp();
    if (lane == 0) mxtt::mbar_arrive(bar_empty(st));
    if (warp == 0 && t + kStages < n_tiles) {
      mxtt::mbar_wait<false>(bar_empty(st), (t / kStages) & 1);
      if (lane == 0) load_kv(t + kStages);
    }
  };

  // A warpgroup runs its tiles in order; the block's warpgroups overlap
  // each other's products and softmax on the SM.
  if (wg < n_tiles) mxtt::mbar_wait<false>(bar_q, 0);
  for (int t = wg; t < n_tiles; t += kNW) {
    const int st = t % kStages;
    mxtt::mbar_wait<false>(bar_full(st), (t / kStages) & 1);
    start_scores(st);
    mxtt::wgmma_wait<0>();
    mxtt::wgmma_fence_operand(s);
    float al0, al1;
    softmax(t, al0, al1);
    rescale_and_split(al0, al1);
    start_pv(st);
    mxtt::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kNC; ++c) mxtt::wgmma_fence_operand(o[c]);
    release(t);
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(mxtt::kFullMask, l0, sh);
    l1 += __shfl_xor_sync(mxtt::kFullMask, l1, sh);
  }
  // the warpgroups' states meet: warpgroups 1.. hand (m, l, o) of each
  // lane to the same lane of warpgroup 0 through the ring, which no copy
  // writes any more once all are past the first barrier; warpgroup 0
  // folds them in in order
  __syncthreads();
  float* xch = reinterpret_cast<float*>(smem + S::kK) + (tid & 127);
  if (wg > 0) {
    float* mine = xch + (wg - 1) * S::kXch * 128;
    mine[0] = m0;
    mine[128] = m1;
    mine[256] = l0;
    mine[384] = l1;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i)
        mine[(4 + c * (kN / 2) + i) * 128] = o[c][i];
  }
  __syncthreads();
  if (wg > 0) return;
  for (int src = 1; src < kNW; ++src) {
    const float* in = xch + (src - 1) * S::kXch * 128;
    const float pm0 = in[0], pm1 = in[128];
    const float nm0 = fmaxf(m0, pm0), nm1 = fmaxf(m1, pm1);
    const float a0 = mxtt::exp2_ftz(m0 - nm0);
    const float c0 = mxtt::exp2_ftz(pm0 - nm0);
    const float a1 = mxtt::exp2_ftz(m1 - nm1);
    const float c1 = mxtt::exp2_ftz(pm1 - nm1);
    l0 = l0 * a0 + in[256] * c0;
    l1 = l1 * a1 + in[384] * c1;
    m0 = nm0;
    m1 = nm1;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const float x = in[(4 + c * (kN / 2) + i) * 128];
        o[c][i] = (i & 2) ? o[c][i] * a1 + x * c1 : o[c][i] * a0 + x * c0;
      }
  }

  // epilogue: out = o / l_safe in T (times the reciprocal, as the
  // fp32 instance), lse = m ln 2 + log(l_safe) (a row that saw no key
  // keeps m = -1e30)
  const float ls0 = l0 > 0.f ? l0 : 1.f;
  const float ls1 = l1 > 0.f ? l1 : 1.f;
  const long long base = (long long)bh * Sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= Sq) continue;
    const float ls = half ? ls1 : ls0;
    const float inv = 1.f / ls;
    T* orow = out + (base + row) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
        *reinterpret_cast<unsigned*>(orow + c * kN + 8 * i + 2 * t4) =
            mxtt::half_pack<T>(o[c][4 * i + 2 * half] * inv,
                            o[c][4 * i + 2 * half + 1] * inv);
    if (t4 == 0) {
      const float m = half ? m1 : m0;
      lse[base + row] = (m == MXTT_NEG_INF ? m : m * kLn2) + logf(ls);
    }
  }
}

using mxtt::kMaxDevices;
using mxtt::raise_smem_limit;

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

template <int D, int G, int BK>
cudaError_t launch_shape(const float* q, const float* k, const float* v,
                         float* out, float* lse, int dev, int B, int H,
                         int Sq, int kv_len, int causal, float scale,
                         const long long* st, cudaStream_t stream) {
  using S = FlashSmem<D, G, BK>;
  const cudaError_t err =
      raise_smem_limit<flash_fwd_kernel<D, G, BK>, S::kBytes>(dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, G, BK><<<grid, S::kThreads, S::kBytes, stream>>>(
      q, k, v, out, lse, H, Sq, kv_len, causal, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// Four key groups on 16-key tiles while the grid fits in one wave of two
// blocks per SM (the prefill's 512 tokens: 192 blocks): the work per
// block then sets the time, and splitting its keys four ways shortens
// it. Past that (1024 tokens: 384 blocks) two groups on 32-key tiles do
// less work per key and win.
template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, int B, int H, int Sq, int kv_len,
                   int causal, float scale, const long long* st,
                   cudaStream_t stream) {
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

template <int D, class T>
cudaError_t launch_wg(const T* q, const T* k, const T* v, T* out, float* lse,
                      int B, int H, int Sq, int kv_len, int causal,
                      float scale, const long long* st,
                      cudaStream_t stream) {
  using S = WgSmem<D>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = raise_smem_limit<flash_fwd_wg_kernel<D, T>, S::kBytes>(dev);
  // per-call tensor maps of the strided views (common.cuh
  // tensor_map_rows: boxes of kBoxD head dims x 64 rows); K and V end at
  // kv_len
  static_assert(kWgRows == 64 && S::kBoxD * 2 == S::kSwizzle, "the box");
  constexpr int kSw = S::kSwizzle;
  CUtensorMap qm, km, vm;
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&qm, q, D, B, H, Sq, st);
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&km, k, D, B, H, kv_len, st + 3);
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&vm, v, D, B, H, kv_len, st + 6);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kWgRows - 1) / kWgRows);
  flash_fwd_wg_kernel<D, T><<<grid, S::kThreads, S::kBytes, stream>>>(
      qm, km, vm, out, lse, H, Sq, kv_len, causal, scale);
  return cudaGetLastError();
}

template <class T>
int dispatch(const T* q, const T* k, const T* v, T* out, float* lse, int B,
             int H, int Sq, int D, int kv_len, int causal, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if ((Sq + kBlockQ - 1) / kBlockQ > 65535) return cudaErrorInvalidValue;
  auto run = [&](auto d) -> cudaError_t {
    constexpr int kD = decltype(d)::value;
    if constexpr (sizeof(T) == 2)
      return launch_wg<kD, T>(q, k, v, out, lse, B, H, Sq, kv_len, causal,
                             scale, strides, s);
    else
      return launch<kD>(q, k, v, out, lse, B, H, Sq, kv_len, causal, scale,
                        strides, s);
  };
  switch (D) {
    case 16:
      return run(std::integral_constant<int, 16>());
    case 32:
      return run(std::integral_constant<int, 32>());
    case 64:
      return run(std::integral_constant<int, 64>());
    case 128:
      return run(std::integral_constant<int, 128>());
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

// The float16 instance: q, k, v and out float16 (the same layouts,
// strides in float16 elements), lse fp32.
int mxtt_flash_attention_fwd_f16(const mxtt::f16* q, const mxtt::f16* k,
                                 const mxtt::f16* v, mxtt::f16* out,
                                 float* lse, int B, int H, int Sq, int D,
                                 int kv_len, int causal, float scale,
                                 const long long* strides, void* stream) {
  return dispatch<mxtt::f16>(q, k, v, out, lse, B, H, Sq, D, kv_len, causal,
                             scale, strides, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
