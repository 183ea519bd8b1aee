// K1-bwd — flash attention backward (fp32, bf16 and float16) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference's backward is the blockwise jnp
// scan mxnet_tpu/ops/attention.py _flash_bwd (the custom_vjp of
// flash_attention), and this is that function as a kernel, so that the
// training step's attention backward runs on the card in hand-written
// code beside K1's forward. Same function: from q, k, v, the forward's
// out and lse, and dO it rematerializes P = exp(s - lse) over the valid
// (query, key) pairs (keys below kv_len, and on or below the causal
// diagonal end-aligned at offset = kv_len - Sq), with
//   delta = sum_d dO * out,  ds = p * (dp - delta) * scale,  dp = dO V^T,
//   dq = ds K,  dk = ds^T q,  dv = p^T dO,
// everything in fp32 from the widened inputs, and the gradients written
// in q's, k's and v's type. A pair outside the mask gets p = 0 by a
// select, never by a multiply: a causal row that sees no key (kv_len <
// Sq) has lse = -1e30 and gets zero gradients, as in the reference.
//
// Two launches, no atomics, in every instance: the dq launch, a block
// per (batch x head, 64-row query tile), computes delta for its rows
// (written to a scratch row for the second launch) and walks the key
// tiles up to kv_len and, causal, up to the diagonal of its last row;
// the dkv launch, a block per (batch x head, 64-key tile), walks the
// query tiles from the first row that sees its first key. Key rows at or
// past kv_len get exact-zero dk and dv, and their K/V rows are never
// read. Each visible (query, key) pair costs 14 D FLOP (s and dp in both
// launches, then dq, dk and dv) against the rows of six (B, H, S, D)
// tensors, so the work per byte grows with the sequence: operations
// bound every instance at the train step's 1024 tokens.
//
// The fp32 instance: flash_bwd_{dq,dkv}_tc_kernel<D>, every product on
// the TF32 tensor cores as mma.sync m16n8k8 in 3xTF32 (common.cuh
// split_tf32 / mma_3xtf32: x = big + small, three TF32 products a
// product, about 2^-22 relative), K1's fp32 forward's machinery. wgmma's
// tf32 form reads B only K-major, and dQ += dS K (dK += dS^T Q, dV +=
// P^T dO) needs K (Q, dO) with the key (query) index summed over, which
// is MN-major in memory; mma.sync takes any layout its loads build. Its
// bound: 3 x 14 D FLOP a visible pair at 495 TFLOP/s.
// - A block is 4 warps and owns 64 rows (dq: queries; dkv: keys), 16 a
//   warp (the mma's m); its two tiles of them (dq: Q, dO; dkv: K, V)
//   stay in shared memory, and it walks the other side's 32-row tiles
//   (dq: K, V; dkv: Q, dO and their lse and delta) through a 2-stage
//   cp.async ring, the copies of tile t + 1 issued as tile t starts.
//   Rows at or past kv_len (Sq) are zero-filled and never read. Two
//   blocks an SM at D >= 64 (176 and 206 registers at D = 64, no spill
//   at any head dim), three at D <= 32.
// - S, then dP (dkv: S^T = K Q^T, then dP^T = V dO^T), each into four
//   accumulators, one an 8-row slice of the streamed tile; the resident
//   A fragments are split as loaded, once per k step pair for the four
//   slices. Interleaving the two products' k steps (eight chains a
//   warp) took 16 registers more and timed the same.
// - P and dS are formed on the accumulator fragments (a row's lse and
//   delta in the lane's registers for dq; for dkv a column's from the
//   stage's rows), and then dQ += dS K (dV += P^T dO, dK += dS^T Q) takes
//   the accumulator as its A fragment directly, split (big + small: a
//   single TF32 P or dS misses the fp32 contract,
//   tests/test_torch_tf32_bwd.py): the accumulator's lane (g, t) holds
//   columns 2t and 2t + 1 of each 8-column slice, which are A's columns
//   t and t + 4, so B reads the streamed tile's rows 2t and 2t + 1 of
//   the slice in that order (K1's P V trick). Those rows are permuted
//   within each slice (tc_perm) so that one row pitch, 8 mod 32 floats,
//   keeps both the S loads and these loads free of bank conflicts.
// - The heaviest causal tiles run first (dq: the grid's y reversed; dkv:
//   the first key tiles), a tile past the block's diagonal is never
//   loaded, a warp skips a tile none of its rows sees, and only a tile
//   that crosses kv_len, Sq or the warp's diagonal tests each pair.
//
// The bf16 and float16 instances: flash_bwd_wg_kernel<D, T, kDkv>, on
// Hopper's 16-bit tensor cores (989 TFLOP/s), the design of K1-bf16
// (flash_attention.cu) with the roles of the two launches:
// - Tiles by TMA. Per call, 4-d tensor maps (D, S, H, B) of the strided
//   views of q, k, v and dO (common.cuh tensor_map_rows: 128/64/32-byte
//   swizzle by head dim, the layout wgmma reads); the K and V maps end
//   at kv_len, so rows at or past it arrive as zeros and are never read.
//   The dkv launch's lse and delta rows come through 1-d maps of the
//   flat (B H Sq) arrays, each box from a 16-byte aligned start.
// - A block is one warpgroup and owns one 64-row tile (dq: Q and dO;
//   dkv: K and V), resident in shared memory; it walks the other side's
//   tiles (dq: K/V; dkv: Q/dO) in order through a ring of two TMA stages,
//   refilled as each is released. An SM holds several such blocks (four
//   dq or three dkv blocks at D <= 64, two at D = 128), which overlap
//   each other's chains, loads and epilogues: one warpgroup a block
//   timed 1.4x faster for the pair at the train shape than blocks of two
//   or three warpgroups splitting a tile's walk and summing in shared
//   memory (scripts/torch_kernel_ab.py, PERF.md). dq's heaviest causal q-tiles
//   run first (the grid's y reversed), as do dkv's (the first key tiles,
//   seen by the most queries); a tile the mask hides entirely is never
//   loaded.
// - Every product is a form K1-bf16 runs, wgmma m64nNk16 with fp32
//   accumulation. S = Q K^T and dP = dO V^T (dkv: S^T = K Q^T and
//   dP^T = V dO^T) read both operands from shared memory, K-major;
//   16-bit x 16-bit is exact in fp32, so S and dP are the fp32 products
//   of the widened inputs up to the order of the sums. dQ += dS K
//   (dkv: dV += P^T dO, dK += dS^T Q) take the score accumulator as the
//   A fragment (its layout is the fragment's) and K (dO, Q) as an
//   MN-major B (the transpose bit).
// - P and dS are fp32 values where the reference keeps fp32, so each is
//   split as hi = T(x), lo = T(x - hi) and both parts run through one
//   accumulator (K1-bf16's P split): within about 2^-16 (bf16) of the
//   fp32 product. tests/test_torch_flash_bwd_wg.py emulates it.
// - Float16's range: P <= 1 keeps K1-f16's argument, but dS scales with
//   dO and at a training step's dO (a mean over the batch) sits near or
//   below float16's smallest normal, 2^-14, where hi loses bits and
//   below 2^-24 vanishes. So dS takes a power-of-two scale per
//   accumulator row (dq: a query row; dkv: a key row): each tile's row
//   max |dS| sets an exponent that brings it to [2^13, 2^14), the row
//   keeps the smallest exponent seen so far (a running min, as the
//   softmax's running max), its accumulator is rescaled by the power of
//   two when that exponent falls, and the fp32 sum is scaled back at the
//   end. Power-of-two rescales are exact in fp32. bf16 has fp32's
//   exponent range and takes no scale.
// - Bound and chain: the dq launch runs 4 products a tile pair (S, dP,
//   dS_hi K, dS_lo K), the dkv launch 6; each tile is a chain (products,
//   then the elementwise P/dS, then the products). Registers and shared
//   memory set the blocks an SM holds: dkv keeps S^T, dP^T, dV and dK
//   (32 + 32 + D / 2 + D / 2 a thread) and two fragment sets (167
//   registers at D = 64: three blocks, at most 168 registers each), dq
//   one gradient accumulator (122: four blocks, whose 50 KB of stages
//   and tiles fit four times). At three dkv blocks ptxas serializes the
//   bf16 instance's products for want of registers (C7512, printed by
//   chip_smoke.py's build phase), and that instance still timed 7 %
//   faster than at two blocks without the warning (in turns in one call;
//   the float16 instance, not serialized, timed the same). At the
//   train shape the tensor cores are busy about a third of the time:
//   the chains, not the loads, set it (a third ring stage changed
//   nothing), and starting P while dP still ran (two commit groups)
//   spilled, made ptxas serialize the products for want of registers
//   (C7512) and timed 4 % slower.
// - ptxas serializes wgmma in a branch it takes as divergent (C7520: the
//   warp index goes through a shuffle) and when another instruction
//   writes an accumulator while a product is in flight (C7515: each
//   tile's products are waited for before the elementwise work and the
//   float16 rescale touch their registers).
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;   // own rows of a block (queries or keys)

// The (b, h, s) element strides of q, k, v, out and dO, in that order.
struct Strides {
  long long q[3], k[3], v[3], o[3], d[3];
};

// ---- the fp32 instance: mma.sync TF32 in 3xTF32 ---------------------------
constexpr int kTcWarps = kTile / 16;       // a warp owns 16 rows (mma m)
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcSub = 32;                 // streamed rows a stage
constexpr int kTcSlices = kTcSub / 8;      // 8-row slices (mma n) of it
constexpr int kTcStages = 2;               // the cp.async ring
// Blocks an SM: shared memory holds three at D <= 64, but at three (168
// registers a thread) D = 64 spilled, and its pair timed the same as at
// two (scripts/torch_kernel_ab.py)
template <int D>
constexpr int kTcBlocks = D <= 32 ? 3 : 2;
constexpr float kTcLog2e = 1.4426950408889634f;

// Shared memory of a block: its own two tiles (dq: Q, dO; dkv: K, V),
// then kTcStages stages of the other side's two tiles (dq: K, V; dkv: Q,
// dO), each followed by its rows' lse and delta (dkv); every row padded
// to 8 mod 32 floats (see the row permutation below; the own tiles'
// A loads take a 2-way bank conflict at that pitch, and padding them to
// 16 mod 32 with a third stage timed the same). 74 KB at D = 64.
template <int D>
struct TcSmem {
  static_assert(D % 16 == 0, "head dims are multiples of 16");
  static constexpr int kPad = (D + 8) % 32 == 8 ? D + 8 : D + 24;
  static constexpr int kOwn = kTile * kPad;
  static constexpr int kRing = kTcSub * kPad;
  static constexpr int kStage = 2 * kRing + 2 * kTcSub;
  static constexpr size_t kBytes =
      (2 * kOwn + kTcStages * kStage) * sizeof(float);
};

// The streamed rows' order inside an 8-row slice: the mma's n column g
// of S (S^T) is row perm(g), so the accumulator entries 2t and 2t + 1 of
// a lane are rows perm(2t) = t and perm(2t + 1) = 4 + (t + 2) % 4, and
// those are the rows the lane's B fragment of the second product reads.
// With rows 8 mod 32 floats apart both loads are conflict-free: a
// quarter warp's S loads (rows perm(g), perm(g + 1) at 4 chunks) and its
// second-product loads (rows perm(2t) or perm(2t + 1) at chunks g, g + 1)
// each land on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int tc_perm(int g) {
  return (g & 1) ? 4 + (((g >> 1) + 2) & 3) : g >> 1;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + n) of one (b, h) slice of a view with row stride
// ``st`` into ``dst`` (row pitch P floats) by cp.async; rows at or past
// ``rows`` are zero-filled and never read.
template <int D, int P>
__device__ __forceinline__ void tc_rows_async(float* dst, const float* base,
                                              long long st, int row0, int n,
                                              int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const bool live = row0 + r < rows;
    mxtt::cp_async16(dst + r * P + c,
                     base + (long long)(live ? row0 + r : 0) * st + c, live);
  }
}

// s[j] = A B^T over the head dim, for the warp's 16 own rows (A: rows g
// and g + 8) against the kTcSub streamed rows (B; slice j's column g is
// row 8 j + tc_perm(g)), rows P floats apart. Over a pair of k steps a
// lane's A and B fragments are the head dims 16 c + 4 t .. + 3 of its
// rows, one 16-byte load each; the A fragments are split once for the
// slices.
template <int D, int P>
__device__ __forceinline__ void tc_product(const float* A, const float* B,
                                           int g, int t,
                                           float (&s)[kTcSlices][4]) {
  const int pg = tc_perm(g);
#pragma unroll
  for (int j = 0; j < kTcSlices; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    unsigned ab[2][4], as[2][4];
    const float4 lo = lds4(A + g * P + 16 * c + 4 * t);
    const float4 hi = lds4(A + (g + 8) * P + 16 * c + 4 * t);
    mxtt::split_tf32(lo.x, ab[0][0], as[0][0]);
    mxtt::split_tf32(hi.x, ab[0][1], as[0][1]);
    mxtt::split_tf32(lo.y, ab[0][2], as[0][2]);
    mxtt::split_tf32(hi.y, ab[0][3], as[0][3]);
    mxtt::split_tf32(lo.z, ab[1][0], as[1][0]);
    mxtt::split_tf32(hi.z, ab[1][1], as[1][1]);
    mxtt::split_tf32(lo.w, ab[1][2], as[1][2]);
    mxtt::split_tf32(hi.w, ab[1][3], as[1][3]);
#pragma unroll
    for (int j = 0; j < kTcSlices; ++j) {
      const float4 x = lds4(B + (8 * j + pg) * P + 16 * c + 4 * t);
      unsigned xb[2][2], xs[2][2];
      mxtt::split_tf32(x.x, xb[0][0], xs[0][0]);
      mxtt::split_tf32(x.y, xb[0][1], xs[0][1]);
      mxtt::split_tf32(x.z, xb[1][0], xs[1][0]);
      mxtt::split_tf32(x.w, xb[1][1], xs[1][1]);
      mxtt::mma_3xtf32(s[j], ab[0], as[0], xb[0], xs[0]);
      mxtt::mma_3xtf32(s[j], ab[1], as[1], xb[1], xs[1]);
    }
  }
}

// The A fragment of slice j's 16 x 8 block of an accumulator (its k
// index t is the slice's row perm(2t), t + 4 row perm(2t + 1): the
// accumulator's own entries), split.
__device__ __forceinline__ void tc_acc_frag(const float (&x)[4],
                                            unsigned (&big)[4],
                                            unsigned (&small)[4]) {
  mxtt::split_tf32(x[0], big[0], small[0]);
  mxtt::split_tf32(x[2], big[1], small[1]);
  mxtt::split_tf32(x[1], big[2], small[2]);
  mxtt::split_tf32(x[3], big[3], small[3]);
}

// acc[n] (n tile n of the head dim) += A (split, 16 x 8) times rows
// perm(2t) and perm(2t + 1) of slice j of the streamed tile X (rows P
// floats apart). B's column g of n tile VEC c + r is head dim
// 8 VEC c + VEC g + r: one 16-byte load of each row per 4 n tiles
// (8 bytes per 2 at D = 16).
template <int D, int P>
__device__ __forceinline__ void tc_grad(float (&acc)[D / 8][4],
                                        const unsigned (&ab)[4],
                                        const unsigned (&as)[4],
                                        const float* X, int j, int g,
                                        int t) {
  constexpr int VEC = D >= 32 ? 4 : 2;
  const float* r0 = X + (8 * j + t) * P + VEC * g;
  const float* r1 = X + (8 * j + 4 + ((t + 2) & 3)) * P + VEC * g;
#pragma unroll
  for (int c = 0; c < D / (8 * VEC); ++c) {
    float x0[VEC], x1[VEC];
    if constexpr (VEC == 4) {
      const float4 u = lds4(r0 + 32 * c), w = lds4(r1 + 32 * c);
      x0[0] = u.x; x0[1] = u.y; x0[2] = u.z; x0[3] = u.w;
      x1[0] = w.x; x1[1] = w.y; x1[2] = w.z; x1[3] = w.w;
    } else {
      const float2 u = *reinterpret_cast<const float2*>(r0 + 16 * c);
      const float2 w = *reinterpret_cast<const float2*>(r1 + 16 * c);
      x0[0] = u.x; x0[1] = u.y;
      x1[0] = w.x; x1[1] = w.y;
    }
#pragma unroll
    for (int r = 0; r < VEC; ++r) {
      unsigned bb[2], bs[2];
      mxtt::split_tf32(x0[r], bb[0], bs[0]);
      mxtt::split_tf32(x1[r], bb[1], bs[1]);
      mxtt::mma_3xtf32(acc[VEC * c + r], ab, as, bb, bs);
    }
  }
}

// Rows row0 (half 0) and row0 + 8 (half 1) of a contiguous (rows, D)
// gradient from acc (entry [2 half + e] of n tile VEC c + r is head dim
// 8 VEC c + VEC (2 t + e) + r); ``live[half]`` false writes zeros.
template <int D>
__device__ __forceinline__ void tc_store(float* base,
                                         const float (&acc)[D / 8][4],
                                         int row0, int n_rows,
                                         const bool (&live)[2], int t) {
  constexpr int VEC = D >= 32 ? 4 : 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= n_rows) continue;
    float* dst = base + (long long)row * D;
#pragma unroll
    for (int c = 0; c < D / (8 * VEC); ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[VEC];
#pragma unroll
        for (int r = 0; r < VEC; ++r)
          v[r] = live[half] ? acc[VEC * c + r][2 * half + e] : 0.f;
        float* p = dst + 8 * VEC * c + VEC * (2 * t + e);
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        else
          *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kTcBlocks<D>)
    flash_bwd_dq_tc_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ dq, float* __restrict__ delta,
                           int H, int Sq, int kv_len, int causal,
                           float scale, Strides st) {
  using S = TcSmem<D>;
  constexpr int P = S::kPad;
  extern __shared__ float4 tc_smem4[];
  float* const own = reinterpret_cast<float*>(tc_smem4);   // Q, dO
  float* const ring = own + 2 * S::kOwn;                   // K, V stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // heaviest causal q-tile first
  const int r0 =
      (causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y) *
      kTile;
  const int offset = kv_len - Sq;
  const long long rows = (long long)bh * Sq;   // lse, delta, dq
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* ob = o + b * st.o[0] + h * st.o[1];
  const float* db = dout + b * st.d[0] + h * st.d[1];
  // the last key a row of the block (of the warp) sees
  const int w0 = r0 + 16 * warp;
  int last = kv_len - 1, warp_last = kv_len - 1;
  if (causal) {
    last = min(last, r0 + kTile - 1 + offset);
    warp_last = min(warp_last, w0 + 15 + offset);
  }
  const int n_tiles = last < 0 ? 0 : last / kTcSub + 1;

  auto load_ring = [&](int tile) {
    float* s = ring + (tile % kTcStages) * S::kStage;
    tc_rows_async<D, P>(s, kb, st.k[2], tile * kTcSub, kTcSub, kv_len);
    tc_rows_async<D, P>(s + S::kRing, vb, st.v[2], tile * kTcSub, kTcSub,
                         kv_len);
  };
  // copy group 0: Q, dO and ring tile 0; then one group a ring tile
  tc_rows_async<D, P>(own, qb, st.q[2], r0, kTile, Sq);
  tc_rows_async<D, P>(own + S::kOwn, db, st.d[2], r0, kTile, Sq);
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < n_tiles) load_ring(i);
    mxtt::cp_async_commit();
  }

  // the lane's rows g and g + 8 of its warp: delta = sum_d dO * out (a
  // quad's four lanes a quarter of the head dim each; written for the
  // dkv launch) and -lse log2(e)
  const int row0 = w0 + g;
  float nl[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    float acc = 0.f;
    if (row < Sq) {
      const float* dr = db + (long long)row * st.d[2] + t * (D / 4);
      const float* orow = ob + (long long)row * st.o[2] + t * (D / 4);
#pragma unroll
      for (int e = 0; e < D / 4; e += 4)
        acc = mxtt::dot4(mxtt::load4(dr + e), mxtt::load4(orow + e), acc);
    }
    acc += __shfl_xor_sync(mxtt::kFullMask, acc, 1);
    acc += __shfl_xor_sync(mxtt::kFullMask, acc, 2);
    dl[half] = acc;
    nl[half] = row < Sq ? -lse[rows + row] * kTcLog2e : 0.f;
    if (t == 0 && row < Sq) delta[rows + row] = acc;
  }
  const float qscale = scale * kTcLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    mxtt::cp_async_wait<kTcStages - 2>();   // this thread's copies of it
    __syncthreads();   // everyone's; and the stage refilled below is free
    if (tile + kTcStages - 1 < n_tiles) load_ring(tile + kTcStages - 1);
    mxtt::cp_async_commit();
    const int k0 = tile * kTcSub;
    // none of the warp's rows sees it (or exists)
    if (k0 > warp_last || w0 >= Sq) continue;
    const float* ks = ring + (tile % kTcStages) * S::kStage;
    const float* vs = ks + S::kRing;
    float s[kTcSlices][4], dp[kTcSlices][4];
    tc_product<D, P>(own + 16 * warp * P, ks, g, t, s);
    tc_product<D, P>(own + S::kOwn + 16 * warp * P, vs, g, t, dp);
    // P and dS on the fragments: entry [2 half + e] of slice j is row
    // row0 + 8 half, key k0 + 8 j + perm(2 t + e). Only a tile that
    // crosses kv_len, Sq or the warp's diagonal tests each pair.
    const bool edge = k0 + kTcSub > kv_len || w0 + 16 > Sq ||
                      (causal && k0 + kTcSub - 1 > w0 + offset);
#pragma unroll
    for (int j = 0; j < kTcSlices; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + (e ? 4 + ((t + 2) & 3) : t);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half, x = 2 * half + e;
          const bool valid = !edge || (key < kv_len && row < Sq &&
                                       (!causal || key <= row + offset));
          const float p = valid
              ? mxtt::exp2_ftz(fmaf(s[j][x], qscale, nl[half])) : 0.f;
          dp[j][x] = p * (dp[j][x] - dl[half]) * scale;
        }
      }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < kTcSlices; ++j) {
      unsigned ab[4], as[4];
      tc_acc_frag(dp[j], ab, as);
      tc_grad<D, P>(acc, ab, as, ks, j, g, t);
    }
  }
  mxtt::cp_async_wait<0>();
  const bool live[2] = {true, true};
  tc_store<D>(dq + rows * D, acc, row0, Sq, live, t);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kTcBlocks<D>)
    flash_bwd_dkv_tc_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int Sq, int Sk, int kv_len, int causal,
                            float scale, Strides st) {
  using S = TcSmem<D>;
  constexpr int P = S::kPad;
  extern __shared__ float4 tc_smem4[];
  float* const own = reinterpret_cast<float*>(tc_smem4);   // K, V
  float* const ring = own + 2 * S::kOwn;   // Q, dO, lse, delta stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int r0 = (int)blockIdx.y * kTile;   // the first key tiles are the
                                            // heaviest, and run first
  const int offset = kv_len - Sq;
  const long long rows = (long long)bh * Sq;   // lse and delta
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* db = dout + b * st.d[0] + h * st.d[1];
  // the query tiles walked: from the first holding a row that sees key
  // r0 (causal) to Sq; none when the block's keys are all at or past
  // kv_len
  const int t_first = causal ? max(0, r0 - offset) / kTcSub : 0;
  const int n_tiles =
      r0 < kv_len ? max(0, (Sq + kTcSub - 1) / kTcSub - t_first) : 0;
  const int w0 = r0 + 16 * warp;   // the warp's first key

  auto load_ring = [&](int tile) {
    float* s = ring + (tile % kTcStages) * S::kStage;
    const int q0 = (t_first + tile) * kTcSub;
    tc_rows_async<D, P>(s, qb, st.q[2], q0, kTcSub, Sq);
    tc_rows_async<D, P>(s + S::kRing, db, st.d[2], q0, kTcSub, Sq);
    for (int i = tid; i < 2 * kTcSub; i += kTcThreads) {
      const int r = i % kTcSub;
      const bool live = q0 + r < Sq;
      mxtt::cp_async4(s + 2 * S::kRing + i,
                      (i < kTcSub ? lse : delta) + rows + (live ? q0 + r : 0),
                      live);
    }
  };
  if (n_tiles > 0) {
    tc_rows_async<D, P>(own, kb, st.k[2], r0, kTile, kv_len);
    tc_rows_async<D, P>(own + S::kOwn, vb, st.v[2], r0, kTile, kv_len);
  }
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < n_tiles) load_ring(i);
    mxtt::cp_async_commit();
  }
  const float qscale = scale * kTcLog2e;
  const int key0 = w0 + g;   // the lane's keys: key0 and key0 + 8

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    mxtt::cp_async_wait<kTcStages - 2>();
    __syncthreads();
    if (tile + kTcStages - 1 < n_tiles) load_ring(tile + kTcStages - 1);
    mxtt::cp_async_commit();
    const int q0 = (t_first + tile) * kTcSub;
    // the warp's keys are all dead, or no query of the tile sees them
    if (w0 >= kv_len || (causal && w0 > q0 + kTcSub - 1 + offset)) continue;
    const float* qs = ring + (tile % kTcStages) * S::kStage;
    const float* dos = qs + S::kRing;
    const float* ls = dos + S::kRing;   // lse, then delta
    // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys, columns
    // the tile's queries
    float s[kTcSlices][4], dp[kTcSlices][4];
    tc_product<D, P>(own + 16 * warp * P, qs, g, t, s);
    tc_product<D, P>(own + S::kOwn + 16 * warp * P, dos, g, t, dp);
    const bool edge = w0 + 16 > kv_len || q0 + kTcSub > Sq ||
                      (causal && w0 + 15 > q0 + offset);
#pragma unroll
    for (int j = 0; j < kTcSlices; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + (e ? 4 + ((t + 2) & 3) : t);
        const int qr = q0 + col;
        const float nlc = -ls[col] * kTcLog2e, dlc = ls[kTcSub + col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = key0 + 8 * half, x = 2 * half + e;
          const bool valid = !edge || (key < kv_len && qr < Sq &&
                                       (!causal || key <= qr + offset));
          const float p =
              valid ? mxtt::exp2_ftz(fmaf(s[j][x], qscale, nlc)) : 0.f;
          s[j][x] = p;
          dp[j][x] = p * (dp[j][x] - dlc) * scale;
        }
      }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < kTcSlices; ++j) {
      unsigned pb[4], ps[4], sb[4], ss[4];
      tc_acc_frag(s[j], pb, ps);
      tc_acc_frag(dp[j], sb, ss);
      tc_grad<D, P>(dva, pb, ps, dos, j, g, t);
      tc_grad<D, P>(dka, sb, ss, qs, j, g, t);
    }
  }
  mxtt::cp_async_wait<0>();
  // key rows past kv_len: exact zeros
  const bool live[2] = {key0 < kv_len, key0 + 8 < kv_len};
  const long long krows = (long long)bh * Sk;
  tc_store<D>(dk + krows * D, dka, key0, Sk, live, t);
  tc_store<D>(dv + krows * D, dva, key0, Sk, live, t);
}

// ---- the 16-bit instances: wgmma on tiles brought by TMA ------------------
constexpr int kWgRows = 64;   // rows of every tile (the wgmma m, and S's n)
constexpr float kLog2e = 1.4426950408889634f;
// float16's dS scale: a row max |dS| in [2^(b - 127), 2^(b - 126)) (b its
// biased fp32 exponent) takes 2^(kScaleTop - b), into [2^13, 2^14); a
// row whose dS is all below 2^-51 keeps the start, 2^kScaleMax
constexpr int kScaleTop = 140;
constexpr int kScaleMax = 64;
// dkv's lse and delta rows arrive as TMA boxes of kRowBox values from a
// 16-byte aligned start, the row's own start 0-3 values in
constexpr int kRowBox = kWgRows + 4;

// A block is one warpgroup. The blocks an SM holds, by launch and head dim
// (registers and shared memory; see the note above).
template <int D, bool kDkv>
constexpr int kWgBlocks = D > 64 ? 2 : (kDkv ? 3 : 4);

// Shared memory of a block: its own two tiles (dq: Q, dO; dkv: K, V), a
// ring of two stages of the other side's two tiles (dq: K, V; dkv:
// Q, dO), then fp32 rows (dq: the block's lse and delta; dkv: each
// stage's lse and delta), then the mbarriers.
template <int D, bool kDkv>
struct WgSmem {
  static constexpr int kThreads = 128;
  static constexpr int kStages = 2;   // a third timed the same
  static constexpr int kSwizzle = D * 2 >= 128 ? 128 : D * 2;  // bytes
  static constexpr int kBoxD = kSwizzle / 2;   // head dims of a TMA box
  static constexpr int kParts = D / kBoxD;     // boxes across a row
  static constexpr int kPart = kWgRows * kSwizzle;   // bytes of a box
  static constexpr int kTile = kParts * kPart;       // bytes of 64 rows
  static constexpr int kRing = 2 * kTile;
  static constexpr int kStage = 2 * kTile;
  // a slot for an fp32 row (lse or delta; dkv's a TMA box of kRowBox)
  static constexpr int kRowBytes = 512;
  static constexpr int kRowFloats = kRowBytes / 4;
  static constexpr int kRows = kRing + kStages * kStage;
  static constexpr int kNumRows = kDkv ? 2 * kStages : 2;
  static constexpr int kBars = kRows + kNumRows * kRowBytes;
  static constexpr int kNumBars = 1 + 2 * kStages;   // own, full, empty
  // + slack to align the base to the 128-byte swizzle's 1024 bytes
  static constexpr size_t kBytes = kBars + 8 * kNumBars + 1024;
  static constexpr int kAccs = kDkv ? 2 : 1;         // dq; dv and dk
  static_assert(kWgBlocks<D, kDkv> * (kBytes + 1024) <= 233472,
                "the blocks fit an SM");
};

// 2^n for an integer n in [-126, 127], exactly
__device__ __forceinline__ float pow2i(int n) {
  return __uint_as_float((unsigned)(n + 127) << 23);
}

// The exponent that brings a row max m >= 0 into [2^13, 2^14), at most
// kScaleMax (m = 0 or below 2^-51)
__device__ __forceinline__ int scale_exponent(float m) {
  const int be = (__float_as_uint(m) >> 23) & 0xff;
  return be == 0 ? kScaleMax : min(kScaleMax, kScaleTop - be);
}

// The kernel's data beyond the tensor maps. dq: ``o`` and ``dout`` (read
// for delta, through their strides), lse (read), delta (written), g0 =
// dq. dkv: g0 = dv, g1 = dk.
template <class T>
struct WgArgs {
  const T* o;
  const T* dout;
  const float* lse;
  float* delta;
  T* g0;
  T* g1;
  long long o_st[3], d_st[3];
  int H, Sq, Sk, kv_len, causal;
  float scale;
};

template <int D, class T, bool kDkv>
__global__ void __launch_bounds__(WgSmem<D, kDkv>::kThreads,
                                  kWgBlocks<D, kDkv>)
flash_bwd_wg_kernel(const __grid_constant__ CUtensorMap own0_map,
                    const __grid_constant__ CUtensorMap own1_map,
                    const __grid_constant__ CUtensorMap ring0_map,
                    const __grid_constant__ CUtensorMap ring1_map,
                    const __grid_constant__ CUtensorMap lse_map,
                    const __grid_constant__ CUtensorMap delta_map,
                    const WgArgs<T> a) {
  using S = WgSmem<D, kDkv>;
  constexpr int kStages = S::kStages;
  constexpr int kSteps = D / 16;                   // k steps of S and dP
  constexpr int kStepsPerBox = S::kSwizzle / 32;   // of them in one box
  constexpr int kN = D < 64 ? D : 64;              // n of one RS product
  constexpr int kNC = D / kN;                      // RS products a k step
  constexpr int kRSteps = kWgRows / 16;            // k steps of an RS one
  constexpr unsigned kSbo = 8 * S::kSwizzle;       // 8-row group stride
  constexpr bool kScaleDs = std::is_same_v<T, mxtt::f16>;
  constexpr int kDs = kDkv ? 1 : 0;   // the accumulator dS feeds (dk, dq)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = mxtt::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const unsigned sbase = mxtt::smem_addr(smem);
  const unsigned bar_own = sbase + S::kBars;
  auto bar_full = [&](int st) { return bar_own + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_own + 8 * (1 + kStages + st); };
  float* const rows_s = reinterpret_cast<float*>(smem + S::kRows);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int Sq = a.Sq, kv_len = a.kv_len, causal = a.causal;
  const int offset = kv_len - Sq;
  // The block's 64 rows (dq: queries, heaviest causal tile first; dkv:
  // keys, whose first tiles are the heaviest) and the other side's tiles
  // it walks: t_first + t for t < n_tiles.
  int r0, t_first, n_tiles;
  if constexpr (!kDkv) {
    r0 = (causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y) *
         kWgRows;
    int last = kv_len - 1;   // the last key a row of the block sees
    if (causal) last = min(last, r0 + kWgRows - 1 + offset);
    t_first = 0;
    n_tiles = last < 0 ? 0 : last / kWgRows + 1;
  } else {
    r0 = (int)blockIdx.y * kWgRows;
    // the first query tile holding a row that sees key r0
    t_first = causal ? max(0, r0 - offset) / kWgRows : 0;
    n_tiles = r0 < kv_len ? (Sq + kWgRows - 1) / kWgRows - t_first : 0;
  }

  // Thread 0 sets up the mbarriers and starts the copies of the block's
  // own tiles and its first kStages ring tiles; it refills a stage with
  // tile t + kStages once the four warps have released tile t.
  auto load_ring = [&](int t) {
    const int st = t % kStages;
    const int row = (t_first + t) * kWgRows;
    unsigned char* dst = smem + S::kRing + st * S::kStage;
    mxtt::mbar_arrive_expect_tx(
        bar_full(st), 2 * S::kTile + (kDkv ? 2 * kRowBox * 4 : 0));
    for (int p = 0; p < S::kParts; ++p) {
      mxtt::tma_load_4d(dst + p * S::kPart, &ring0_map, p * S::kBoxD, row, h,
                        b, bar_full(st));
      mxtt::tma_load_4d(dst + S::kTile + p * S::kPart, &ring1_map,
                        p * S::kBoxD, row, h, b, bar_full(st));
    }
    if constexpr (kDkv) {
      // a box must start on 16 bytes: from row's start rounded down
      float* rs = rows_s + 2 * S::kRowFloats * st;
      const int at = (bh * Sq + row) & ~3;
      mxtt::tma_load_1d(rs, &lse_map, at, bar_full(st));
      mxtt::tma_load_1d(rs + S::kRowFloats, &delta_map, at, bar_full(st));
    }
  };
  if (tid == 0) {
    mxtt::prefetch_tensormap(&own0_map);
    mxtt::prefetch_tensormap(&own1_map);
    mxtt::prefetch_tensormap(&ring0_map);
    mxtt::prefetch_tensormap(&ring1_map);
    if constexpr (kDkv) {
      mxtt::prefetch_tensormap(&lse_map);
      mxtt::prefetch_tensormap(&delta_map);
    }
    // own, full (one arrival each), empty (the four warps)
    for (int i = 0; i < S::kNumBars; ++i)
      mxtt::mbar_init(bar_own + 8 * i, i <= kStages ? 1 : 4, false);
    mxtt::mbar_init_fence();
    if (n_tiles > 0) {
      mxtt::mbar_arrive_expect_tx(bar_own, 2 * S::kTile);
      for (int p = 0; p < S::kParts; ++p) {
        mxtt::tma_load_4d(smem + p * S::kPart, &own0_map, p * S::kBoxD, r0,
                          h, b, bar_own);
        mxtt::tma_load_4d(smem + S::kTile + p * S::kPart, &own1_map,
                          p * S::kBoxD, r0, h, b, bar_own);
      }
      for (int t = 0; t < min(n_tiles, kStages); ++t) load_ring(t);
    }
  }
  if constexpr (!kDkv) {
    // delta = sum_d dO * out for the block's rows, kLanes lanes a row
    // (written for the dkv launch), and their lse
    constexpr int kLanes = D / 4 < 8 ? D / 4 : 8;
    constexpr int kPer = D / kLanes;   // elements a lane, 4 to 16
    const long long rbase = (long long)bh * Sq;
    for (int i = tid; i < kWgRows * kLanes; i += S::kThreads) {
      const int r = i / kLanes, c = (i % kLanes) * kPer, gr = r0 + r;
      float acc = 0.f;
      if (gr < Sq) {
        const T* dp = a.dout + b * a.d_st[0] + h * a.d_st[1] +
                      (long long)gr * a.d_st[2] + c;
        const T* op = a.o + b * a.o_st[0] + h * a.o_st[1] +
                      (long long)gr * a.o_st[2] + c;
#pragma unroll
        for (int e = 0; e < kPer; e += 4) {
          const float4 x =
              mxtt::half4_widen<T>(*reinterpret_cast<const uint2*>(dp + e));
          const float4 y =
              mxtt::half4_widen<T>(*reinterpret_cast<const uint2*>(op + e));
          acc = mxtt::dot4(x, y, acc);
        }
      }
#pragma unroll
      for (int sh = 1; sh < kLanes; sh <<= 1)
        acc += __shfl_xor_sync(mxtt::kFullMask, acc, sh);
      if (i % kLanes == 0) {
        rows_s[S::kRowFloats + r] = acc;
        rows_s[r] = gr < Sq ? a.lse[rbase + gr] : 0.f;
        if (gr < Sq) a.delta[rbase + gr] = acc;
      }
    }
  }
  __syncthreads();

  // the warp index, made warp-uniform for the compiler (a shuffle from
  // lane 0): in a branch it must take as divergent ptxas serializes wgmma
  const int warp = __shfl_sync(mxtt::kFullMask, tid >> 5, 0);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // this lane's accumulator rows of the block's tile: g and g + 8 of its
  // warp's 16 (dq: query rows; dkv: keys)
  const int row0 = r0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float qscale = a.scale * kLog2e;
  // dq: the rows' -lse log2(e) and delta
  float nl0 = 0.f, nl1 = 0.f, dl0 = 0.f, dl1 = 0.f;
  if constexpr (!kDkv) {
    nl0 = -rows_s[row0 - r0] * kLog2e;
    nl1 = -rows_s[row1 - r0] * kLog2e;
    dl0 = rows_s[S::kRowFloats + row0 - r0];
    dl1 = rows_s[S::kRowFloats + row1 - r0];
  }

  // Accumulators, entry [4 i + e] of row g (e < 2) or g + 8, column 8 i +
  // 2 t + e % 2: acc[x][c] the gradient's head dims 64 c .. (dq: dq; dkv:
  // dv, dk), s and dp the tile's scores and dP (columns: the other
  // side's rows). Then P and dS, split in hi + lo as the A fragments of
  // the RS products' k steps (register r of step j: entries 8 j + 2 r,
  // + 1).
  float acc[S::kAccs][kNC][kN / 2];
#pragma unroll
  for (int x = 0; x < S::kAccs; ++x)
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[x][c][i] = 0.f;
  float s[kWgRows / 2], dp[kWgRows / 2];
#pragma unroll
  for (int i = 0; i < kWgRows / 2; ++i) s[i] = dp[i] = 0.f;
  unsigned ph[kRSteps][4], pl[kRSteps][4];
  // float16: the exponents of the rows of acc[kDs] (a running min)
  int ex0 = kScaleMax, ex1 = kScaleMax;

  // S = own0 ring0^T into s, dP = own1 ring1^T into dp (started)
  auto start_scores = [&](int st) {
    const unsigned u = sbase + S::kRing + st * S::kStage;
    mxtt::wgmma_fence_operand(s);
    mxtt::wgmma_fence_operand(dp);
    mxtt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const unsigned off =
          (j / kStepsPerBox) * S::kPart + (j % kStepsPerBox) * 32;
      mxtt::wgmma_ss_n64<T>(
          s, mxtt::wgmma_desc<S::kSwizzle>(sbase + off, 16, kSbo),
          mxtt::wgmma_desc<S::kSwizzle>(u + off, 16, kSbo), j > 0);
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const unsigned off =
          (j / kStepsPerBox) * S::kPart + (j % kStepsPerBox) * 32;
      mxtt::wgmma_ss_n64<T>(
          dp, mxtt::wgmma_desc<S::kSwizzle>(sbase + S::kTile + off, 16, kSbo),
          mxtt::wgmma_desc<S::kSwizzle>(u + S::kTile + off, 16, kSbo), j > 0);
    }
    mxtt::wgmma_commit();
  };
  // d += (hi + lo) B over the tile's 64 rows of B (a ring tile at byte
  // ``b_tile``, MN-major: the transpose bit), started, not committed
  auto start_rs = [&](float (&d)[kNC][kN / 2], const unsigned (&hi)[4][4],
                      const unsigned (&lo)[4][4], unsigned b_tile) {
#pragma unroll
    for (int c = 0; c < kNC; ++c) mxtt::wgmma_fence_operand(d[c]);
    mxtt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kRSteps; ++j)
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const uint64_t db = mxtt::wgmma_desc<S::kSwizzle>(
            b_tile + c * S::kPart + j * 16 * S::kSwizzle, S::kPart, kSbo);
        mxtt::wgmma_rs<kN, T>(d[c], hi[j], db);
        mxtt::wgmma_rs<kN, T>(d[c], lo[j], db);
      }
  };
  auto split = [&](const float (&x)[kWgRows / 2], unsigned (&hi)[4][4],
                   unsigned (&lo)[4][4]) {
#pragma unroll
    for (int j = 0; j < kRSteps; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mxtt::split_pair<T>(x[8 * j + 2 * r], x[8 * j + 2 * r + 1],
                            hi[j][r], lo[j][r]);
  };
  // P into s and dS into dp for local tile t (in stage st). Only a tile
  // that crosses kv_len, Sq or the causal diagonal tests each pair.
  auto grads = [&](int t, int st) {
    const int c0 = (t_first + t) * kWgRows;   // the other side's row 0
    // dkv: the stage's lse and delta, from the box's start (c0 is a
    // multiple of 4, so the offset is bh Sq's)
    const float* rs = rows_s + 2 * S::kRowFloats * st + ((bh * Sq) & 3);
    bool edge;
    if constexpr (kDkv)
      edge = r0 + kWgRows > kv_len || c0 + kWgRows > Sq ||
             (causal && r0 + kWgRows - 1 > c0 + offset);
    else
      edge = c0 + kWgRows > kv_len || r0 + kWgRows > Sq ||
             (causal && c0 + kWgRows - 1 > r0 + offset);
#pragma unroll
    for (int i = 0; i < kWgRows / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * i + 2 * t4 + e;
        float nlc = 0.f, dlc = 0.f;
        if constexpr (kDkv) {
          nlc = -rs[8 * i + 2 * t4 + e] * kLog2e;
          dlc = rs[S::kRowFloats + 8 * i + 2 * t4 + e];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = 4 * i + 2 * half + e;
          const int row = half ? row1 : row0;
          const int key = kDkv ? row : col;
          const int qr = kDkv ? col : row;
          const bool valid =
              !edge || (key < kv_len && qr < Sq &&
                        (!causal || key <= qr + offset));
          const float nl = kDkv ? nlc : (half ? nl1 : nl0);
          const float dl = kDkv ? dlc : (half ? dl1 : dl0);
          const float p =
              valid ? mxtt::exp2_ftz(fmaf(s[x], qscale, nl)) : 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - dl) * a.scale;
        }
      }
  };
  // float16: dS's rows to [2^13, 2^14) by a power of two (the running min
  // of the rows' exponents); acc[kDs] follows when an exponent falls
  auto scale_ds = [&]() {
    float m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int i = 0; i < kWgRows / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m0 = fmaxf(m0, fabsf(dp[4 * i + e]));
        m1 = fmaxf(m1, fabsf(dp[4 * i + 2 + e]));
      }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(mxtt::kFullMask, m0, sh));
      m1 = fmaxf(m1, __shfl_xor_sync(mxtt::kFullMask, m1, sh));
    }
    const int n0 = min(ex0, scale_exponent(m0));
    const int n1 = min(ex1, scale_exponent(m1));
    const float f0 = pow2i(max(n0 - ex0, -126));
    const float f1 = pow2i(max(n1 - ex1, -126));
    ex0 = n0;
    ex1 = n1;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        acc[kDs][c][4 * i] *= f0;
        acc[kDs][c][4 * i + 1] *= f0;
        acc[kDs][c][4 * i + 2] *= f1;
        acc[kDs][c][4 * i + 3] *= f1;
      }
    const float u0 = pow2i(ex0), u1 = pow2i(ex1);
#pragma unroll
    for (int i = 0; i < kWgRows / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * i + e] *= u0;
        dp[4 * i + 2 + e] *= u1;
      }
  };
  // tile t's stage is free: each warp arrives; warp 0 waits for the four
  // (the whole warp) and its lane 0 refills the stage with tile
  // t + kStages
  auto release = [&](int t) {
    const int st = t % kStages;
    __syncwarp();
    if (lane == 0) mxtt::mbar_arrive(bar_empty(st));
    if (warp == 0 && t + kStages < n_tiles) {
      mxtt::mbar_wait<false>(bar_empty(st), (t / kStages) & 1);
      if (lane == 0) load_ring(t + kStages);
    }
  };

  // The warpgroup runs its tiles in order: S and dP, then P and dS, then
  // the RS products; the SM's blocks overlap each other's chains.
  if (n_tiles > 0) mxtt::mbar_wait<false>(bar_own, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    mxtt::mbar_wait<false>(bar_full(st), (t / kStages) & 1);
    start_scores(st);
    mxtt::wgmma_wait<0>();
    mxtt::wgmma_fence_operand(s);
    mxtt::wgmma_fence_operand(dp);
    grads(t, st);
    if constexpr (kScaleDs) scale_ds();
    const unsigned ring = sbase + S::kRing + st * S::kStage;
    if constexpr (kDkv) {
      // dV += P^T dO, then dK += dS^T Q (dS split while dV runs)
      split(s, ph, pl);
      start_rs(acc[0], ph, pl, ring + S::kTile);
      unsigned dh[kRSteps][4], dlo[kRSteps][4];
      split(dp, dh, dlo);
      start_rs(acc[1], dh, dlo, ring);
    } else {
      // dQ += dS K
      split(dp, ph, pl);
      start_rs(acc[0], ph, pl, ring);
    }
    mxtt::wgmma_commit();
    mxtt::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < S::kAccs; ++x)
#pragma unroll
      for (int c = 0; c < kNC; ++c) mxtt::wgmma_fence_operand(acc[x][c]);
    release(t);
  }

  // float16: back to the gradient's own scale
  if constexpr (kScaleDs) {
    const float u0 = pow2i(-ex0), u1 = pow2i(-ex1);
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        acc[kDs][c][4 * i] *= u0;
        acc[kDs][c][4 * i + 1] *= u0;
        acc[kDs][c][4 * i + 2] *= u1;
        acc[kDs][c][4 * i + 3] *= u1;
      }
  }
  // epilogue: the gradients in T, rows of (B, H, S, D) contiguous outputs;
  // dkv's key rows past kv_len exact zeros
  const int n_rows = kDkv ? a.Sk : Sq;
  const long long base = (long long)bh * n_rows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= n_rows) continue;
    const bool live = !kDkv || row < kv_len;
#pragma unroll
    for (int x = 0; x < S::kAccs; ++x) {
      T* grow = (x ? a.g1 : a.g0) + (base + row) * D;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int i = 0; i < kN / 8; ++i)
          *reinterpret_cast<unsigned*>(grow + c * kN + 8 * i + 2 * t4) =
              live ? mxtt::half_pack<T>(acc[x][c][4 * i + 2 * half],
                                        acc[x][c][4 * i + 2 * half + 1])
                   : 0u;
    }
  }
}

Strides unpack(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
    st.d[i] = s[12 + i];
  }
  return st;
}

// Call fn(std::integral_constant<int, D>) for the head dim D.
template <class F>
cudaError_t by_head_dim(int D, F&& fn) {
  switch (D) {
    case 16:
      return fn(std::integral_constant<int, 16>());
    case 32:
      return fn(std::integral_constant<int, 32>());
    case 64:
      return fn(std::integral_constant<int, 64>());
    case 128:
      return fn(std::integral_constant<int, 128>());
    default:
      return cudaErrorInvalidValue;
  }
}

// The 1-d tensor map of n contiguous fp32 values (lse or delta, (B H Sq)
// flat): boxes of kRowBox, elements past n read as zeros. A box's start
// must be 16-byte aligned (an unaligned one faulted the card as an
// illegal instruction), so the kernel starts a row's box up to 3 values
// early.
cudaError_t rows_map(CUtensorMap* map, const float* base, long long n) {
  mxtt::EncodeTiled encode;
  const cudaError_t err = mxtt::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};   // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)kRowBox};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 16-bit instance's launch: the tensor maps of q, dO (Sq rows) and k,
// v (kv_len rows), and for dkv those of lse and delta.
template <int D, class T, bool kDkv>
cudaError_t launch_wg(const T* q, const T* k, const T* v, const T* o,
                      const T* dout, const float* lse, float* delta, T* g0,
                      T* g1, int B, int H, int Sq, int Sk, int kv_len,
                      int causal, float scale, const long long* st,
                      cudaStream_t stream) {
  using S = WgSmem<D, kDkv>;
  constexpr int kSw = S::kSwizzle;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = mxtt::raise_smem_limit<flash_bwd_wg_kernel<D, T, kDkv>,
                                 S::kBytes>(dev);
  CUtensorMap qm, km, vm, dm, lm = {}, em = {};
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&qm, q, D, B, H, Sq, st);
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&km, k, D, B, H, kv_len, st + 3);
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&vm, v, D, B, H, kv_len, st + 6);
  if (err == cudaSuccess)
    err = mxtt::tensor_map_rows<T, kSw>(&dm, dout, D, B, H, Sq, st + 12);
  if (kDkv && err == cudaSuccess)
    err = rows_map(&lm, lse, (long long)B * H * Sq);
  if (kDkv && err == cudaSuccess)
    err = rows_map(&em, delta, (long long)B * H * Sq);
  if (err != cudaSuccess) return err;
  WgArgs<T> a;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.g0 = g0;
  a.g1 = g1;
  for (int i = 0; i < 3; ++i) {
    a.o_st[i] = st[9 + i];
    a.d_st[i] = st[12 + i];
  }
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.kv_len = kv_len;
  a.causal = causal;
  a.scale = scale;
  const dim3 grid(B * H, ((kDkv ? Sk : Sq) + kWgRows - 1) / kWgRows);
  if constexpr (kDkv)
    flash_bwd_wg_kernel<D, T, true><<<grid, S::kThreads, S::kBytes, stream>>>(
        km, vm, qm, dm, lm, em, a);
  else
    flash_bwd_wg_kernel<D, T, false>
        <<<grid, S::kThreads, S::kBytes, stream>>>(qm, dm, km, vm, lm, em, a);
  return cudaGetLastError();
}

template <class T>
int dq_launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
              const float* lse, T* dq, float* delta, int B, int H, int Sq,
              int Sk, int D, int kv_len, int causal, float scale,
              const long long* strides, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if ((Sq + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    return by_head_dim(D, [&](auto d) -> cudaError_t {
      return launch_wg<decltype(d)::value, T, false>(
          q, k, v, o, dout, lse, delta, dq, nullptr, B, H, Sq, Sk, kv_len,
          causal, scale, strides, s);
    });
  } else {
    const Strides st = unpack(strides);
    int dev = 0;
    if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess)
      return err;
    return by_head_dim(D, [&](auto d) -> cudaError_t {
      constexpr int kD = decltype(d)::value;
      constexpr size_t kBytes = TcSmem<kD>::kBytes;
      const cudaError_t err =
          mxtt::raise_smem_limit<flash_bwd_dq_tc_kernel<kD>, kBytes>(dev);
      if (err != cudaSuccess) return err;
      const dim3 grid(B * H, (Sq + kTile - 1) / kTile);
      flash_bwd_dq_tc_kernel<kD><<<grid, kTcThreads, kBytes, s>>>(
          q, k, v, o, dout, lse, dq, delta, H, Sq, kv_len, causal, scale,
          st);
      return cudaGetLastError();
    });
  }
}

template <class T>
int dkv_launch(const T* q, const T* k, const T* v, const T* dout,
               const float* lse, const float* delta, T* dk, T* dv, int B,
               int H, int Sq, int Sk, int D, int kv_len, int causal,
               float scale, const long long* strides, void* stream) {
  if (B * H == 0 || Sk == 0) return cudaSuccess;
  if ((Sk + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    return by_head_dim(D, [&](auto d) -> cudaError_t {
      return launch_wg<decltype(d)::value, T, true>(
          q, k, v, nullptr, dout, lse, const_cast<float*>(delta), dv, dk, B,
          H, Sq, Sk, kv_len, causal, scale, strides, s);
    });
  } else {
    const Strides st = unpack(strides);
    int dev = 0;
    if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess)
      return err;
    return by_head_dim(D, [&](auto d) -> cudaError_t {
      constexpr int kD = decltype(d)::value;
      constexpr size_t kBytes = TcSmem<kD>::kBytes;
      const cudaError_t err =
          mxtt::raise_smem_limit<flash_bwd_dkv_tc_kernel<kD>, kBytes>(dev);
      if (err != cudaSuccess) return err;
      const dim3 grid(B * H, (Sk + kTile - 1) / kTile);
      flash_bwd_dkv_tc_kernel<kD><<<grid, kTcThreads, kBytes, s>>>(
          q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, kv_len, causal,
          scale, st);
      return cudaGetLastError();
    });
  }
}

}  // namespace

// Both entry points of an instance take the same arguments: eight
// pointers, then B, H, Sq, Sk, D, kv_len, causal, scale, the (b, h, s)
// element strides of q, k, v, out and dO (15 values, in that order;
// the last axis of each is contiguous and every row starts on a 16-byte
// boundary) and the stream. lse and delta are contiguous (B, H, Sq)
// fp32; dq, dk and dv contiguous (B, H, S, D) in the inputs' type. The
// dq launch writes delta, which the dkv launch, queued after it on the
// same stream, reads. Each returns the cudaError_t of its launch.
#define MXTT_BWD_ENTRIES(SUFFIX, T)                                         \
  int mxtt_flash_attention_bwd_dq##SUFFIX(                                  \
      const T* q, const T* k, const T* v, const T* o, const T* dout,        \
      const float* lse, T* dq, float* delta, int B, int H, int Sq, int Sk,  \
      int D, int kv_len, int causal, float scale, const long long* strides, \
      void* stream) {                                                       \
    return dq_launch<T>(q, k, v, o, dout, lse, dq, delta, B, H, Sq, Sk, D,  \
                        kv_len, causal, scale, strides, stream);            \
  }                                                                         \
  int mxtt_flash_attention_bwd_dkv##SUFFIX(                                 \
      const T* q, const T* k, const T* v, const T* dout, const float* lse,  \
      const float* delta, T* dk, T* dv, int B, int H, int Sq, int Sk,       \
      int D, int kv_len, int causal, float scale, const long long* strides, \
      void* stream) {                                                       \
    return dkv_launch<T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk,   \
                         D, kv_len, causal, scale, strides, stream);        \
  }

extern "C" {

MXTT_BWD_ENTRIES(, float)
MXTT_BWD_ENTRIES(_bf16, mxtt::bf16)
MXTT_BWD_ENTRIES(_f16, mxtt::f16)

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
