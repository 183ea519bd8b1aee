// K4 — weight-only int8 projection (fused dequantize-matmul) for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/quantized.py dequant_matmul_pallas (kernel
// body _dequant_matmul_kernel -> _dequant_dot). Same function:
//   out[m, n] = sum_k x[m, k] * (float(wq[n, k]) * scale[n]) (+ bias[n])
// for fp32 x (M, K), int8 wq (N, K) in the Dense (out, in) layout, fp32
// per-output-channel scales (N,) and an optional fp32 bias (N,), added
// in the epilogue (null: none). The TPU kernel walks 512-channel blocks
// in a grid and dequantizes each in VMEM; the block rule only fixes its
// summation structure, so this kernel tiles as it likes and is held to
// the plain version within a tolerance, not bitwise.
//
// What bounds it on the H100: at decode widths (M <= 8) a launch moves
// 0.6-2.5 MB of int8 weights (0.2-0.75 us at 3.35 TB/s), so what sets
// its time is latency: the launch, one DRAM round trip, the sum over K.
// At M = 512 (the dense engine's prefill) the products set it instead.
//
// M <= 8: a latency-first GEMV on the TF32 tensor cores
// (dequant_gemv_kernel).
// - A block owns 8 output channels (the n of mma.m16n8k8); its warps
//   split K, each one or two 64-wide k steps. Lane (g, t) of a
//   warp loads 16 bytes of channel g's weight row at k = 64 s + 16 t:
//   one warp load covers 64 contiguous bytes of each of 8 rows, whole
//   sectors, and the weight is read once per launch.
// - Every weight load of the warp's round is issued first, before x is
//   touched and before any barrier (one 16-byte load a lane at
//   K <= 2048, two above; one round up to K = 4096, the GPT-2 widths
//   included); x (just written to L2 by the previous kernel) is read
//   while they fly: lane (g, t) takes row g's 16 fp32 at the same k
//   (rows at or past M are zeros). The block's scale and bias are
//   fetched at the start too, behind the weights.
// - The product runs as mma.sync m16n8k8 with x as A and the weight as
//   B, the mma's k mapped to the lane's own 16 values (k = 2i and
//   2i + 1 of its run at step i), so no data moves between lanes. An
//   int8 weight is exact in TF32, so the 3xTF32 split needs only x's,
//   and the two terms share one mma: A rows 0..7 hold x's big parts,
//   rows 8..15 (unused by M <= 8) its small parts, and the two halves
//   of the accumulator are added at the end. The channel scale
//   multiplies the sum once. Two accumulators a step keep the
//   dependent mma chains 4 long.
// - The warps' partial sums meet in shared memory behind ONE barrier
//   and are added in warp order (the same order on every run); the
//   epilogue applies the scale and the bias. No cluster, no atomics,
//   no second pass. N is split across blocks (96-384 at GPT-2 widths).
//
// M > 8: a tile kernel on the TF32 tensor cores (dequant_tile_kernel<NF>).
// The chunks of a paged prefill (M = 32, and 9-31 at a prompt's tail)
// and the speculative verify (M = 40) run it; the weight's bytes bound
// it up to about M = 64 (a layer's six at M = 40: 0.0023 ms by bytes,
// about as much by the two TF32 products at 495 TFLOP/s), so every
// weight byte is read once a launch up to 64 rows.
// - The weight is the mma's A operand (16 channels x 8 k) and x its B
//   (8 k x 8 rows), so the rows come in 8-row frags (NF = ceil(M / 8),
//   an instance each up to 64 rows; above, 64-row m tiles re-read the
//   weight from L2). An int8 weight is exact in TF32, so only x is
//   split: x_big * w + x_small * w, two mma on one A fragment, summed
//   in one accumulator.
// - A block owns 32 channels (two 16-channel frags) and K is split over
//   its two warps and over a cluster of up to 8 blocks, sized at launch
//   for about two blocks an SM (144-288 at GPT-2 widths; without the
//   cluster, a layer's six took 1.4x as long at M = 32-40); the partial
//   sums meet in shared memory (warps) and through distributed shared
//   memory (ranks), added in a fixed order, each rank finishing its
//   share of the rows. No atomics.
// - Each warp issues its 16-byte weight loads first (lane (g, t): 16 k
//   of channels g and g + 8 at 16 t of each 64-wide span; the mma's k
//   t and t + 4 map to the lane's own k 16 t + 2 i and + 1 in step i,
//   as in the GEMV), then the block copies x's rows of its K share into
//   shared memory by cp.async (rows past M and k past K zero-filled)
//   while they fly, two spans at a time (at most 36 KB; six spans timed
//   the same at M = 32 and 40 and 17 % slower at M = 512, where fewer
//   blocks fit an SM), rotating each 16-float chunk's 16-byte parts so a
//   quarter warp's loads hit distinct bank groups. An int8 weight
//   becomes its fp32 value by a byte permute into 2^23's mantissa and
//   one subtraction (exact).
// - The scale multiplies each channel's fp32 sum once, and the bias is
//   added, in the epilogue.
//
// K must be a multiple of 16 and x, wq 16-byte aligned (the wrapper
// checks); the activation stays a torch op after the kernel.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---- M <= 8: the tensor-core GEMV ---------------------------------------
constexpr int kGemvRows = 8;       // rows of x (A rows 0..7; 8..15 the small)
constexpr int kGemvChannels = 8;   // output channels per block (the n)
constexpr int kSpan = 64;          // k of one warp step: 4 lanes x 16
constexpr int kMaxWarps = 32;

template <int STEPS>   // 64-k steps per warp per round
__global__ void __launch_bounds__(kMaxWarps * 32)
dequant_gemv_kernel(const float* __restrict__ x,
                    const signed char* __restrict__ wq,
                    const float* __restrict__ scales,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int N, int K) {
  __shared__ float part[kMaxWarps][kGemvRows * kGemvChannels];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = blockIdx.x * kGemvChannels + g;   // this lane's weight row
  const bool w_live = n < N;
  const bool x_live = g < M;                      // this lane's x row
  const signed char* wrow = wq + (long long)(w_live ? n : 0) * K;
  const float* xrow = x + (long long)(x_live ? g : 0) * K;
  const int steps = (K + kSpan - 1) / kSpan;
  // the epilogue's scale and bias, fetched now so their latency hides
  // behind the weights'
  const int i_out = threadIdx.x;
  const int n_out = blockIdx.x * kGemvChannels + (i_out % kGemvChannels);
  const bool out_live = i_out < kGemvRows * kGemvChannels &&
                        i_out / kGemvChannels < M && n_out < N;
  const float s_out = out_live ? __ldg(scales + n_out) : 0.f;
  const float b_out = out_live && bias != nullptr ? __ldg(bias + n_out) : 0.f;

  // two accumulators per step (even and odd k pairs): 4-long chains
  float acc[STEPS][2][4] = {};
  for (int s0 = warp * STEPS; s0 < steps; s0 += warps * STEPS) {
    // the round's weight loads first: they do not depend on x
    int4 w[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int k = (s0 + u) * kSpan + 16 * t;
      w[u] = make_int4(0, 0, 0, 0);
      if (w_live && s0 + u < steps && k < K)
        w[u] = __ldg(reinterpret_cast<const int4*>(wrow + k));
    }
    float xf[STEPS][16];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int k = (s0 + u) * kSpan + 16 * t;
      const bool live = x_live && s0 + u < steps && k < K;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = live ? mxtt::load4(xrow + k + 4 * c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        xf[u][4 * c] = v.x;
        xf[u][4 * c + 1] = v.y;
        xf[u][4 * c + 2] = v.z;
        xf[u][4 * c + 3] = v.w;
      }
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const signed char* wb = reinterpret_cast<const signed char*>(&w[u]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // mma k index t <-> this lane's k = 2i, t + 4 <-> 2i + 1; A row g
        // holds x's big part, row g + 8 its small part
        unsigned a[4];
        mxtt::split_tf32(xf[u][2 * i], a[0], a[1]);
        mxtt::split_tf32(xf[u][2 * i + 1], a[2], a[3]);
        const unsigned b[2] = {
            __float_as_uint(static_cast<float>(wb[2 * i])),
            __float_as_uint(static_cast<float>(wb[2 * i + 1]))};
        mxtt::mma_tf32(acc[u][i & 1], a, b);
      }
    }
  }

  // acc[.][.][0..1]: x row g's big part times channels 2t, 2t + 1 of
  // the block; [2..3]: its small part
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
      sum += (acc[u][0][2 + e] + acc[u][1][2 + e]) +
             (acc[u][0][e] + acc[u][1][e]);
    part[warp][g * kGemvChannels + 2 * t + e] = sum;
  }
  __syncthreads();
  if (out_live) {
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += part[w][i_out];
    out[(long long)(i_out / kGemvChannels) * N + n_out] =
        sum * s_out + b_out;
  }
}

cudaError_t launch_gemv(const float* x, const signed char* wq,
                        const float* scales, const float* bias, float* out,
                        int M, int N, int K, cudaStream_t stream) {
  const int steps = (K + kSpan - 1) / kSpan;
  const dim3 grid((N + kGemvChannels - 1) / kGemvChannels);
  // one step a warp while the block has room (K <= 2048), else two; at
  // least 2 warps, so the epilogue's 64 threads exist
  if (steps <= kMaxWarps) {
    dequant_gemv_kernel<1><<<grid, max(2, steps) * 32, 0, stream>>>(
        x, wq, scales, bias, out, M, N, K);
  } else {
    const int warps = min(kMaxWarps, (steps + 1) / 2);
    dequant_gemv_kernel<2><<<grid, warps * 32, 0, stream>>>(
        x, wq, scales, bias, out, M, N, K);
  }
  return cudaGetLastError();
}

// ---- M > 8: the tensor-core tile kernel ----------------------------------
constexpr int kChFrags = 2;                // 16-channel frags (mma m) a block
constexpr int kKWarps = 2;                 // warps splitting a block's K
constexpr int kTileChannels = 16 * kChFrags;
constexpr int kTileThreads = 32 * kChFrags * kKWarps;
constexpr int kTileRows = 64;              // rows of x a block (8 n frags)
constexpr int kPieceSpans = 2;             // 64-k spans of x staged at once
constexpr int kPitch = kPieceSpans * kSpan + 16;   // 16 mod 32 floats
static_assert(kPieceSpans % kKWarps == 0, "a piece's spans share out evenly");
constexpr int kMaxSplit = 8;               // blocks of a cluster, splitting K
constexpr int kTargetBlocks = 264;         // about two per SM of the H100
constexpr int kTileBlocks = 2;             // blocks an SM the registers allow

// Shared memory of an instance of NF 8-row frags: the staged x piece
// (reused by the partial sums at the end).
template <int NF>
constexpr size_t kTileSmem = (size_t)8 * NF * kPitch * sizeof(float);
static_assert(kTileSmem<8> <= 48 * 1024, "no opt-in shared memory needed");

// An int8 weight as the fp32 (and TF32) value it is: its byte, biased to
// unsigned (``w`` carries the XOR with 0x80808080), becomes the low
// mantissa byte of 2^23, and the bias and 2^23 are subtracted (exact).
__device__ __forceinline__ unsigned s8_tf32(unsigned w, int byte) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | byte)) -
      8388736.f);
}

// x's piece in shared memory: row r, 16-float chunk c16 of the piece,
// 16-byte part p at r * kPitch + 16 c16 + 4 ((p + c16) % 4). A lane
// (g, t) reads chunk 4 s + t of its rows: the rotation puts a quarter
// warp's 8 loads (rows g, g + 1; t = 0..3) on 8 distinct bank groups.
__device__ __forceinline__ int x_at(int r, int c16, int p) {
  return r * kPitch + 16 * c16 + 4 * ((p + c16) & 3);
}

// out (rows m0.., channels blockIdx.x * kTileChannels..) of NF 8-row
// frags. Launched as clusters of gridDim.z blocks along z, each summing
// its share of K's 64-wide spans.
template <int NF>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
dequant_tile_kernel(const float* __restrict__ x,
                    const signed char* __restrict__ wq,
                    const float* __restrict__ scales,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int N, int K) {
  extern __shared__ __align__(16) float tile_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int split = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cf = warp % kChFrags, kw = warp / kChFrags;
  const int n0 = blockIdx.x * kTileChannels;
  const int m0 = blockIdx.y * kTileRows;
  const int rows = min(8 * NF, M - m0);   // rows of x this block reads
  // this block's spans of K
  const int spans = (K + kSpan - 1) / kSpan;
  const int per = (spans + split - 1) / split;
  const int s_begin = min(spans, rank * per);
  const int s_end = min(spans, s_begin + per);
  // the lane's weight rows: channels g and g + 8 of its frag
  const int na = n0 + 16 * cf + g, nb = na + 8;
  const signed char* wa = wq + (long long)(na < N ? na : 0) * K;
  const signed char* wb = wq + (long long)(nb < N ? nb : 0) * K;
  // the epilogue's outputs: channel n0 + tid % kTileChannels of rows
  // r_lo + tid / kTileChannels, + kTileThreads / kTileChannels.. (this
  // rank's share of the block's rows); its scale and bias fetched now
  const int r_per = (rows + split - 1) / split;
  const int r_lo = min(rows, rank * r_per), r_hi = min(rows, r_lo + r_per);
  const int n_out = n0 + tid % kTileChannels;
  const float s_out = n_out < N ? __ldg(scales + n_out) : 0.f;
  const float b_out =
      n_out < N && bias != nullptr ? __ldg(bias + n_out) : 0.f;

  // two accumulators a frag (even and odd k steps): chains of 8 a span
  float acc[2][NF][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[e][f][i] = 0.f;

  constexpr int kWarpSpans = kPieceSpans / kKWarps;   // a warp's, a piece
  for (int p0 = s_begin; p0 < s_end; p0 += kPieceSpans) {
    const int p1 = min(s_end, p0 + kPieceSpans);
    // the warp's weight loads first: spans p0 + kw + kKWarps i
    int4 w[kWarpSpans][2];
#pragma unroll
    for (int i = 0; i < kWarpSpans; ++i) {
      const int s = p0 + kw + kKWarps * i;
      const int k = s * kSpan + 16 * t;
      const bool live = s < p1 && k < K;
      w[i][0] = live && na < N ? __ldg(reinterpret_cast<const int4*>(wa + k))
                               : make_int4(0, 0, 0, 0);
      w[i][1] = live && nb < N ? __ldg(reinterpret_cast<const int4*>(wb + k))
                               : make_int4(0, 0, 0, 0);
    }
    // x's piece, rows past M and columns past K zero-filled
    const int chunks = (p1 - p0) * (kSpan / 4);
    for (int i = tid; i < 8 * NF * chunks; i += kTileThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int k = p0 * kSpan + 4 * c;
      const bool live = r < rows && k < K;
      mxtt::cp_async16(tile_smem + x_at(r, c >> 2, c & 3),
                       x + (live ? (long long)(m0 + r) * K + k : 0), live);
    }
    mxtt::cp_async_commit();
    mxtt::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWarpSpans; ++i) {
      const int ls = kw + kKWarps * i;   // the span within the piece
      if (p0 + ls >= p1) break;
      // A: the weights of k steps st = 0..7 (the lane's k 16 t + 2 st
      // and + 1 as the mma's k t and t + 4), exact in TF32
      unsigned a[8][4];
#pragma unroll
      for (int st = 0; st < 8; ++st) {
        const int word = st >> 1, byte = 2 * (st & 1);
        const unsigned ua = (&w[i][0].x)[word] ^ 0x80808080u;
        const unsigned ub = (&w[i][1].x)[word] ^ 0x80808080u;
        a[st][0] = s8_tf32(ua, byte);
        a[st][1] = s8_tf32(ub, byte);
        a[st][2] = s8_tf32(ua, byte + 1);
        a[st][3] = s8_tf32(ub, byte + 1);
      }
      // B: x row 8 f + g at the same k, big and small parts
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int c16 = 4 * ls + t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              tile_smem + x_at(8 * f + g, c16, q));
          const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int st = 2 * q + h;
            unsigned bb[2], bs[2];
            mxtt::split_tf32(xv[2 * h], bb[0], bs[0]);
            mxtt::split_tf32(xv[2 * h + 1], bb[1], bs[1]);
            mxtt::mma_tf32(acc[h][f], a[st], bs);
            mxtt::mma_tf32(acc[h][f], a[st], bb);
          }
        }
      }
    }
    __syncthreads();   // the piece is consumed
  }

  // the block's sums: part[kw][row][channel], then kw's added in order
  // into part[0] (the x area, free now)
  float* part = tile_smem;
  constexpr int kPart = 8 * NF * kTileChannels;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 8 * f + 2 * t + (i & 1);
      const int ch = 16 * cf + g + 8 * (i >> 1);
      part[kw * kPart + row * kTileChannels + ch] =
          acc[0][f][i] + acc[1][f][i];
    }
  __syncthreads();
  for (int i = tid; i < kPart; i += kTileThreads) {
    float s = part[i];
#pragma unroll
    for (int u = 1; u < kKWarps; ++u) s += part[u * kPart + i];
    part[i] = s;
  }
  // the cluster's blocks' sums, in rank order: each rank finishes its
  // share of the rows
  cluster.sync();
  if (n_out < N)
    for (int r = r_lo + tid / kTileChannels; r < r_hi;
         r += kTileThreads / kTileChannels) {
      const int i = r * kTileChannels + tid % kTileChannels;
      float s = 0.f;
      for (int u = 0; u < split; ++u)
        s += *cluster.map_shared_rank(part + i, u);
      out[(long long)(m0 + r) * N + n_out] = s * s_out + b_out;
    }
  cluster.sync();   // peers keep their shared memory until all are done
}

template <int NF>
cudaError_t launch_tile(const float* x, const signed char* wq,
                        const float* scales, const float* bias, float* out,
                        int M, int N, int K, cudaStream_t stream) {
  const int groups = (N + kTileChannels - 1) / kTileChannels;
  const int m_tiles = (M + kTileRows - 1) / kTileRows;
  const int spans = (K + kSpan - 1) / kSpan;
  // about kTargetBlocks blocks, then no rank without spans
  int split = (kTargetBlocks + groups * m_tiles - 1) / (groups * m_tiles);
  split = max(1, min(split, min(kMaxSplit, spans)));
  const int per = (spans + split - 1) / split;
  split = (spans + per - 1) / per;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, m_tiles, split);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = kTileSmem<NF>;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dequant_tile_kernel<NF>, x, wq, scales, bias, out, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tile kernel's instance for M rows: NF = ceil(M / 8) 8-row frags up
// to 64 rows, and 64-row m tiles above
cudaError_t launch_tiled(const float* x, const signed char* wq,
                         const float* scales, const float* bias, float* out,
                         int M, int N, int K, cudaStream_t stream) {
  switch (M >= kTileRows ? 8 : (M + 7) / 8) {
    case 2:
      return launch_tile<2>(x, wq, scales, bias, out, M, N, K, stream);
    case 3:
      return launch_tile<3>(x, wq, scales, bias, out, M, N, K, stream);
    case 4:
      return launch_tile<4>(x, wq, scales, bias, out, M, N, K, stream);
    case 5:
      return launch_tile<5>(x, wq, scales, bias, out, M, N, K, stream);
    case 6:
      return launch_tile<6>(x, wq, scales, bias, out, M, N, K, stream);
    case 7:
      return launch_tile<7>(x, wq, scales, bias, out, M, N, K, stream);
    default:
      return launch_tile<8>(x, wq, scales, bias, out, M, N, K, stream);
  }
}

}  // namespace

extern "C" {

// x: (M, K) contiguous fp32; wq: (N, K) contiguous int8; scales: (N,)
// fp32; bias: (N,) fp32 or null; out: (M, N) contiguous fp32;
// K % 16 == 0, x and wq 16-byte aligned. Returns the launch's
// cudaError_t.
int mxtt_dequant_matmul(const float* x, const signed char* wq,
                        const float* scales, const float* bias, float* out,
                        int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || K % 16) return cudaErrorInvalidValue;
  if ((M + kTileRows - 1) / kTileRows > 65535) return cudaErrorInvalidValue;
  if (M <= kGemvRows)
    return launch_gemv(x, wq, scales, bias, out, M, N, K, s);
  return launch_tiled(x, wq, scales, bias, out, M, N, K, s);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
