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
// M > 8: a lane per output channel (dequant_tiled_kernel), all rows of
// a 32-row tile of x per lane, so each weight byte is read once per
// tile; K split across the block's 8 warps and across a thread-block
// cluster of up to 8 blocks sized at launch, sums met through
// distributed shared memory in rank order; x staged in shared memory
// and read as broadcasts; the bias added by rank 0.
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

// ---- M > 8: a lane per channel, K split across warps and a cluster ------
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 32;             // rows of x per launch tile
constexpr int kMaxSplit = 8;        // blocks of one cluster, splitting K
constexpr int kTargetBlocks = 264;  // about two per SM of the H100
constexpr int kSmemFloats = 8192;   // 32 KB: the x tile, then the sums
constexpr int kLoads = 4;           // weight loads in flight per lane

__global__ void __launch_bounds__(kThreads)
dequant_tiled_kernel(const float* __restrict__ x,
                     const signed char* __restrict__ wq,
                     const float* __restrict__ scales,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int N, int K) {
  constexpr int MT = kMT;
  constexpr int KT = kSmemFloats / MT;   // k per staged x tile
  static_assert(KT % 16 == 0 && KT * MT <= kSmemFloats, "x tile");
  static_assert(kWarps * MT * 32 <= kSmemFloats, "partial sums");
  __shared__ __align__(16) float smem[kSmemFloats];
  __shared__ float part[MT * 32];        // this block's sums, for rank 0

  // launched as clusters of gridDim.z blocks along z
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int split = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n = blockIdx.x * 32 + lane;
  const bool live = n < N;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const float s = live ? __ldg(scales + n) : 0.f;
  const int4* wrow =
      reinterpret_cast<const int4*>(wq + (long long)(live ? n : 0) * K);
  // this block's share of K, in whole 16-weight groups
  const int all_groups = K / 16;
  const int per_block = (all_groups + split - 1) / split;
  const int kb0 = min(all_groups, (int)rank * per_block) * 16;
  const int kb1 = min(all_groups, ((int)rank + 1) * per_block) * 16;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int kt = kb0; kt < kb1; kt += KT) {
    const int kc = min(KT, kb1 - kt);    // a multiple of 16
    const int c4 = kc / 4;
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < MT * c4; i += kThreads) {
      const int r = i / c4;
      const int c = (i - r * c4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);   // absent rows: zeros
      if (r < mt) v = mxtt::load4(x + (long long)(m0 + r) * K + kt + c);
      *reinterpret_cast<float4*>(&smem[r * KT + c]) = v;
    }
    __syncthreads();
    // this warp's contiguous range of the tile's 16-weight groups
    const int groups = kc / 16;
    const int per = (groups + kWarps - 1) / kWarps;
    const int g1 = min(groups, (warp + 1) * per);
    if (live) {
      for (int g0 = warp * per; g0 < g1; g0 += kLoads) {
        int4 raw[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (g0 + u < g1) raw[u] = __ldg(wrow + (kt / 16) + g0 + u);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (g0 + u >= g1) break;
          const signed char* b = reinterpret_cast<const signed char*>(&raw[u]);
          float w[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) w[i] = static_cast<float>(b[i]) * s;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float* xr = &smem[m * KT + (g0 + u) * 16];
            float a = acc[m];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * c);
              a = fmaf(xv.x, w[4 * c], a);
              a = fmaf(xv.y, w[4 * c + 1], a);
              a = fmaf(xv.z, w[4 * c + 2], a);
              a = fmaf(xv.w, w[4 * c + 3], a);
            }
            acc[m] = a;
          }
        }
      }
    }
  }

  // the 8 warps' partial sums of each (row, channel), in warp order
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) smem[(warp * MT + m) * 32 + lane] = acc[m];
  __syncthreads();
  for (int i = tid; i < MT * 32; i += kThreads) {
    const int m = i >> 5;
    const int l = i & 31;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += smem[(w * MT + m) * 32 + l];
    part[i] = t;
  }
  // the cluster's blocks' sums, in rank order, by rank 0
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < mt * 32; i += kThreads) {
      const int nn = blockIdx.x * 32 + (i & 31);
      if (nn >= N) continue;
      float t = 0.f;
      for (int r = 0; r < split; ++r)
        t += *cluster.map_shared_rank(part + i, r);
      if (bias != nullptr) t += __ldg(bias + nn);
      out[(long long)(m0 + (i >> 5)) * N + nn] = t;
    }
  }
  cluster.sync();   // peers keep their shared memory until rank 0 is done
}

cudaError_t launch_tiled(const float* x, const signed char* wq,
                         const float* scales, const float* bias, float* out,
                         int M, int N, int K, cudaStream_t stream) {
  const int tiles = ((N + 31) / 32) * ((M + kMT - 1) / kMT);
  const int split = max(1, min(kMaxSplit, kTargetBlocks / tiles));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 31) / 32, (M + kMT - 1) / kMT, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dequant_tiled_kernel, x, wq, scales, bias, out, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
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
  if ((M + kMT - 1) / kMT > 65535) return cudaErrorInvalidValue;
  if (M <= kGemvRows)
    return launch_gemv(x, wq, scales, bias, out, M, N, K, s);
  return launch_tiled(x, wq, scales, bias, out, M, N, K, s);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
