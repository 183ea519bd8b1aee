// K4 — weight-only int8 projection (fused dequantize-matmul) for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/quantized.py dequant_matmul_pallas (kernel
// body _dequant_matmul_kernel -> _dequant_dot). Same function:
//   out[m, n] = sum_k x[m, k] * (float(wq[n, k]) * scale[n])
// for fp32 x (M, K), int8 wq (N, K) in the Dense (out, in) layout and
// fp32 per-output-channel scales (N,). The TPU kernel walks 512-channel
// blocks in a grid and dequantizes each in VMEM; the block rule only
// fixes its summation structure, so this kernel tiles as it likes and
// is held to the plain version within a tolerance, not bitwise.
//
// What bounds it on the H100: bytes at the decode shape. At M = 8 rows
// each weight byte feeds 2 * 8 FLOP, far below the card's ~20 fp32
// FLOP per byte, so the int8 weights streamed from HBM (N * K bytes, a
// quarter of the fp32 weight) set the time. At M = 512 (the dense
// engine's prefill) the products set it instead.
//
// What the design does about it:
// - Each lane owns one output channel (32 channels per block) and all
//   rows of the launch tile (up to MT = 32 rows of x), so a launch
//   reads each weight byte ONCE, not once per row. A lane streams its
//   channel's int8 row with 16-byte loads (16 weights), four in flight
//   before any is used, converts and scales them in registers (the
//   reference's wq.f32 * scale before the product) and accumulates MT
//   fp32 sums on the CUDA cores.
// - K is split twice so that every SM has work: across the blocks of
//   a thread-block cluster along grid.z (up to 8, sized at launch for
//   about two blocks per SM: at M = 8 that is 192 blocks instead of 24
//   for N = 768, and a 2-way split for N = 3072), and within a block
//   across its 8 warps. The warps' partial sums meet in shared memory;
//   the cluster's blocks then meet through distributed shared memory,
//   where block rank 0 adds its peers' sums in rank order — one launch,
//   no scratch buffer, no atomics, the same summation order on every
//   run.
// - The x rows of the tile are staged in shared memory, a K-tile at a
//   time, and read as broadcasts: every lane of a warp works on the
//   same k at once, so one shared-memory read serves 32 channels.
// - The dequantized weight never exists outside registers; the
//   outputs are written coalesced (consecutive lanes, consecutive
//   channels).
// - M = 1 (peek) and M <= 8 (decode) have their own instances so no
//   FMAs are spent on absent rows; M > 32 tiles the rows over grid.y
//   (the weights are then read once per 32-row tile).
// K must be a multiple of 16 and x, wq 16-byte aligned (the wrapper
// checks); bias and activation stay torch ops after the kernel.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;        // blocks of one cluster, splitting K
constexpr int kTargetBlocks = 264;  // about two per SM of the H100
constexpr int kSmemFloats = 8192;   // 32 KB: the x tile, then the sums
constexpr int kLoads = 4;           // weight loads in flight per lane

template <int MT>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const float* __restrict__ x,
                      const signed char* __restrict__ wq,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int M, int N, int K) {
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
      out[(long long)(m0 + (i >> 5)) * N + nn] = t;
    }
  }
  cluster.sync();   // peers keep their shared memory until rank 0 is done
}

template <int MT>
cudaError_t launch(const float* x, const signed char* wq, const float* scales,
                   float* out, int M, int N, int K, cudaStream_t stream) {
  const int tiles = ((N + 31) / 32) * ((M + MT - 1) / MT);
  const int split = max(1, min(kMaxSplit, kTargetBlocks / tiles));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 31) / 32, (M + MT - 1) / MT, split);
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
      &cfg, dequant_matmul_kernel<MT>, x, wq, scales, out, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (M, K) contiguous fp32; wq: (N, K) contiguous int8; scales: (N,)
// fp32; out: (M, N) contiguous fp32; K % 16 == 0, x and wq 16-byte
// aligned. Returns the launch's cudaError_t.
int mxtt_dequant_matmul(const float* x, const signed char* wq,
                        const float* scales, float* out, int M, int N, int K,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || K % 16) return cudaErrorInvalidValue;
  if ((M + 31) / 32 > 65535) return cudaErrorInvalidValue;
  if (M == 1) return launch<1>(x, wq, scales, out, M, N, K, s);
  if (M <= 8) return launch<8>(x, wq, scales, out, M, N, K, s);
  return launch<32>(x, wq, scales, out, M, N, K, s);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
