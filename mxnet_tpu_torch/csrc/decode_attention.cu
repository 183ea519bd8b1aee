// K2 — decode attention over a dense KV cache (fp32) for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py decode_attention_pallas (kernel
// body _decode_fwd_kernel), fp32 variant. Same function: every query
// row of slot b attends keys [0, lengths[b]) of its cache row, with no
// causal structure among the queries; lengths[b] == 0 gives zeros.
//
// What bounds it on the H100: bytes. One decode step reads each valid
// K and V row once — 2 * sum(len) * H * D * 4 bytes per layer — and
// does 4 * D FLOP per (query, key) pair, about one FLOP per byte,
// far below the card's ~20 FLOP per byte for fp32.
//
// What the design does about it:
// - One thread block per (head, slot, group of query rows); 8 warps
//   split the slot's valid prefix into interleaved 32-key chunks, so
//   256 key rows are in flight per block. The TPU kernel's sequential
//   kv-block grid axis becomes this loop, and per-warp online-softmax
//   states are merged once, through shared memory, at the end.
// - The loop runs over [0, len) only: no K or V row at or past the
//   slot's length is ever loaded. That is the Hopper form of the TPU
//   kernel's "skip blocks past ceil(len / block_k)" and "zero the V
//   overhang": garbage (even NaN) there never reaches a sum.
// - K rows are read with 16-byte loads, one row per lane; V rows are
//   read coalesced, one row per step across the warp, with each lane
//   owning D / 32 output columns; p reaches the lanes by shuffle.
// - Decode (one query per slot) runs a one-row instance, so no work is
//   spent on absent query rows; 2..R queries run four rows per block.
// At the serving shape (8 slots x 12 heads) the 96 blocks do not fill
// 132 SMs; a split-KV (flash-decoding) redesign is queued in ROADMAP.md.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;   // keys per warp step: one per lane

template <int D, int NR>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ out, int H, int Sq, int S, float scale,
              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss) {
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output columns per lane
  constexpr int V4 = D / 4;
  __shared__ __align__(16) float q_s[NR][D];
  __shared__ float m_s[kWarps][NR];
  __shared__ float l_s[kWarps][NR];
  __shared__ float acc_s[kWarps][NR][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const int nr = min(NR, Sq - r0);
  const int len = max(0, min(lengths[b], S));
  float* ob = out + (((long long)b * H + h) * Sq + r0) * D;

  if (len == 0) {   // an empty slot attends nothing: zeros
    for (int i = tid; i < nr * D; i += kThreads) ob[i] = 0.f;
    return;
  }

  const float* qb = q + b * q_sb + h * q_sh;
  for (int i = tid; i < NR * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr) {
      x = mxtt::load4(qb + (long long)(r0 + r) * q_ss + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(&q_s[r][c]) = x;
  }
  __syncthreads();

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float m[NR], l[NR], acc[NR][DPL];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = MXTT_NEG_INF;
    l[r] = 0.f;   // this lane's share of the denominator
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = warp * kChunk; k0 < len; k0 += kWarps * kChunk) {
    const int key = k0 + lane;
    const bool valid = key < len;
    float s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] = 0.f;
    if (valid) {
      const float* krow = kb + (long long)key * k_ss;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 kx = mxtt::load4(krow + c);
#pragma unroll
        for (int r = 0; r < NR; ++r)
          s[r] = mxtt::dot4(*reinterpret_cast<const float4*>(&q_s[r][c]), kx,
                            s[r]);
      }
    }
    float p[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float sv = valid ? s[r] : MXTT_NEG_INF;
      const float m_new = fmaxf(m[r], mxtt::warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      p[r] = valid ? expf(sv - m_new) : 0.f;   // re-mask
      l[r] = l[r] * alpha + p[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
    // P @ V over this chunk's valid rows only (nk is warp-uniform)
    const int nk = min(kChunk, len - k0);
    for (int j = 0; j < nk; ++j) {
      const float* vrow = vb + (long long)(k0 + j) * v_ss;
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? __ldg(vrow + d) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float pj = __shfl_sync(mxtt::kFullMask, p[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  // merge the warps' partial states: out = sum_w acc_w e^(m_w - M) /
  // sum_w l_w e^(m_w - M); a warp that saw no key has l = 0, acc = 0
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float lt = mxtt::warp_sum(l[r]);
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
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float mx = MXTT_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(m_s[w][r] - mx);
      lsum = fmaf(l_s[w][r], a, lsum);
      o = fmaf(acc_s[w][r][d], a, o);
    }
    const float l_safe = lsum > 0.f ? lsum : 1.f;
    ob[r * D + d] = o / l_safe;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* out, int B, int H, int Sq, int S,
                   float scale, const long long* st, cudaStream_t stream) {
  if (Sq == 1) {
    decode_kernel<D, 1><<<dim3(H, B, 1), kThreads, 0, stream>>>(
        q, k, v, lengths, out, H, Sq, S, scale, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8]);
  } else {
    constexpr int NR = 4;
    decode_kernel<D, NR><<<dim3(H, B, (Sq + NR - 1) / NR), kThreads, 0,
                           stream>>>(q, k, v, lengths, out, H, Sq, S, scale,
                                     st[0], st[1], st[2], st[3], st[4], st[5],
                                     st[6], st[7], st[8]);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D); k / v: (B, H, S, D) cache buffers; all fp32 with a
// contiguous last axis; ``strides`` holds the (b, h, s) element strides
// of q, k and v in that order. lengths: (B,) int32 on the device.
// out: (B, H, Sq, D) contiguous fp32. Returns the launch's cudaError_t.
int mxtt_decode_attention(const float* q, const float* k, const float* v,
                          const int* lengths, float* out, int B, int H,
                          int Sq, int S, int D, float scale,
                          const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, lengths, out, B, H, Sq, S, scale, strides, s);
    case 32:
      return launch<32>(q, k, v, lengths, out, B, H, Sq, S, scale, strides, s);
    case 64:
      return launch<64>(q, k, v, lengths, out, B, H, Sq, S, scale, strides, s);
    case 128:
      return launch<128>(q, k, v, lengths, out, B, H, Sq, S, scale, strides,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
