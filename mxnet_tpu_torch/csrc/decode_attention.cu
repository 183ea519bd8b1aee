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
// What the design does about it (the block body is decode_core.cuh,
// shared with K3):
// - One thread block per (head, slot, group of query rows); 8 warps
//   split the slot's valid prefix into interleaved 32-key chunks, so
//   256 key rows are in flight per block, and merge their
//   online-softmax states once at the end.
// - The loop runs over [0, len) only: no K or V row at or past the
//   slot's length is ever loaded, so garbage (even NaN) there never
//   reaches a sum.
// - K rows are read with 16-byte loads, one row per lane; V rows
//   coalesced across the warp.
// - Decode (one query per slot) runs a one-row instance, so no work is
//   spent on absent query rows; 2..R queries run four rows per block.
// At the serving shape (8 slots x 12 heads) the 96 blocks do not fill
// 132 SMs; a split-KV (flash-decoding) redesign is queued in ROADMAP.md.
#include "decode_core.cuh"

namespace {

constexpr int kThreads = mxtt::kDecodeThreads;

// Key row t of one (slot, head) of a dense (B, H, S, D) cache.
struct DenseRows {
  const float* k;
  const float* v;
  long long k_ss, v_ss;
  static constexpr bool kIndirect = false;
  __device__ __forceinline__ void offsets(int t, long long& ko,
                                          long long& vo) const {
    ko = (long long)t * k_ss;
    vo = (long long)t * v_ss;
  }
};

template <int D, int NR>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ out, int H, int Sq, int S, float scale,
              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const int nr = min(NR, Sq - r0);
  const int len = max(0, min(lengths[b], S));
  const DenseRows rows{k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh,
                       k_ss, v_ss};
  mxtt::decode_block<D, NR>(q + b * q_sb + h * q_sh, q_ss, r0, nr, len,
                            scale, rows,
                            out + (((long long)b * H + h) * Sq + r0) * D);
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
