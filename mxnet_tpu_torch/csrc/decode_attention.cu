// K2 — decode attention over a dense KV cache, fp32 or int8, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py decode_attention_pallas (kernel
// body _decode_fwd_kernel), both variants: fp32, and int8 K/V with
// (B, H) fp32 scales (quant=True). Same function: every query row of
// slot b attends keys [0, lengths[b]) of its cache row, with no causal
// structure among the queries; lengths[b] == 0 gives zeros. The int8
// instance attends K = k * k_scale[b, h] and V = v * v_scale[b, h].
//
// What bounds it on the H100: bytes. One decode step reads each valid
// K and V row once — 2 * sum(len) * H * D * 4 bytes per layer in fp32,
// a quarter of that in int8 — and does 4 * D FLOP per (query, key)
// pair, one to four FLOP per byte, far below the card's ~20 FLOP per
// byte for fp32.
//
// What the design does about it (the block body is decode_core.cuh;
// K3 used it too before its cluster split-KV redesign):
// - One thread block per (head, slot, group of query rows); 8 warps
//   split the slot's valid prefix into interleaved 32-key chunks, so
//   256 key rows are in flight per block, and merge their
//   online-softmax states once at the end.
// - The loop runs over [0, len) only: no K or V row at or past the
//   slot's length is ever loaded, so garbage (even NaN) there never
//   reaches a sum.
// - K rows are read with 16-byte loads, one row per lane; V rows
//   coalesced across the warp. The int8 instance moves the int8 bytes
//   only and widens them in registers; the slot's K and V scales ride
//   with every key as K3's page scales did, and its V loop takes the
//   row offsets by shuffle, as K3's did: folding the K scale into q
//   and computing the offsets in place, as the fp32 instance does,
//   took the int8 instance about twice the device time
//   (scripts/torch_kernel_ab.py; PERF.md).
// - Decode (one query per slot) runs a one-row instance, so no work is
//   spent on absent query rows; 2..R queries run four rows per block.
// At the serving shape (8 slots x 12 heads) the 96 blocks do not fill
// 132 SMs; a split-KV (flash-decoding) redesign is queued in ROADMAP.md.
#include "decode_core.cuh"

namespace {

constexpr int kThreads = mxtt::kDecodeThreads;

// Key row t of one (slot, head) of a dense (B, H, S, D) cache of T; an
// int8 cache gives every key the (slot, head)'s K and V scales.
template <class T>
struct DenseRows {
  const T* k;
  const T* v;
  long long k_ss, v_ss;
  float k_mul, v_mul;
  static constexpr bool kIndirect = sizeof(T) == 1;
  static constexpr bool kKeyScales = sizeof(T) == 1;
  __device__ __forceinline__ void offsets(int t, long long& ko, long long& vo,
                                          float& ks, float& vs) const {
    ko = (long long)t * k_ss;
    vo = (long long)t * v_ss;
    ks = k_mul;
    vs = v_mul;
  }
};

// k_scale / v_scale: (B, H) contiguous fp32 for an int8 cache, unused
// (null) for fp32.
template <int D, int NR, class T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, float* __restrict__ out, int H,
              int Sq, int S, float scale, long long q_sb, long long q_sh,
              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
              long long v_sb, long long v_sh, long long v_ss) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const int nr = min(NR, Sq - r0);
  const int len = max(0, min(lengths[b], S));
  float k_mul = 1.f, v_mul = 1.f;
  if constexpr (sizeof(T) == 1) {
    if (len > 0) {
      k_mul = __ldg(k_scale + b * H + h);
      v_mul = __ldg(v_scale + b * H + h);
    }
  }
  const DenseRows<T> rows{k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh,
                          k_ss, v_ss, k_mul, v_mul};
  mxtt::decode_block<D, NR>(q + b * q_sb + h * q_sh, q_ss, r0, nr, len,
                            scale, rows,
                            out + (((long long)b * H + h) * Sq + r0) * D);
}

template <int D, class T>
cudaError_t launch(const float* q, const T* k, const T* v,
                   const float* k_scale, const float* v_scale,
                   const int* lengths, float* out, int B, int H, int Sq, int S,
                   float scale, const long long* st, cudaStream_t stream) {
  if (Sq == 1) {
    decode_kernel<D, 1, T><<<dim3(H, B, 1), kThreads, 0, stream>>>(
        q, k, v, k_scale, v_scale, lengths, out, H, Sq, S, scale, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  } else {
    constexpr int NR = 4;
    decode_kernel<D, NR, T><<<dim3(H, B, (Sq + NR - 1) / NR), kThreads, 0,
                              stream>>>(q, k, v, k_scale, v_scale, lengths,
                                        out, H, Sq, S, scale, st[0], st[1],
                                        st[2], st[3], st[4], st[5], st[6],
                                        st[7], st[8]);
  }
  return cudaGetLastError();
}

template <class T>
int dispatch(const float* q, const T* k, const T* v, const float* k_scale,
             const float* v_scale, const int* lengths, float* out, int B,
             int H, int Sq, int S, int D, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, k_scale, v_scale, lengths, out, B, H, Sq, S,
                        scale, strides, s);
    case 32:
      return launch<32>(q, k, v, k_scale, v_scale, lengths, out, B, H, Sq, S,
                        scale, strides, s);
    case 64:
      return launch<64>(q, k, v, k_scale, v_scale, lengths, out, B, H, Sq, S,
                        scale, strides, s);
    case 128:
      return launch<128>(q, k, v, k_scale, v_scale, lengths, out, B, H, Sq, S,
                         scale, strides, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  return dispatch<float>(q, k, v, nullptr, nullptr, lengths, out, B, H, Sq, S,
                         D, scale, strides, stream);
}

// The int8 instance: k / v are (B, H, S, D) int8 with a contiguous last
// axis and 16-byte aligned rows (``strides`` in elements, i.e. bytes);
// k_scale / v_scale are contiguous (B, H) fp32 on the device. The rest
// as above.
int mxtt_decode_attention_int8(const float* q, const int8_t* k,
                               const int8_t* v, const float* k_scale,
                               const float* v_scale, const int* lengths,
                               float* out, int B, int H, int Sq, int S, int D,
                               float scale, const long long* strides,
                               void* stream) {
  return dispatch<int8_t>(q, k, v, k_scale, v_scale, lengths, out, B, H, Sq,
                          S, D, scale, strides, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
