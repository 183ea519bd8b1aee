// K2 — decode attention over a dense KV cache, fp32, int8, bf16 or float16,
// for
// Hopper (sm_90a): a split-KV (flash-decoding) kernel in one launch, each
// (slot, head, group of query rows) split across a thread-block cluster.
//
// Replaces: mxnet_tpu/ops/attention.py decode_attention_pallas (kernel
// body _decode_fwd_kernel), every variant: fp32, int8 K/V with (B, H)
// fp32 scales (quant=True), and bf16 or float16 K/V (the reference's
// kernel is dtype-generic: it loads the 16-bit block and widens it to
// fp32). Same
// function: every query row of slot b attends keys [0, lengths[b]) of
// its cache row, with no causal structure among the queries;
// lengths[b] == 0 gives zeros. The int8 instance attends
// K = k * k_scale[b, h] and V = v * v_scale[b, h]; the bf16 (float16)
// instance reads the 16-bit rows (half the bytes of fp32), widens them in
// registers, takes q as fp32 or of the cache's type and writes an output
// of the cache's type.
//
// What bounds it on the H100: bytes. One decode step reads each valid K and
// V row once — 2 * sum(len) * H * D * 4 bytes per layer in fp32, half of
// that in bf16, a quarter in int8 — and does 4 * D FLOP per (query, key)
// pair, one to four FLOP per byte, far below the card's ~20 FLOP per byte
// for fp32. At 8 slots x 12 heads x lengths up to 1024 that is 16 MB, 5 us
// at 3.35 TB/s.
//
// What the design does about it. The earlier kernel ran one block per
// (slot, head): 96 blocks on 132 SMs, each walking its slot's whole
// prefix with a few hundred bytes in flight per warp. Here:
// - Split-KV across a cluster. plan() sizes a cluster of S <= 8 blocks
//   from the cache's S_max: each rank owns ceil(S_max / 8) keys rounded
//   up to a warp's 32 (128 keys, 8 ranks, at the engine's S_max = 1024).
//   A long slot is read by 8 SMs; a rank whose range starts at or past
//   the slot's length copies nothing and leaves after one relaxed
//   cluster arrive/wait, freeing its SM for the next clusters.
// - One memory latency before the copies. The length, q and, in the
//   int8 instance, the slot's two scales all go out at once (none needs
//   the length). Then warp 0 issues the rank's K and V rows below the
//   length as cp.async.bulk copies into shared memory (the TMA's 1D
//   form), all completing on one mbarrier: a (slot, head) row of a
//   cache whose rows are contiguous (k_ss == D) is one run of memory,
//   copied in pieces of 4 KB, one a lane; a cache whose rows are strided
//   (a row-strided view) takes one copy a row, on the same barrier.
//   Rows are 16-512 bytes (int8 at D 16 to fp32 at D 128), multiples of
//   16, so exactly the valid rows arrive: no garbage row ever reaches
//   shared memory, and no row at or past the length is read at all.
// - The cluster body is split_decode.cuh's, shared with K3 (the paged
//   cache) through a row source, DenseRows below: per-warp online
//   softmax from shared memory with no block-wide barrier in the loop,
//   and the ranks merged with st.async into rank 0 in rank order (no
//   second launch, no global scratch, no atomics: deterministic).
// - A rank holds at most kBudget bytes of rows; a longer range runs in
//   batches through the same buffers. At the engine's shapes one batch
//   holds all (64 KB fp32, 32 KB bf16, 16 KB int8).
// - Decode (one query per slot) runs a one-row instance; 2..R queries
//   run four rows per cluster, so the rows are read once for the four.
#include <stdint.h>

#include <algorithm>

#include "split_decode.cuh"

namespace {

using mxtt::kBudget;
using mxtt::kMaxRanks;

// a rank's keys are a multiple of one warp chunk
constexpr int kRowAlign = 32;
// bytes a bulk copy carries on the contiguous path
constexpr int kCopyBytes = 4096;

// How a launch splits the cache rows: a cluster of S ranks, each owning
// ``rows`` keys, at most ``batch`` of them in shared memory at once.
struct Plan {
  int S, rows, batch;
  size_t smem;
};

Plan plan(int S_max, int D, int elem) {
  Plan p;
  S_max = std::max(S_max, 1);
  const int rpr = (S_max + kMaxRanks - 1) / kMaxRanks;
  p.rows = (rpr + kRowAlign - 1) / kRowAlign * kRowAlign;
  p.S = (S_max + p.rows - 1) / p.rows;
  const int row_bytes = 2 * D * elem;   // K and V of one key
  p.batch = std::min(p.rows, kBudget / row_bytes);
  p.smem = (size_t)p.batch * row_bytes;
  return p;
}

// The row source of one (slot, head) of a dense cache: key t is row t of
// the (slot, head)'s rows, ``k_ss`` / ``v_ss`` elements apart. Only rows
// before the length are copied. An int8 cache gives every key the
// (slot, head)'s two scales.
template <int D, class T>
struct DenseRows {
  const T* k;   // the (slot, head)'s row 0
  const T* v;
  const float* k_scale;   // the (slot, head)'s scales (int8)
  const float* v_scale;
  const int* lengths;
  long long k_ss, v_ss;
  int b, S_max;
  float k_mul = 1.f, v_mul = 1.f;

  __device__ __forceinline__ int length() const {
    return max(0, min(__ldg(lengths + b), S_max));
  }

  // int8: the slot's two scales, every thread (one address each)
  __device__ __forceinline__ void prefetch(int, int) {
    if constexpr (sizeof(T) == 1) {
      k_mul = __ldg(k_scale);
      v_mul = __ldg(v_scale);
    }
  }

  // rows [rb, rb + nk): in pieces of kCopyBytes a lane where both
  // caches' rows are contiguous, else a row a lane; then the batch's one
  // arrival
  __device__ __forceinline__ void issue(int, int rb, int nk, T* k_buf,
                                        T* v_buf, float*, unsigned bar,
                                        int lane) const {
    constexpr unsigned kRowBytes = D * sizeof(T);
    constexpr int kPiece =
        kCopyBytes / (int)kRowBytes > 1 ? kCopyBytes / (int)kRowBytes : 1;
    const int piece = k_ss == D && v_ss == D ? kPiece : 1;
    if (lane == 0) mxtt::mbar_expect_tx(bar, 2u * nk * kRowBytes);
    __syncwarp();
    for (int i = lane * piece; i < nk; i += 32 * piece) {
      const unsigned bytes = (unsigned)min(piece, nk - i) * kRowBytes;
      mxtt::bulk_copy(k_buf + (size_t)i * D, k + (long long)(rb + i) * k_ss,
                      bytes, bar);
      mxtt::bulk_copy(v_buf + (size_t)i * D, v + (long long)(rb + i) * v_ss,
                      bytes, bar);
    }
    __syncwarp();
    if (lane == 0) mxtt::mbar_arrive(bar);
  }

  __device__ __forceinline__ void scales(int, const float*, float& ks,
                                         float& vs) const {
    ks = k_mul;
    vs = v_mul;
  }
};

// k_scale / v_scale: (B, H) contiguous fp32 for an int8 cache, unused
// (null) otherwise. q is fp32, or of the cache's type where q_half (a
// 16-bit cache only); out is split_out_t<T>.
template <int D, int NR, class T>
__global__ void __launch_bounds__(mxtt::kSplitThreads,
                                  mxtt::kSplitMinBlocks<T, NR>)
decode_split_kernel(const void* __restrict__ q, int q_half,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths, void* __restrict__ out,
                    int H, int Sq, int S_max, int rows, int batch,
                    float scale, long long q_sb, long long q_sh,
                    long long q_ss, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss) {
  const int S = (int)cooperative_groups::this_cluster().num_blocks();
  const int h = blockIdx.x / S;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const long long bh = (long long)b * H + h;
  constexpr bool kInt8 = sizeof(T) == 1;
  DenseRows<D, T> src{k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh,
                      kInt8 ? k_scale + bh : nullptr,
                      kInt8 ? v_scale + bh : nullptr, lengths, k_ss, v_ss, b,
                      S_max};
  mxtt::split_decode<D, NR, T>(
      src, mxtt::q_at<T>(q, q_half, b * q_sb + h * q_sh), q_half, q_ss, r0,
      min(NR, Sq - r0), rows, batch, scale,
      static_cast<mxtt::split_out_t<T>*>(out) + (bh * Sq + r0) * D);
}

template <int D, int NR, class T>
cudaError_t launch_rows(const void* q, int q_half, const T* k, const T* v,
                        const float* k_scale, const float* v_scale,
                        const int* lengths, void* out, int B, int H, int Sq,
                        int S_max, float scale, const long long* st,
                        cudaStream_t stream) {
  const Plan p = plan(S_max, D, (int)sizeof(T));
  return mxtt::launch_split<decode_split_kernel<D, NR, T>>(
      dim3(H * p.S, B, (Sq + NR - 1) / NR), p.S, p.smem, stream, q, q_half,
      k, v, k_scale, v_scale, lengths, out, H, Sq, S_max, p.rows, p.batch,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
}

template <int D, class T>
cudaError_t launch(const void* q, int q_half, const T* k, const T* v,
                   const float* k_scale, const float* v_scale,
                   const int* lengths, void* out, int B, int H, int Sq,
                   int S_max, float scale, const long long* st,
                   cudaStream_t stream) {
  if (Sq == 1)
    return launch_rows<D, 1, T>(q, q_half, k, v, k_scale, v_scale, lengths,
                                out, B, H, Sq, S_max, scale, st, stream);
  return launch_rows<D, 4, T>(q, q_half, k, v, k_scale, v_scale, lengths,
                              out, B, H, Sq, S_max, scale, st, stream);
}

template <class T>
int dispatch(const void* q, int q_half, const T* k, const T* v,
             const float* k_scale, const float* v_scale, const int* lengths,
             void* out, int B, int H, int Sq, int S, int D, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  switch (D) {
    case 16:
      return launch<16>(q, q_half, k, v, k_scale, v_scale, lengths, out, B, H,
                        Sq, S, scale, strides, s);
    case 32:
      return launch<32>(q, q_half, k, v, k_scale, v_scale, lengths, out, B, H,
                        Sq, S, scale, strides, s);
    case 64:
      return launch<64>(q, q_half, k, v, k_scale, v_scale, lengths, out, B, H,
                        Sq, S, scale, strides, s);
    case 128:
      return launch<128>(q, q_half, k, v, k_scale, v_scale, lengths, out, B,
                         H, Sq, S, scale, strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D); k / v: (B, H, S, D) cache buffers; all fp32 with a
// contiguous last axis, 16-byte aligned rows; ``strides`` holds the
// (b, h, s) element strides of q, k and v in that order. lengths: (B,)
// int32 on the device. out: (B, H, Sq, D) contiguous fp32. Returns the
// launch's cudaError_t.
int mxtt_decode_attention(const float* q, const float* k, const float* v,
                          const int* lengths, float* out, int B, int H,
                          int Sq, int S, int D, float scale,
                          const long long* strides, void* stream) {
  return dispatch<float>(q, 0, k, v, nullptr, nullptr, lengths, out, B, H, Sq,
                         S, D, scale, strides, stream);
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
  return dispatch<int8_t>(q, 0, k, v, k_scale, v_scale, lengths, out, B, H,
                          Sq, S, D, scale, strides, stream);
}

// The bf16 instance: k / v are (B, H, S, D) bf16 with a contiguous last
// axis and 16-byte aligned rows; q is fp32, or bf16 where ``q_half`` is
// non-zero (its rows 16-byte aligned), ``strides`` in elements of each
// tensor's own type. out: (B, H, Sq, D) contiguous bf16. The rest as
// above.
int mxtt_decode_attention_bf16(const void* q, int q_half, const mxtt::bf16* k,
                               const mxtt::bf16* v, const int* lengths,
                               mxtt::bf16* out, int B, int H, int Sq, int S,
                               int D, float scale, const long long* strides,
                               void* stream) {
  return dispatch<mxtt::bf16>(q, q_half, k, v, nullptr, nullptr, lengths, out,
                              B, H, Sq, S, D, scale, strides, stream);
}

// The float16 instance: k / v are (B, H, S, D) float16, q fp32 or (q_half)
// float16, out float16; otherwise as the bf16 instance.
int mxtt_decode_attention_f16(const void* q, int q_half, const mxtt::f16* k,
                              const mxtt::f16* v, const int* lengths,
                              mxtt::f16* out, int B, int H, int Sq, int S,
                              int D, float scale, const long long* strides,
                              void* stream) {
  return dispatch<mxtt::f16>(q, q_half, k, v, nullptr, nullptr, lengths, out,
                             B, H, Sq, S, D, scale, strides, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
