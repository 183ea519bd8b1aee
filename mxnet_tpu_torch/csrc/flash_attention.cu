// K1 — flash attention forward (fp32) for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py flash_attention_pallas
// (kernel body _flash_fwd_kernel). Same function: blockwise
// online-softmax attention over (B, H, S, D), causal or not, keys at or
// past kv_len masked, the causal diagonal end-aligned at
// offset = kv_len - Sq, fp32 running max / denominator / numerator,
// the l_safe guard, and outputs (out, lse).
//
// What bounds it on the H100: operations. At the prefill shape the
// two products do 4 * D FLOP per (query, visible key) pair against
// 16 * D bytes per row of q, k, v and out, so the work per byte grows
// with the sequence; the inputs are fp32 and the contract is fp32
// arithmetic, so the ceiling is the 67 TFLOP/s of the fp32 cores (no
// TF32 tensor cores: they keep ~10 mantissa bits).
//
// What the design does about it:
// - One thread block per (b * h, 32-row query tile); a loop inside the
//   block walks the K/V tiles (32 keys each) through shared memory —
//   the TPU kernel's sequential grid axis becomes that loop, and the
//   many (b * h, q-tile) blocks fill the 132 SMs.
// - Each warp owns 8 query rows; each lane owns one key of the tile for
//   the score product and D / 32 output columns for the P @ V product,
//   so every score and every output element is accumulated in
//   registers by exactly one thread (no atomics, no cross-warp sums).
// - The loop stops at the last tile the causal mask can reach for the
//   tile's last row: the upper triangle is never loaded.
// - Shared-memory rows are padded by 4 floats so the lanes' 16-byte
//   loads of 32 different K rows fall in distinct banks; q and p are
//   read as broadcasts.
// - The masked score is -1e30 (not -inf) and p is re-masked to 0 after
//   the exp, so a row that sees no key yet keeps m - m = 0 and l = 0;
//   such a row returns zeros (l_safe = 1).
// Later work (queued in ROADMAP.md): wgmma / TMA tiles on bf16 inputs.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per block
constexpr int kBlockK = 32;               // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

template <int D>
struct FlashSmem {
  static constexpr int kPad = D + 4;      // padded row (floats)
  static constexpr int kFloats =
      kBlockQ * kPad + kBlockK * kPad + kBlockK * D + kWarps * kRows * kBlockK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int kv_len,
                 int causal, float scale, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh,
                 long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss) {
  constexpr int P = FlashSmem<D>::kPad;
  constexpr int V4 = D / 4;                   // float4 per row
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output columns per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBlockQ][P]
  float* k_s = q_s + kBlockQ * P;                 // [kBlockK][P]
  float* v_s = k_s + kBlockK * P;                 // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;                 // [kWarps][kRows][kBlockK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const int offset = kv_len - Sq;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  // stage the scaled query tile; rows past Sq are zeros
  for (int i = tid; i < kBlockQ * V4; i += kThreads) {
    const int r = i / V4;
    const int c = (i - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = mxtt::load4(qb + (long long)(q0 + r) * q_ss + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(q_s + r * P + c) = x;
  }

  // last key any row of this tile may see
  int last = kv_len - 1;
  if (causal) last = min(last, q0 + kBlockQ - 1 + offset);
  const int n_tiles = last < 0 ? 0 : last / kBlockK + 1;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = MXTT_NEG_INF;
    l[r] = 0.f;   // this lane's share of the denominator
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  float* pw = p_s + warp * kRows * kBlockK;
  const float* qw = q_s + warp * kRows * P;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBlockK * V4; i += kThreads) {
      const int r = i / V4;
      const int c = (i - r * V4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < kv_len) {   // rows at or past kv_len are never read
        kx = mxtt::load4(kb + (long long)(k0 + r) * k_ss + c);
        vx = mxtt::load4(vb + (long long)(k0 + r) * v_ss + c);
      }
      *reinterpret_cast<float4*>(k_s + r * P + c) = kx;
      *reinterpret_cast<float4*>(v_s + r * D + c) = vx;
    }
    __syncthreads();

    // scores: lane = key, 8 rows per warp
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * P;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[r] = mxtt::dot4(*reinterpret_cast<const float4*>(qw + r * P + c),
                          kx, s[r]);
    }

    // online softmax, one row at a time
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qrow = q0 + warp * kRows + r;
      const bool valid = key < kv_len && (!causal || key <= qrow + offset);
      const float sv = valid ? s[r] : MXTT_NEG_INF;
      const float m_new = fmaxf(m[r], mxtt::warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.f;   // re-mask
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      pw[r * kBlockK + lane] = p;
    }
    __syncwarp();

    // P @ V: lane owns output columns lane + 32 * i
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[jj][i] = d < D ? v_s[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[r][i];
          a = fmaf(p4.x, vv[0][i], a);
          a = fmaf(p4.y, vv[1][i], a);
          a = fmaf(p4.z, vv[2][i], a);
          a = fmaf(p4.w, vv[3][i], a);
          acc[r][i] = a;
        }
      }
    }
    __syncwarp();
  }

  // epilogue: out = acc / l_safe, lse = m + log(l_safe)
  const long long row0 = (long long)bh * Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lt = mxtt::warp_sum(l[r]);
    const float l_safe = lt > 0.f ? lt : 1.f;
    const int qrow = q0 + warp * kRows + r;
    if (qrow < Sq) {
      float* orow = out + (row0 + qrow) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) orow[d] = acc[r][i] / l_safe;
      }
      if (lane == 0) lse[row0 + qrow] = m[r] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, int B, int H, int Sq, int kv_len, int causal,
                   float scale, const long long* st, cudaStream_t stream) {
  constexpr size_t bytes = FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, lse, H, Sq, kv_len, causal, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D), k / v: (B, H, Sk, D), all fp32 with a contiguous
// last axis; ``strides`` holds the (b, h, s) element strides of q, k
// and v in that order. out: (B, H, Sq, D) and lse: (B, H, Sq),
// contiguous fp32. Returns the cudaError_t of the launch.
int mxtt_flash_attention_fwd(const float* q, const float* k, const float* v,
                             float* out, float* lse, int B, int H, int Sq,
                             int D, int kv_len, int causal, float scale,
                             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
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

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
