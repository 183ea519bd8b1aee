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
// What bounds it on the H100: operations. Each visible (query, key) pair
// costs 14 D FLOP here (s and dp in both launches, then dq, dk and dv)
// against the 16-bit or fp32 rows of six (B, H, S, D) tensors, so the
// work per byte grows with the sequence. This first kernel runs them on
// the fp32 CUDA cores (67 TFLOP/s), not the tensor cores: a simple SIMT
// design that is right comes first, and moving its products onto
// mma.sync / wgmma with TMA tiles is later work.
//
// Two launches, no atomics:
// - flash_bwd_dq_kernel, one block per (batch x head, 64-row query tile):
//   computes delta for its rows (written to a scratch row for the second
//   launch), then walks the key tiles up to kv_len and, causal, up to the
//   diagonal of its last row, accumulating dq in registers;
// - flash_bwd_dkv_kernel, one block per (batch x head, 64-key tile):
//   walks the query tiles from the first row that sees its first key,
//   accumulating dk and dv in registers; key rows at or past kv_len are
//   written as exact zeros, and their K/V rows are never read.
// Inside a block, 256 threads in a 16 x 16 grid each own a 4 x 4
// micro-tile of the 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j), read as 16-byte shared-memory loads over the head dim
// (rows padded to D + 4 floats: a quarter warp's 8 rows land on 8
// distinct bank groups at every head dim), and then the columns
// tx + 16 m of the 64 x D gradient tile. Tiles are widened to fp32 in
// shared memory as they are loaded; rows outside the view load as zeros.
#include "common.cuh"

namespace {

constexpr int kTile = 64;      // query rows / keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPad = 4;        // floats of padding after each row

// The (b, h, s) element strides of q, k, v, out and dO, in that order.
struct Strides {
  long long q[3], k[3], v[3], o[3], d[3];
};

template <int D>
struct BwdSmem {
  static_assert(D % 16 == 0, "head dims are multiples of 16");
  static constexpr int kRow = D + kPad;        // a Q, dO, K or V row
  static constexpr int kPRow = kTile + kPad;   // a P or dS row
  static constexpr int kTileElems = kTile * kRow;
  static constexpr int kCols = D / 16;         // gradient columns a thread
  // Q, dO, K, V tiles; P and dS (dkv) or dS (dq); lse and delta
  static constexpr size_t kBytesDq =
      (4 * kTileElems + kTile * kPRow + 2 * kTile) * sizeof(float);
  static constexpr size_t kBytesDkv =
      (4 * kTileElems + 2 * kTile * kPRow + 2 * kTile) * sizeof(float);
};

template <class T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same_v<T, float>)
    return x;
  else if constexpr (std::is_same_v<T, mxtt::bf16>)
    return __bfloat162float(x);
  else
    return __half2float(x);
}

template <class T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, float>)
    return x;
  else if constexpr (std::is_same_v<T, mxtt::bf16>)
    return __float2bfloat16_rn(x);
  else
    return __float2half_rn(x);
}

// four consecutive elements (16 bytes of fp32, 8 of a 16-bit type),
// widened to fp32
template <class T>
__device__ __forceinline__ float4 load4_widen(const T* p) {
  if constexpr (std::is_same_v<T, float>)
    return mxtt::load4(p);
  else
    return mxtt::half4_widen<T>(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + 64) of one (b, h) slice of a view with row stride
// ``st``, widened into ``dst`` (rows of D + kPad floats); rows at or past
// ``rows`` load as zeros and are not read.
template <int D, class T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long st, int row0, int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = load4_widen(base + (long long)(row0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * BwdSmem<D>::kRow + c) = x;
  }
}

// s = A_rows . B_rows and dp = C_rows . E_rows over the head dim for the
// thread's 4 x 4 micro-tile: rows ty + 16 i of A and C, rows tx + 16 j of
// B and E.
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          const float* C, const float* E,
                                          int ty, int tx, float (&s)[4][4],
                                          float (&dp)[4][4]) {
  constexpr int R = BwdSmem<D>::kRow;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = lds4(A + (ty + 16 * i) * R + d);
      c[i] = lds4(C + (ty + 16 * i) * R + d);
      b[i] = lds4(B + (tx + 16 * i) * R + d);
      e[i] = lds4(E + (tx + 16 * i) * R + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mxtt::dot4(a[i], b[j], s[i][j]);
        dp[i][j] = mxtt::dot4(c[i], e[j], dp[i][j]);
      }
  }
}

template <int D, class T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        float* __restrict__ delta, int H, int Sq,
                        int kv_len, int causal, float scale, Strides st) {
  using S = BwdSmem<D>;
  constexpr int R = S::kRow, PR = S::kPRow, NC = S::kCols;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + S::kTileElems;
  float* Ks = dOs + S::kTileElems;
  float* Vs = Ks + S::kTileElems;
  float* dSs = Vs + S::kTileElems;
  float* lse_s = dSs + kTile * PR;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const long long rows = (long long)bh * Sq;   // this slice's lse/delta/dq
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const T* ob = o + b * st.o[0] + h * st.o[1];
  const T* db = dout + b * st.d[0] + h * st.d[1];

  load_tile<D, T>(Qs, qb, st.q[2], q0, Sq);
  load_tile<D, T>(dOs, db, st.d[2], q0, Sq);
  __syncthreads();
  // delta = sum_d dO * out, a warp per row
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int gr = q0 + r;
    float acc = 0.f;
    if (gr < Sq)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(dOs[r * R + c], to_f32(ob[(long long)gr * st.o[2] + c]),
                   acc);
    acc = mxtt::warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = gr < Sq ? lse[rows + gr] : 0.f;
      if (gr < Sq) delta[rows + gr] = acc;
    }
  }

  const int offset = kv_len - Sq;
  const int q_last = min(q0 + kTile, Sq) - 1;
  const int k_end = causal ? min(kv_len, q_last + offset + 1) : kv_len;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[i][m] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the last tile's K, V and dS are consumed
    load_tile<D, T>(Ks, kb, st.k[2], k0, kv_len);
    load_tile<D, T>(Vs, vb, st.v[2], k0, kv_len);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, gr = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = k0 + tx + 16 * j;
        const bool valid =
            gr < Sq && gc < kv_len && (!causal || gc <= gr + offset);
        const float p = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * PR + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    // dq += dS K over the tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dSs[(ty + 16 * i) * PR + kk];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float kv = Ks[kk * R + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][m] = fmaf(a[i], kv, acc[i][m]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= Sq) continue;
#pragma unroll
    for (int m = 0; m < NC; ++m)
      dq[(rows + gr) * D + tx + 16 * m] = from_f32<T>(acc[i][m]);
  }
}

template <int D, class T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H,
                         int Sq, int Sk, int kv_len, int causal,
                         float scale, Strides st) {
  using S = BwdSmem<D>;
  constexpr int R = S::kRow, PR = S::kPRow, NC = S::kCols;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + S::kTileElems;
  float* Qs = Vs + S::kTileElems;
  float* dOs = Qs + S::kTileElems;
  float* Ps = dOs + S::kTileElems;
  float* dSs = Ps + kTile * PR;
  float* lse_s = dSs + kTile * PR;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long rows = (long long)bh * Sq;   // lse and delta
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NC; ++m) dk_acc[i][m] = dv_acc[i][m] = 0.f;

  if (k0 < kv_len) {
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* kb = k + b * st.k[0] + h * st.k[1];
    const T* vb = v + b * st.v[0] + h * st.v[1];
    const T* db = dout + b * st.d[0] + h * st.d[1];
    load_tile<D, T>(Ks, kb, st.k[2], k0, kv_len);
    load_tile<D, T>(Vs, vb, st.v[2], k0, kv_len);
    const int offset = kv_len - Sq;
    // the first query row that sees key k0, rounded down to its tile
    const int q_begin = causal ? max(0, k0 - offset) / kTile * kTile : 0;
    for (int q0 = q_begin; q0 < Sq; q0 += kTile) {
      __syncthreads();   // the last tile's Q, dO, P and dS are consumed
      load_tile<D, T>(Qs, qb, st.q[2], q0, Sq);
      load_tile<D, T>(dOs, db, st.d[2], q0, Sq);
      if (tid < kTile) {
        const int gr = q0 + tid;
        lse_s[tid] = gr < Sq ? lse[rows + gr] : 0.f;
        delta_s[tid] = gr < Sq ? delta[rows + gr] : 0.f;
      }
      __syncthreads();
      // the transposed tile: rows are keys, columns queries
      float s[4][4], dp[4][4];
      tile_dots<D>(Ks, Qs, Vs, dOs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, key = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, gq = q0 + c;
          const bool valid =
              gq < Sq && key < kv_len && (!causal || key <= gq + offset);
          const float p = valid ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
          Ps[r * PR + c] = p;
          dSs[r * PR + c] = p * (dp[i][j] - delta_s[c]) * scale;
        }
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q over the tile's queries
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[(ty + 16 * i) * PR + qq];
          sa[i] = dSs[(ty + 16 * i) * PR + qq];
        }
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const float dov = dOs[qq * R + tx + 16 * m];
          const float qv = Qs[qq * R + tx + 16 * m];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][m] = fmaf(pa[i], dov, dv_acc[i][m]);
            dk_acc[i][m] = fmaf(sa[i], qv, dk_acc[i][m]);
          }
        }
      }
    }
  }
  const long long krows = (long long)bh * Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const bool live = key < kv_len;   // rows past kv_len: exact zeros
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const long long at = (krows + key) * D + tx + 16 * m;
      dk[at] = from_f32<T>(live ? dk_acc[i][m] : 0.f);
      dv[at] = from_f32<T>(live ? dv_acc[i][m] : 0.f);
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

template <class T>
int dq_launch(const T* q, const T* k, const T* v, const T* o, const T* dout,
              const float* lse, T* dq, float* delta, int B, int H, int Sq,
              int D, int kv_len, int causal, float scale,
              const long long* strides, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if ((Sq + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess)
    return err;
  return by_head_dim(D, [&](auto d) -> cudaError_t {
    constexpr int kD = decltype(d)::value;
    constexpr size_t kBytes = BwdSmem<kD>::kBytesDq;
    const cudaError_t err =
        mxtt::raise_smem_limit<flash_bwd_dq_kernel<kD, T>, kBytes>(dev);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Sq + kTile - 1) / kTile);
    flash_bwd_dq_kernel<kD, T>
        <<<grid, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
            q, k, v, o, dout, lse, dq, delta, H, Sq, kv_len, causal, scale,
            st);
    return cudaGetLastError();
  });
}

template <class T>
int dkv_launch(const T* q, const T* k, const T* v, const T* dout,
               const float* lse, const float* delta, T* dk, T* dv, int B,
               int H, int Sq, int Sk, int D, int kv_len, int causal,
               float scale, const long long* strides, void* stream) {
  if (B * H == 0 || Sk == 0) return cudaSuccess;
  if ((Sk + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess)
    return err;
  return by_head_dim(D, [&](auto d) -> cudaError_t {
    constexpr int kD = decltype(d)::value;
    constexpr size_t kBytes = BwdSmem<kD>::kBytesDkv;
    const cudaError_t err =
        mxtt::raise_smem_limit<flash_bwd_dkv_kernel<kD, T>, kBytes>(dev);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Sk + kTile - 1) / kTile);
    flash_bwd_dkv_kernel<kD, T>
        <<<grid, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
            q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, kv_len, causal,
            scale, st);
    return cudaGetLastError();
  });
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
    (void)Sk;                                                               \
    return dq_launch<T>(q, k, v, o, dout, lse, dq, delta, B, H, Sq, D,      \
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
