// K3 — decode attention over a PAGED KV cache, fp32 or int8, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py paged_decode_attention_pallas
// (kernel body _paged_decode_fwd_kernel -> _decode_fwd_kernel), both
// variants: an fp32 pool, and an int8 pool with (n_pages, H) fp32
// scales. Same function: every query row of slot b attends the slot's
// keys [0, lengths[b]), where logical key t lives in pool page
// table[b, t / ps] at row t % ps (dequantized with that page's per-head
// scales in the int8 instance); lengths[b] == 0 gives zeros. It equals
// decode attention over the gathered (and dequantized) view
// (gather_pages, expand_page_scales), which is the plain version it is
// held to.
//
// What bounds it on the H100: bytes, as for K2 — each valid K and V
// row is read once, 2 * sum(len) * H * D * 4 bytes per layer in fp32, a
// quarter of that in int8, at one to four FLOP per byte.
//
// What the design does about it:
// - The TPU kernel's grid walks (slot, head, page-slot) with the table
//   scalar-prefetched into its index maps, clamping steps past the
//   last valid page. Here one thread block per (head, slot, group of
//   query rows) runs K2's block body (decode_core.cuh) with a row
//   policy that looks each key's page up in the slot's table row; the
//   block reads the table itself (no scalar prefetch), through the
//   read-only cache, once per key and chunk (the V loop gets each row's
//   offset by shuffle), and the loop covers [0, len) only, so pages past
//   ceil(len / ps) are never touched and no row at or past the length
//   is loaded: garbage, even NaN, in the scrap page 0, in a slot's
//   reserved-but-unwritten pages or in recycled pages never reaches a
//   sum.
// - The int8 instance reads each key's two page scales with the same
//   table lookup (only for keys before the length, so no scale of a
//   page past it is read, and the scrap page's or an unreferenced
//   page's scale may be anything, NaN included); the score takes the
//   K scale, and p the V scale, shuffled into the V loop beside the
//   row offset.
// - A page of one head is ps x D contiguous elements (4 KB fp32, 1 KB
//   int8 at 16 x 64): a lane's K row is read with 16-byte loads, and a
//   V row is read coalesced across the warp.
// - Table entries are clamped to [0, n_pages): a corrupt entry reads a
//   wrong page instead of faulting the card. An inactive engine row's
//   table may alias pages another slot owns; the kernel only reads
//   them and the engine ignores that row's logits.
// - Peek (prefix hits) runs the same kernel at B = 1.
#include "decode_core.cuh"

namespace {

constexpr int kThreads = mxtt::kDecodeThreads;

// Key row t of one (slot, head) of a (n_pages, H, ps, D) pool of T: k
// and v already point at head h of page 0, page_stride = H * ps * D;
// for an int8 pool k_scale / v_scale point at head h of page 0's
// (n_pages, H) scales.
template <class T>
struct PagedRows {
  const T* k;
  const T* v;
  const int* table;   // the slot's (P_max,) row
  const float* k_scale;
  const float* v_scale;
  int ps, D, H, n_pages;
  long long page_stride;
  static constexpr bool kIndirect = true;
  static constexpr bool kKeyScales = sizeof(T) == 1;
  __device__ __forceinline__ void offsets(int t, long long& ko, long long& vo,
                                          float& ks, float& vs) const {
    const int lp = t / ps;
    const int pg = min(max(__ldg(table + lp), 0), n_pages - 1);
    ko = vo = (long long)pg * page_stride + (long long)(t - lp * ps) * D;
    if constexpr (kKeyScales) {
      ks = __ldg(k_scale + (long long)pg * H);
      vs = __ldg(v_scale + (long long)pg * H);
    }
  }
};

template <int D, int NR, class T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int H, int Sq, int ps, int P_max, int n_pages, float scale,
                    long long q_sb, long long q_sh, long long q_ss) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const int nr = min(NR, Sq - r0);
  const int len = max(0, min(lengths[b], P_max * ps));
  const long long head = (long long)h * ps * D;
  const PagedRows<T> rows{k_pool + head,
                          v_pool + head,
                          table + (long long)b * P_max,
                          k_scale + h,
                          v_scale + h,
                          ps,
                          D,
                          H,
                          n_pages,
                          (long long)H * ps * D};
  mxtt::decode_block<D, NR>(q + b * q_sb + h * q_sh, q_ss, r0, nr, len,
                            scale, rows,
                            out + (((long long)b * H + h) * Sq + r0) * D);
}

template <int D, class T>
cudaError_t launch(const float* q, const T* k_pool, const T* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* lengths, float* out, int B,
                   int H, int Sq, int ps, int P_max, int n_pages, float scale,
                   const long long* st, cudaStream_t stream) {
  if (Sq == 1) {
    paged_decode_kernel<D, 1, T><<<dim3(H, B, 1), kThreads, 0, stream>>>(
        q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, H, Sq, ps,
        P_max, n_pages, scale, st[0], st[1], st[2]);
  } else {
    constexpr int NR = 4;
    paged_decode_kernel<D, NR, T>
        <<<dim3(H, B, (Sq + NR - 1) / NR), kThreads, 0, stream>>>(
            q, k_pool, v_pool, k_scale, v_scale, table, lengths, out, H, Sq,
            ps, P_max, n_pages, scale, st[0], st[1], st[2]);
  }
  return cudaGetLastError();
}

template <class T>
int dispatch(const float* q, const T* k_pool, const T* v_pool,
             const float* k_scale, const float* v_scale, const int* table,
             const int* lengths, float* out, int B, int H, int Sq, int D,
             int ps, int P_max, int n_pages, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (ps < 1 || P_max < 1 || n_pages < 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                        out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    case 32:
      return launch<32>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                        out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    case 64:
      return launch<64>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                        out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    case 128:
      return launch<128>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                         out, B, H, Sq, ps, P_max, n_pages, scale, strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D) fp32 with a contiguous last axis; ``strides`` holds
// its (b, h, s) element strides. k_pool / v_pool: contiguous
// (n_pages, H, ps, D) fp32. table: contiguous (B, P_max) int32;
// lengths: (B,) int32; both on the device. out: (B, H, Sq, D)
// contiguous fp32. Returns the launch's cudaError_t.
int mxtt_paged_decode_attention(const float* q, const float* k_pool,
                                const float* v_pool, const int* table,
                                const int* lengths, float* out, int B, int H,
                                int Sq, int D, int ps, int P_max, int n_pages,
                                float scale, const long long* strides,
                                void* stream) {
  return dispatch<float>(q, k_pool, v_pool, nullptr, nullptr, table, lengths,
                         out, B, H, Sq, D, ps, P_max, n_pages, scale, strides,
                         stream);
}

// The int8 instance: k_pool / v_pool are contiguous (n_pages, H, ps, D)
// int8, 16-byte aligned; k_scale / v_scale contiguous (n_pages, H) fp32
// on the device. The rest as above.
int mxtt_paged_decode_attention_int8(
    const float* q, const int8_t* k_pool, const int8_t* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, float* out, int B, int H, int Sq, int D, int ps,
    int P_max, int n_pages, float scale, const long long* strides,
    void* stream) {
  return dispatch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                          out, B, H, Sq, D, ps, P_max, n_pages, scale, strides,
                          stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
