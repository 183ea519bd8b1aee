// K3 — decode attention over a PAGED KV cache, fp32, int8, bf16 or
// float16, for Hopper (sm_90a): a split-KV (flash-decoding) kernel in one launch, each
// (slot, head, group of query rows) split across a thread-block cluster.
//
// Replaces: mxnet_tpu/ops/attention.py paged_decode_attention_pallas
// (kernel body _paged_decode_fwd_kernel -> _decode_fwd_kernel), every
// variant: an fp32 pool, an int8 pool with (n_pages, H) fp32 scales, and a
// bf16 or float16 pool (widened in registers; q fp32 or of the pool's
// type, an output of the pool's type, as K2's 16-bit instances). Same function: every query row of slot b attends the
// slot's keys [0, lengths[b]), where logical key t lives in pool page
// table[b, t / ps] at row t % ps (dequantized with that page's per-head
// scales in the int8 instance); lengths[b] == 0 gives zeros. It equals
// decode attention over the gathered (and dequantized) view (gather_pages,
// expand_page_scales), which is the plain version it is held to.
//
// What bounds it on the H100: bytes. Each valid page's K and V rows of one
// head are read once, 2 * sum(len) * H * D * 4 bytes per layer in fp32
// (half of that in bf16, a quarter in int8), plus q, the table and the
// output, at one to four FLOP per byte; at 8 slots x 12 heads x lengths up
// to 1024 that is 16 MB, 4.8 us at 3.35 TB/s.
//
// What the design does about it. The earlier kernel ran one block per
// (slot, head): 96 blocks on 132 SMs, a few hundred bytes in flight per
// warp, and two dependent loads, a table entry and then the row, before
// any K byte. Here:
// - Split-KV across a cluster. The launch sizes a cluster of S <= 8
//   blocks from P_max (plan()): each rank owns ceil(P_max / S) logical
//   pages (8 pages, 128 keys, at the engine's P_max = 64). A long slot
//   is read by S SMs; a rank whose range starts at or past the slot's
//   length copies nothing and leaves after the cluster's first barrier,
//   freeing its SM for the next clusters.
// - One memory latency before the copies. The length, warp 0's table
//   entries for the rank's pages (read whatever the length: the table
//   row is valid memory) and q all go out at once. Then warp 0 issues
//   every page of the rank at once, one lane a page: its entry (clamped
//   to [0, n_pages)), in the int8 instance its page's two scales (once
//   per page, loaded ahead of the copies so they do not queue behind
//   them), and the page's K and V copies into shared memory with
//   cp.async.bulk (the TMA's 1D form: one instruction per head page of
//   ps x D contiguous elements, 4 KB fp32, 2 KB bf16 or 1 KB int8 at
//   16 x 64), all
//   completing on one mbarrier; 64 KB in flight per rank at the
//   engine's fp32 shapes.
// - The cluster body is split_decode.cuh's, shared with K2 (the dense
//   cache) through a row source, PagedRows below: per-warp online
//   softmax from shared memory with no block-wide barrier in the loop,
//   and the ranks merged with st.async into rank 0 in rank order (no
//   second launch, no global scratch, no atomics: deterministic).
// - Rows past the length never reach a sum: the last valid page
//   arrives whole, so its rows at or past len (garbage, even NaN) are
//   in shared memory, but no score is computed for them and no V row of
//   them is read. Pages at or past ceil(len / ps) are never copied and
//   their scales never read; the scrap page 0 is never touched through
//   them. In the int8 instance the K scale multiplies the score and the
//   V scale p, once per key, from the page's entry in shared memory.
// - A rank holds at most kBudget bytes of pages; a longer range runs in
//   batches through the same buffers (the warps' online softmax runs on
//   across batches), and a page too large for the budget is copied in
//   parts of ps / parts rows. At the engine's shapes one batch holds all.
// - 2..R query rows run four rows per cluster (the pages are read once
//   for the four); the peek (prefix hits) is the same kernel at B = 1.
// - A corrupt table entry reads a wrong page instead of faulting the
//   card. An inactive engine row's table may alias pages another slot
//   owns; the kernel only reads them and the engine ignores that row's
//   logits.
#include <stdint.h>

#include <algorithm>

#include "split_decode.cuh"

namespace {

using mxtt::kBudget;
using mxtt::kMaxRanks;

// How a launch splits the pages: a cluster of S ranks, each owning
// ``upr`` units of ps / parts rows (a unit is a whole page unless a page
// exceeds the budget), at most ``batch`` units in shared memory at once.
struct Plan {
  int S, parts, upr, batch;
  size_t smem;
};

Plan plan(int P_max, int ps, int D, int elem, int NR) {
  Plan p;
  const int ppr = (P_max + kMaxRanks - 1) / kMaxRanks;   // pages per rank
  p.S = (P_max + ppr - 1) / ppr;
  const int row_bytes = 2 * D * elem;   // K and V of one key
  // a unit's K and V (unit * D * elem is a multiple of 16) and its two
  // scales fit the budget
  p.parts = 1;
  while ((ps / p.parts) * row_bytes + 8 > kBudget || ps % p.parts) ++p.parts;
  const int unit = ps / p.parts;
  p.upr = ppr * p.parts;
  p.batch = std::min(p.upr, kBudget / (unit * row_bytes + 8));
  p.smem = (size_t)p.batch * (unit * row_bytes + 8);
  return p;
}

// The row source of one (slot, head) of a paged pool: logical key t is
// row t % ps of pool page table[b, t / ps]; a unit of ``unit`` rows is
// copied whole (so a batch's last page brings its rows past the length
// along, which the body never reads). sc_buf holds each unit's K scales,
// then its V scales (int8).
template <int D, class T>
struct PagedRows {
  const T* k_pool;
  const T* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;   // the slot's row of the table
  const int* lengths;
  int b, h, H, ps, P_max, n_pages, parts, unit, upr, batch, u_begin;
  int len = 0;
  int pg_first = 0;   // warp 0's table entry for the rank's first units

  __device__ __forceinline__ int length() {
    len = max(0, min(__ldg(lengths + b), P_max * ps));
    return len;
  }

  // warp 0's table entries for the rank's first units (the table row is
  // valid memory whatever the length)
  __device__ __forceinline__ void prefetch(int warp, int lane) {
    if (warp == 0 && lane < min(upr, batch) &&
        (u_begin + lane) / parts < P_max)
      pg_first = __ldg(table + (u_begin + lane) / parts);
  }

  // batch ``bi``'s units, one a lane: its table entry, its page's scales
  // (loaded ahead of its two copies so that they do not queue behind
  // them), then the batch's one arrival
  __device__ __forceinline__ void issue(int bi, int, int, T* k_buf, T* v_buf,
                                        float* sc_buf, unsigned bar,
                                        int lane) const {
    const int ub = u_begin + bi * batch;
    // the rank's units that hold keys end here (worked out here, after
    // the prefetch, not where the length is loaded)
    const int u_end = min(u_begin + upr, (len + unit - 1) / unit);
    const int nu = min(batch, u_end - ub);
    const unsigned unit_bytes = (unsigned)(unit * D * sizeof(T));
    const long long page_stride = (long long)H * ps * D;
    if (lane == 0) mxtt::mbar_expect_tx(bar, 2u * nu * unit_bytes);
    __syncwarp();
    for (int i = lane; i < nu; i += 32) {
      const int u = ub + i;
      const int lp = u / parts;
      const int raw = bi == 0 && i == lane ? pg_first : __ldg(table + lp);
      const int pg = min(max(raw, 0), n_pages - 1);
      float ks = 0.f, vs = 0.f;
      if constexpr (sizeof(T) == 1) {
        ks = __ldg(k_scale + (long long)pg * H + h);
        vs = __ldg(v_scale + (long long)pg * H + h);
      }
      const long long off = (long long)pg * page_stride +
                            (long long)h * ps * D +
                            (long long)(u - lp * parts) * unit * D;
      mxtt::bulk_copy(k_buf + (size_t)i * unit * D, k_pool + off, unit_bytes,
                      bar);
      mxtt::bulk_copy(v_buf + (size_t)i * unit * D, v_pool + off, unit_bytes,
                      bar);
      if constexpr (sizeof(T) == 1) {
        sc_buf[i] = ks;
        sc_buf[batch + i] = vs;
      }
    }
    __syncwarp();   // the scales are stored before the arrival releases
    if (lane == 0) mxtt::mbar_arrive(bar);
  }

  __device__ __forceinline__ void scales(int j, const float* sc_buf,
                                         float& ks, float& vs) const {
    ks = sc_buf[j / unit];
    vs = sc_buf[batch + j / unit];
  }
};

// q is fp32, or of the pool's type where q_half (a 16-bit pool only); out is
// split_out_t<T>.
template <int D, int NR, class T>
__global__ void __launch_bounds__(mxtt::kSplitThreads,
                                  mxtt::kSplitMinBlocks<T, NR>)
paged_split_kernel(const void* __restrict__ q, int q_half,
                   const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ lengths, void* __restrict__ out,
                   int H, int Sq, int ps, int P_max, int n_pages, int parts,
                   int upr, int batch, float scale, long long q_sb,
                   long long q_sh, long long q_ss) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / S;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * NR;
  const int unit = ps / parts;
  PagedRows<D, T> src{k_pool, v_pool, k_scale, v_scale,
                      table + (long long)b * P_max, lengths, b, h, H, ps,
                      P_max, n_pages, parts, unit, upr, batch, rank * upr};
  mxtt::split_decode<D, NR, T>(
      src, mxtt::q_at<T>(q, q_half, b * q_sb + h * q_sh), q_half, q_ss, r0,
      min(NR, Sq - r0), upr * unit, batch * unit, scale,
      static_cast<mxtt::split_out_t<T>*>(out) +
          (((long long)b * H + h) * Sq + r0) * D);
}

template <int D, int NR, class T>
cudaError_t launch_rows(const void* q, int q_half, const T* k_pool,
                        const T* v_pool, const float* k_scale,
                        const float* v_scale, const int* table,
                        const int* lengths, void* out, int B, int H, int Sq,
                        int ps, int P_max, int n_pages, float scale,
                        const long long* st, cudaStream_t stream) {
  const Plan p = plan(P_max, ps, D, (int)sizeof(T), NR);
  return mxtt::launch_split<paged_split_kernel<D, NR, T>>(
      dim3(H * p.S, B, (Sq + NR - 1) / NR), p.S, p.smem, stream, q, q_half,
      k_pool, v_pool, k_scale, v_scale, table, lengths, out, H, Sq, ps, P_max,
      n_pages, p.parts, p.upr, p.batch, scale, st[0], st[1], st[2]);
}

template <int D, class T>
cudaError_t launch(const void* q, int q_half, const T* k_pool,
                   const T* v_pool, const float* k_scale,
                   const float* v_scale, const int* table, const int* lengths,
                   void* out, int B, int H, int Sq, int ps, int P_max,
                   int n_pages, float scale, const long long* st,
                   cudaStream_t stream) {
  if (Sq == 1)
    return launch_rows<D, 1, T>(q, q_half, k_pool, v_pool, k_scale, v_scale,
                                table, lengths, out, B, H, Sq, ps, P_max,
                                n_pages, scale, st, stream);
  return launch_rows<D, 4, T>(q, q_half, k_pool, v_pool, k_scale, v_scale,
                              table, lengths, out, B, H, Sq, ps, P_max,
                              n_pages, scale, st, stream);
}

template <class T>
int dispatch(const void* q, int q_half, const T* k_pool, const T* v_pool,
             const float* k_scale, const float* v_scale, const int* table,
             const int* lengths, void* out, int B, int H, int Sq, int D,
             int ps, int P_max, int n_pages, float scale,
             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (ps < 1 || P_max < 1 || n_pages < 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch<16>(q, q_half, k_pool, v_pool, k_scale, v_scale, table,
                        lengths, out, B, H, Sq, ps, P_max, n_pages, scale,
                        strides, s);
    case 32:
      return launch<32>(q, q_half, k_pool, v_pool, k_scale, v_scale, table,
                        lengths, out, B, H, Sq, ps, P_max, n_pages, scale,
                        strides, s);
    case 64:
      return launch<64>(q, q_half, k_pool, v_pool, k_scale, v_scale, table,
                        lengths, out, B, H, Sq, ps, P_max, n_pages, scale,
                        strides, s);
    case 128:
      return launch<128>(q, q_half, k_pool, v_pool, k_scale, v_scale, table,
                         lengths, out, B, H, Sq, ps, P_max, n_pages, scale,
                         strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D) fp32 with a contiguous last axis; ``strides`` holds
// its (b, h, s) element strides. k_pool / v_pool: contiguous
// (n_pages, H, ps, D) fp32, 16-byte aligned. table: contiguous
// (B, P_max) int32; lengths: (B,) int32; both on the device. out:
// (B, H, Sq, D) contiguous fp32. Returns the launch's cudaError_t.
int mxtt_paged_decode_attention(const float* q, const float* k_pool,
                                const float* v_pool, const int* table,
                                const int* lengths, float* out, int B, int H,
                                int Sq, int D, int ps, int P_max, int n_pages,
                                float scale, const long long* strides,
                                void* stream) {
  return dispatch<float>(q, 0, k_pool, v_pool, nullptr, nullptr, table,
                         lengths, out, B, H, Sq, D, ps, P_max, n_pages, scale,
                         strides, stream);
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
  return dispatch<int8_t>(q, 0, k_pool, v_pool, k_scale, v_scale, table,
                          lengths, out, B, H, Sq, D, ps, P_max, n_pages, scale,
                          strides, stream);
}

// The bf16 instance: k_pool / v_pool are contiguous (n_pages, H, ps, D)
// bf16, 16-byte aligned; q is fp32, or bf16 where ``q_half`` is non-zero
// (``strides`` in its elements); out: (B, H, Sq, D) contiguous bf16. The
// rest as above.
int mxtt_paged_decode_attention_bf16(
    const void* q, int q_half, const mxtt::bf16* k_pool,
    const mxtt::bf16* v_pool, const int* table, const int* lengths,
    mxtt::bf16* out, int B, int H, int Sq, int D, int ps, int P_max,
    int n_pages, float scale, const long long* strides, void* stream) {
  return dispatch<mxtt::bf16>(q, q_half, k_pool, v_pool, nullptr, nullptr,
                              table, lengths, out, B, H, Sq, D, ps, P_max,
                              n_pages, scale, strides, stream);
}

// The float16 instance: k_pool / v_pool are contiguous (n_pages, H, ps, D)
// float16, q fp32 or (q_half) float16, out float16; otherwise as the bf16
// instance.
int mxtt_paged_decode_attention_f16(
    const void* q, int q_half, const mxtt::f16* k_pool,
    const mxtt::f16* v_pool, const int* table, const int* lengths,
    mxtt::f16* out, int B, int H, int Sq, int D, int ps, int P_max,
    int n_pages, float scale, const long long* strides, void* stream) {
  return dispatch<mxtt::f16>(q, q_half, k_pool, v_pool, nullptr, nullptr,
                             table, lengths, out, B, H, Sq, D, ps, P_max,
                             n_pages, scale, strides, stream);
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
