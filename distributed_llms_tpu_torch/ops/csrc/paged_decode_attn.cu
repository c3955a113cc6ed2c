// Paged decode attention for Hopper (sm_90a): one query token per row,
// grouped-query attention over a shared KV page pool, in bf16 (K1) or in
// int8 with float32 absmax scales (K1q).
//
// Replaces the TPU kernel distributed_llms_tpu/ops/decode_attn.py
// `_paged_impl` -> `_kernel_paged` -> `_kernel`, both legs: row b attends
// pool slots [0, lengths[b]) through its page table tables[b, :].  The
// online-softmax body (and its numerics) lives in decode_attn_common.cuh.
//
// Layouts (all contiguous):
//   q        [B, 1, H, D]       bf16
//   k, v     [NB, BLK, KVH, D]  bf16 page pools (K1) or int8 (K1q)
//   k_scale, v_scale [NB, BLK, KVH] float32 absmax scales (K1q only)
//   lengths  [B]                int32
//   tables   [B, P]             int32 page ids; entries past a row's depth
//                               are arbitrary and never read
//   out      [B, 1, H, D]       bf16
//
// What bounds it on the H100: the bytes.  A decode step reads every live
// row's K and V once — sum(lengths) * KVH * D * 2 bytes * 2 per layer in
// bf16, sum(lengths) * KVH * (D + 4) bytes * 2 in int8 with its scales —
// at 3.35 TB/s; the arithmetic is 4 * H * D operations per slot, far under
// the ~295 operations per byte where the tensor cores would become the
// limit.  The int8 leg exists to halve those bytes.
//
// This first design is simple and correct, not fast: one block per
// (KV head, row) pair walks its own page table, so each K/V element is read
// from device memory exactly once and the G = H / KVH query heads of the
// group share that read (the GQA saving the bound counts on).  Left for a
// later change: split-K across pages (flash-decoding; B * KVH = 64 blocks
// under-fill 132 SMs at batch 8), 16-byte vector or cp.async/TMA page
// loads, and tensor-core dots.

#include "decode_attn_common.cuh"

namespace {

using namespace dlt_decode;

template <typename KV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ tables,
                    __nv_bfloat16* __restrict__ out,
                    int H, int KVH, int D, int NB, int BLK, int P,
                    float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  // Query heads h0 .. h0+G-1 read kv head `kvh` (repeat_kv's h // G).
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  extern __shared__ float smem[];
  begin(smem, q + q_base, G, D);

  // A length past the table's reach would index past the row's table.
  const int len = max(0, min(lengths[b], P * BLK));
  const int n_pages = (len + BLK - 1) / BLK;
  const size_t slot_stride = (size_t)KVH * D;
  const size_t page_stride = (size_t)BLK * slot_stride;
  const size_t scale_page_stride = (size_t)BLK * KVH;

  for (int pi = 0; pi < n_pages; ++pi) {
    const int page = tables[(size_t)b * P + pi];
    // A page id outside the pool is a caller bug: fail the launch loudly
    // instead of reading foreign memory.
    if (page < 0 || page >= NB) __trap();
    const size_t kv_off = (size_t)page * page_stride + (size_t)kvh * D;
    const size_t sc_off = (size_t)page * scale_page_stride + kvh;
    attend_span<KV, kQuant>(
        smem, G, D, k_pages + kv_off, v_pages + kv_off,
        kQuant ? k_scale + sc_off : nullptr,
        kQuant ? v_scale + sc_off : nullptr,
        min(BLK, len - pi * BLK), slot_stride, (size_t)KVH, scale);
  }
  finish(smem, G, D, out + q_base);
}

template <typename KV, bool kQuant>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* lengths,
           const void* tables, void* out, int B, int H, int KVH, int D,
           int NB, int BLK, int P, float scale, void* stream) {
  if (bad_shape(B, H, KVH, D) || NB < 1 || BLK < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = H / KVH;
  const dim3 grid(KVH, B);
  paged_decode_kernel<KV, kQuant>
      <<<grid, kThreads, smem_bytes(G, D), (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const KV*)k_pages, (const KV*)v_pages,
          (const float*)k_scale, (const float*)v_scale,
          (const int32_t*)lengths, (const int32_t*)tables,
          (__nv_bfloat16*)out, H, KVH, D, NB, BLK, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` without synchronising.  Each returns the cudaError_t
// of cudaGetLastError() right after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int dlt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, void* out,
    int B, int H, int KVH, int D, int NB, int BLK, int P, float scale,
    void* stream) {
  return launch<__nv_bfloat16, false>(q, k_pages, v_pages, nullptr, nullptr,
                                      lengths, tables, out, B, H, KVH, D, NB,
                                      BLK, P, scale, stream);
}

extern "C" int dlt_paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* tables, void* out, int B, int H, int KVH, int D, int NB,
    int BLK, int P, float scale, void* stream) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scale, v_scale, lengths,
                              tables, out, B, H, KVH, D, NB, BLK, P, scale,
                              stream);
}
