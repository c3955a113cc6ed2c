// Ragged decode attention for Hopper (sm_90a): one query token per row,
// grouped-query attention over a CONTIGUOUS per-row KV cache, with an
// optional sliding window — in bf16 (K2) or int8 with float32 scales (K2q).
//
// Replaces the TPU kernel distributed_llms_tpu/ops/decode_attn.py
// `_ragged_impl` -> `_kernel` (:338), its bf16 leg (K2) and its int8 leg
// (`quant=True`, :331-337; K2q): row b attends cache slots [0,
// lengths[b]), or only [lengths[b] - window, lengths[b]) with a window —
// exact because the contiguous layout keeps slot == position, so the slot
// band IS the position window (p - window, p] of the query at position
// lengths[b] - 1.  The online-softmax body (and its numerics, the int8
// leg's scale folding included) lives in decode_attn_common.cuh.
//
// Layouts (all contiguous):
//   q        [B, 1, H, D]     bf16
//   k, v     [B, S, KVH, D]   bf16 per-row caches, or int8 (K2q)
//   k_scale, v_scale
//            [B, S, KVH]      float32 absmax scales (K2q only)
//   lengths  [B]              int32; the read stops at slot S, whatever
//                             length a caller passes
//   out      [B, 1, H, D]     bf16
//
// What bounds it on the H100: the bytes, sum(min(lengths, window)) * KVH *
// D * 2 bytes * 2 per layer at 3.35 TB/s (K2q: 1 byte per element plus
// two 4-byte scales per slot and head).  The block computes the band's
// first slot from the length and the window and reads nothing before it
// (masking the scores alone would turn a windowed read back into O(length)
// bytes; the band is the point of the window).  Same simple first design as
// paged_decode_attn.cu: one block per (KV head, row), the G query heads of
// the group sharing every K/V read.

#include "decode_attn_common.cuh"

namespace {

using namespace dlt_decode;

template <typename KV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ k, const KV* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int32_t* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,
                     int H, int KVH, int D, int S, int window, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  extern __shared__ float smem[];
  begin(smem, q + q_base, G, D);

  // The band is [length - window, length) cut to the cache: the first
  // slot comes from the unclamped length, as in the TPU kernel's mask.
  const int raw = max(0, lengths[b]);
  const int len = min(raw, S);
  const int lo = window > 0 ? min(len, max(0, raw - window)) : 0;
  const size_t slot_stride = (size_t)KVH * D;
  const size_t off = ((size_t)b * S + lo) * slot_stride + (size_t)kvh * D;
  const size_t sc_off = ((size_t)b * S + lo) * KVH + kvh;
  attend_span<KV, kQuant>(smem, G, D, k + off, v + off,
                          kQuant ? k_scale + sc_off : nullptr,
                          kQuant ? v_scale + sc_off : nullptr, len - lo,
                          slot_stride, (size_t)KVH, scale);
  finish(smem, G, D, out + q_base);
}

template <typename KV, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* lengths, void* out, int B, int H,
           int KVH, int D, int S, int window, float scale, void* stream) {
  if (bad_shape(B, H, KVH, D) || S < 1) return (int)cudaErrorInvalidValue;
  const int G = H / KVH;
  const dim3 grid(KVH, B);
  ragged_decode_kernel<KV, kQuant><<<grid, kThreads, smem_bytes(G, D),
                                     (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const KV*)k, (const KV*)v,
      (const float*)k_scale, (const float*)v_scale, (const int32_t*)lengths,
      (__nv_bfloat16*)out, H, KVH, D, S, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` without synchronising.  `window` <= 0 means no window.
// Each returns the cudaError_t of cudaGetLastError() right after the launch
// (0 = launched), or cudaErrorInvalidValue for shapes the kernel does not
// take.
extern "C" int dlt_ragged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int KVH, int D, int S, int window, float scale,
    void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, lengths, out,
                                      B, H, KVH, D, S, window, scale, stream);
}

extern "C" int dlt_ragged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, int B, int H,
    int KVH, int D, int S, int window, float scale, void* stream) {
  return launch<int8_t, true>(q, k, v, k_scale, v_scale, lengths, out, B, H,
                              KVH, D, S, window, scale, stream);
}
