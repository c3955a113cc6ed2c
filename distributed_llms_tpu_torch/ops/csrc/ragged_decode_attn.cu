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
// lengths[b] - 1.
//
// Layouts (all contiguous, 16-byte aligned):
//   q        [B, 1, H, D]     bf16
//   k, v     [B, S, KVH, D]   bf16 per-row caches, or int8 (K2q)
//   k_scale, v_scale
//            [B, S, KVH]      float32 absmax scales (K2q only)
//   lengths  [B]              int32; the read stops at slot S, whatever
//                             length a caller passes
//   out      [B, 1, H, D]     bf16
//   acc, m, l                 float32 partials [B, KVH, n_splits, G, D] and
//                             [B, KVH, n_splits, G] (n_splits > 1 only)
//
// What bounds it on the H100: the bytes, sum over rows of the band
// (min(lengths, window) slots) x KVH x D x 2 bytes x 2 (K and V) at 3.35
// TB/s; K2q reads (D + 4) x 2 bytes per slot and head (int8 K and V and
// their two float32 scales).  At G = 4 that is ~4 operations per byte, so
// the design is about bytes: split_decode.cuh's split-K body.  The grid is
// (n_splits, KVH, B): block (s, h, b) attends slots [lo + s L, min(lo + (s
// + 1) L, len)) of row b's band, where len = min(lengths[b], S) and lo =
// the band's first slot, computed from the unclamped length as in the TPU
// kernel's mask; a split past the band leaves an empty partial.  The
// wrapper (ops/decode_attn.py) picks L and n_splits from shapes alone —
// never from `lengths`, which would sync the host every decode step — and
// a second kernel merges the partials; with one split the block writes the
// output itself.  The block computes the band's edges and reads nothing
// outside them (masking scores alone would make a windowed read O(length)
// bytes again).

#include "split_decode.cuh"

namespace {

using dlt_decode::bad_shape;
using dlt_split::Geometry;

template <typename KV, bool kQuant, int kVec>
__global__ void __launch_bounds__(dlt_split::kMaxThreads)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ k, const KV* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int32_t* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ acc,
                     float* __restrict__ pm, float* __restrict__ pl, int H,
                     int KVH, int D, int S, int window, int split_len,
                     int n_splits, float scale) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;

  // The band is [length - window, length) cut to the cache: the first
  // slot comes from the unclamped length, as in the TPU kernel's mask.
  const int raw = max(0, lengths[b]);
  const int len = min(raw, S);
  const int lo = window > 0 ? min(len, max(0, raw - window)) : 0;
  const long long first = lo + (long long)split * split_len;
  const int n =
      first < len ? (int)min((long long)split_len, len - first) : 0;

  const size_t slot_stride = (size_t)KVH * D;
  const size_t row0 = (size_t)b * S + (n > 0 ? (size_t)first : 0);
  const size_t off = row0 * slot_stride + (size_t)kvh * D;
  const size_t sc_off = row0 * KVH + kvh;
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  const size_t part = (((size_t)b * KVH + kvh) * n_splits + split) * G;
  const bool direct = n_splits == 1;
  dlt_split::attend_split<KV, kQuant, kVec>(
      q + q_base, k + off, v + off, kQuant ? k_scale + sc_off : nullptr,
      kQuant ? v_scale + sc_off : nullptr, n,
      dlt_split::ContiguousSlots{slot_stride, (size_t)KVH}, G, D, scale,
      direct ? out + q_base : nullptr, direct ? nullptr : acc + part * D,
      direct ? nullptr : pm + part, direct ? nullptr : pl + part);
}

template <typename KV, bool kQuant, int kVec>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* lengths, void* out, void* acc,
           void* pm, void* pl, int B, int H, int KVH, int D, int S,
           int window, int split_len, int n_splits, float scale,
           void* stream) {
  if (bad_shape(B, H, KVH, D) || S < 1 || split_len < 1 || n_splits < 1 ||
      (n_splits > 1 && (acc == nullptr || pm == nullptr || pl == nullptr ||
                        dlt_split::merge_smem(n_splits) > 48 * 1024)) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  // At most ~34 KB of shared memory for any D <= 256: no opt-in needed.
  const Geometry geo = dlt_split::geometry<KV, kQuant, kVec>(D, H / KVH);
  const cudaStream_t st = (cudaStream_t)stream;
  auto kernel = ragged_decode_kernel<KV, kQuant, kVec>;
  kernel<<<dim3(n_splits, KVH, B), geo.threads, geo.smem, st>>>(
      (const __nv_bfloat16*)q, (const KV*)k, (const KV*)v,
      (const float*)k_scale, (const float*)v_scale, (const int32_t*)lengths,
      (__nv_bfloat16*)out, (float*)acc, (float*)pm, (float*)pl, H, KVH, D, S,
      window, split_len, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  dlt_split::split_decode_merge_kernel<<<
      dim3(H / KVH, KVH, B), dlt_split::merge_threads(D),
      dlt_split::merge_smem(n_splits), st>>>(
      (const float*)acc, (const float*)pm, (const float*)pl,
      (__nv_bfloat16*)out, H, KVH, D, n_splits);
  return (int)cudaGetLastError();
}

// The split kernel's resources for head dim D and group G: {threads, tile
// slots, dynamic shared memory bytes, resident blocks per SM, registers
// per thread, local (spill) bytes per thread, merge kernel registers}.
template <typename KV, bool kQuant, int kVec>
int resources(int D, int G, int* info) {
  const Geometry geo = dlt_split::geometry<KV, kQuant, kVec>(D, G);
  auto kernel = ragged_decode_kernel<KV, kQuant, kVec>;
  cudaFuncAttributes attr, merge;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&merge, dlt_split::split_decode_merge_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      geo.threads, geo.smem);
  if (e != cudaSuccess) return (int)e;
  const int got[7] = {geo.threads, geo.tile, geo.smem, blocks, attr.numRegs,
                      (int)attr.localSizeBytes, merge.numRegs};
  for (int i = 0; i < 7; ++i) info[i] = got[i];
  return 0;
}

}  // namespace

// Launch on `stream` without synchronising: the split kernel, then (with
// n_splits > 1) the merge.  `window` <= 0 means no window.  Each returns
// the cudaError_t of cudaGetLastError() after its launches (0 = launched),
// or cudaErrorInvalidValue for shapes or pointers the kernels do not take.
extern "C" int dlt_ragged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* acc, void* pm, void* pl, int B, int H, int KVH, int D,
    int S, int window, int split_len, int n_splits, float scale,
    void* stream) {
  return launch<__nv_bfloat16, false, 8>(
      q, k, v, nullptr, nullptr, lengths, out, acc, pm, pl, B, H, KVH, D, S,
      window, split_len, n_splits, scale, stream);
}

extern "C" int dlt_ragged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, void* acc, void* pm,
    void* pl, int B, int H, int KVH, int D, int S, int window, int split_len,
    int n_splits, float scale, void* stream) {
  // 16 int8 elements a load where D allows, else 8 (D = 72: 9 chunks).
  if (D % 16 == 0)
    return launch<int8_t, true, 16>(q, k, v, k_scale, v_scale, lengths, out,
                                    acc, pm, pl, B, H, KVH, D, S, window,
                                    split_len, n_splits, scale, stream);
  return launch<int8_t, true, 8>(q, k, v, k_scale, v_scale, lengths, out, acc,
                                 pm, pl, B, H, KVH, D, S, window, split_len,
                                 n_splits, scale, stream);
}

// Resources of the kernel a launch with head dim D and group G would run
// (bf16 with quant = 0, int8 with 1) into info[0..6]; see `resources`.
extern "C" int dlt_ragged_decode_resources(int D, int G, int quant,
                                           int* info) {
  if (G < 1 || bad_shape(1, G, 1, D)) return (int)cudaErrorInvalidValue;
  if (!quant) return resources<__nv_bfloat16, false, 8>(D, G, info);
  if (D % 16 == 0) return resources<int8_t, true, 16>(D, G, info);
  return resources<int8_t, true, 8>(D, G, info);
}
