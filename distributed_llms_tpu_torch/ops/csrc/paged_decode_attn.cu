// Paged decode attention for Hopper (sm_90a): one query token per row,
// grouped-query attention over a shared KV page pool, in bf16 (K1) or in
// int8 with float32 absmax scales (K1q).
//
// Replaces the TPU kernel distributed_llms_tpu/ops/decode_attn.py
// `_paged_impl` -> `_kernel_paged` -> `_kernel`, both legs: row b attends
// pool slots [0, lengths[b]) through its page table tables[b, :].
//
// Layouts (all contiguous, q/k/v/out 16-byte aligned):
//   q        [B, 1, H, D]       bf16
//   k, v     [NB, BLK, KVH, D]  bf16 page pools (K1) or int8 (K1q)
//   k_scale, v_scale [NB, BLK, KVH] float32 absmax scales (K1q only)
//   lengths  [B]                int32; the read stops at the table's reach
//                               P x BLK, whatever length a caller passes
//   tables   [B, P]             int32 page ids; entries past a row's depth
//                               are arbitrary and never read
//   out      [B, 1, H, D]       bf16
//   acc, m, l                   float32 partials [B, KVH, n_splits, G, D]
//                               and [B, KVH, n_splits, G] (n_splits > 1)
//
// What bounds it on the H100: the bytes.  A decode step reads every live
// row's K and V once — sum(lengths) * KVH * D * 2 bytes * 2 per layer in
// bf16, sum(lengths) * KVH * (D + 4) bytes * 2 in int8 with its scales —
// at 3.35 TB/s; the arithmetic is 4 * H * D operations per slot, far under
// the ~295 operations per byte where the tensor cores would become the
// limit.  The int8 leg exists to halve those bytes.
//
// The design is split_decode.cuh's split-K body over page runs.  The grid
// is (n_splits, KVH, B): block (s, h, b) attends slots [s L, min((s + 1) L,
// len)) of row b, len = clamp(lengths[b], 0, P BLK) (the TPU kernel clamps
// its index map to the table the same way), where the split length L is a
// multiple of BLK, so a split is a run of whole pages.  The block first
// copies the table entries of its own pages — at most L / BLK, never one
// past the row's depth — into shared memory, trapping on a page id outside
// [0, NB); then the body streams the run through one cp.async pipeline,
// each tile row resolving its own page (a tile may straddle pages when BLK
// is not a multiple of the tile).  A split past the row's depth writes an
// empty partial; split_decode_merge_kernel combines the partials, and with
// one split the block writes the output itself.  The wrapper
// (ops/decode_attn.py `paged_split_plan`) picks L and n_splits from the
// shapes alone — the table's reach, B, KVH and the SM count — never from
// `lengths`, so a decode step does not wait on the device to plan.
//
// What it still leaves out: tensor-core dots (the body is bound by its
// instruction issue, PERF.md), and a plan that follows the live lengths
// (blocks of splits past a short row still launch, write an empty partial
// and leave their SM to the next).

#include <limits.h>

#include "split_decode.cuh"

namespace {

using dlt_decode::bad_shape;
using dlt_split::Geometry;

// Page ids a split may span: the block keeps them in shared memory, after
// the body's ring.  ops/decode_attn.py MAX_SPLIT_PAGES holds the plan to it.
constexpr int kMaxSplitPages = 256;
constexpr int kPageIdBytes = kMaxSplitPages * (int)sizeof(int);

template <typename KV, bool kQuant, int kVec>
__global__ void __launch_bounds__(dlt_split::kMaxThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ tables,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ acc,
                    float* __restrict__ pm, float* __restrict__ pl, int H,
                    int KVH, int D, int NB, int BLK, int P, int split_len,
                    int n_splits, float scale) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;

  // A length past the table's reach would index past the row's table.
  const int len = max(0, min(lengths[b], P * BLK));
  const long long first = (long long)split * split_len;
  const int n =
      first < len ? (int)min((long long)split_len, len - first) : 0;

  // The split's page ids, read from the table once per page.
  extern __shared__ __align__(16) unsigned char smem[];
  int* pages = reinterpret_cast<int*>(
      smem + dlt_split::geometry<KV, kQuant, kVec>(D, G).smem);
  const int page0 = (int)(first / BLK);
  const int n_pages = (n + BLK - 1) / BLK;
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x) {
    const int page = tables[(size_t)b * P + page0 + i];
    // A page id outside the pool is a caller bug: fail the launch loudly
    // instead of reading foreign memory.
    if (page < 0 || page >= NB) __trap();
    pages[i] = page;
  }
  __syncthreads();

  const size_t slot_stride = (size_t)KVH * D;
  const dlt_split::PagedSlots slots{pages, BLK, (size_t)BLK * slot_stride,
                                    slot_stride, (size_t)BLK * KVH,
                                    (size_t)KVH};
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  const size_t part = (((size_t)b * KVH + kvh) * n_splits + split) * G;
  const bool direct = n_splits == 1;
  dlt_split::attend_split<KV, kQuant, kVec>(
      q + q_base, k_pages + (size_t)kvh * D, v_pages + (size_t)kvh * D,
      kQuant ? k_scale + kvh : nullptr, kQuant ? v_scale + kvh : nullptr, n,
      slots, G, D, scale, direct ? out + q_base : nullptr,
      direct ? nullptr : acc + part * D, direct ? nullptr : pm + part,
      direct ? nullptr : pl + part);
}

template <typename KV, bool kQuant, int kVec>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* lengths,
           const void* tables, void* out, void* acc, void* pm, void* pl,
           int B, int H, int KVH, int D, int NB, int BLK, int P,
           int split_len, int n_splits, float scale, void* stream) {
  if (bad_shape(B, H, KVH, D) || NB < 1 || BLK < 1 || P < 1 ||
      (long long)P * BLK > INT_MAX || split_len < BLK || split_len % BLK ||
      split_len / BLK > kMaxSplitPages || n_splits < 1 ||
      (long long)split_len * n_splits < (long long)P * BLK ||
      (n_splits > 1 && (acc == nullptr || pm == nullptr || pl == nullptr ||
                        dlt_split::merge_smem(n_splits) > 48 * 1024)) ||
      (((uintptr_t)q | (uintptr_t)k_pages | (uintptr_t)v_pages |
        (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  // At most ~35 KB of shared memory for any D <= 256: no opt-in needed.
  const Geometry geo = dlt_split::geometry<KV, kQuant, kVec>(D, H / KVH);
  const cudaStream_t st = (cudaStream_t)stream;
  auto kernel = paged_decode_kernel<KV, kQuant, kVec>;
  kernel<<<dim3(n_splits, KVH, B), geo.threads, geo.smem + kPageIdBytes,
           st>>>(
      (const __nv_bfloat16*)q, (const KV*)k_pages, (const KV*)v_pages,
      (const float*)k_scale, (const float*)v_scale, (const int32_t*)lengths,
      (const int32_t*)tables, (__nv_bfloat16*)out, (float*)acc, (float*)pm,
      (float*)pl, H, KVH, D, NB, BLK, P, split_len, n_splits, scale);
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
  const int smem = geo.smem + kPageIdBytes;
  auto kernel = paged_decode_kernel<KV, kQuant, kVec>;
  cudaFuncAttributes attr, merge;
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&merge, dlt_split::split_decode_merge_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      geo.threads, smem);
  if (e != cudaSuccess) return (int)e;
  const int got[7] = {geo.threads, geo.tile, smem, blocks, attr.numRegs,
                      (int)attr.localSizeBytes, merge.numRegs};
  for (int i = 0; i < 7; ++i) info[i] = got[i];
  return 0;
}

}  // namespace

// Launch on `stream` without synchronising: the split kernel, then (with
// n_splits > 1) the merge.  Each returns the cudaError_t of
// cudaGetLastError() after its launches (0 = launched), or
// cudaErrorInvalidValue for shapes, plans or pointers the kernels do not
// take (the splits must cover the table's reach P x BLK in runs of whole
// pages, at most kMaxSplitPages a split).
extern "C" int dlt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, void* out, void* acc, void* pm,
    void* pl, int B, int H, int KVH, int D, int NB, int BLK, int P,
    int split_len, int n_splits, float scale, void* stream) {
  return launch<__nv_bfloat16, false, 8>(
      q, k_pages, v_pages, nullptr, nullptr, lengths, tables, out, acc, pm,
      pl, B, H, KVH, D, NB, BLK, P, split_len, n_splits, scale, stream);
}

extern "C" int dlt_paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* tables, void* out, void* acc, void* pm, void* pl, int B,
    int H, int KVH, int D, int NB, int BLK, int P, int split_len,
    int n_splits, float scale, void* stream) {
  // 16 int8 elements a load where D allows, else 8 (D = 72: 9 chunks).
  if (D % 16 == 0)
    return launch<int8_t, true, 16>(q, k_pages, v_pages, k_scale, v_scale,
                                    lengths, tables, out, acc, pm, pl, B, H,
                                    KVH, D, NB, BLK, P, split_len, n_splits,
                                    scale, stream);
  return launch<int8_t, true, 8>(q, k_pages, v_pages, k_scale, v_scale,
                                 lengths, tables, out, acc, pm, pl, B, H, KVH,
                                 D, NB, BLK, P, split_len, n_splits, scale,
                                 stream);
}

// Resources of the kernel a launch with head dim D and group G would run
// (bf16 with quant = 0, int8 with 1) into info[0..6]; see `resources`.
extern "C" int dlt_paged_decode_resources(int D, int G, int quant,
                                          int* info) {
  if (G < 1 || bad_shape(1, G, 1, D)) return (int)cudaErrorInvalidValue;
  if (!quant) return resources<__nv_bfloat16, false, 8>(D, G, info);
  if (D % 16 == 0) return resources<int8_t, true, 16>(D, G, info);
  return resources<int8_t, true, 8>(D, G, info);
}
