// Paged decode attention for Hopper (sm_90a): one query token per row,
// grouped-query attention over a shared KV page pool.
//
// Replaces the TPU kernel distributed_llms_tpu/ops/decode_attn.py
// `_paged_impl` -> `_kernel_paged` -> `_kernel` (its bf16 leg).  Same
// function: row b attends pool slots [0, lengths[b]) through its page table
// tables[b, :]; scores in float32 scaled by D^-0.5; an online (running max /
// running sum) softmax in float32; each tile's probabilities are rounded to
// bfloat16 before the value product, which accumulates in float32; the
// output is acc / max(l, 1e-37) in bfloat16.
//
// Layouts (all contiguous):
//   q        [B, 1, H, D]       bf16
//   k, v     [NB, BLK, KVH, D]  bf16 page pools
//   lengths  [B]                int32
//   tables   [B, P]             int32 page ids; entries past a row's depth
//                               are arbitrary and never read
//   out      [B, 1, H, D]       bf16
//
// What bounds it on the H100: the bytes.  A decode step reads every live
// row's K and V once, sum(lengths) * KVH * D * 2 bytes * 2 per layer, at
// 3.35 TB/s; the arithmetic is 4 * H * D operations per slot, far under the
// ~295 operations per byte where the tensor cores would become the limit.
//
// This first design is simple and correct, not fast: one block per
// (KV head, row) pair walks its own page table, so each K/V element is read
// from device memory exactly once and the G = H / KVH query heads of the
// group share that read (the GQA saving the bound counts on).  Left for a
// later change: split-K across pages (flash-decoding; B * KVH = 64 blocks
// under-fill 132 SMs at batch 8), 16-byte vector or cp.async/TMA page
// loads, and tensor-core dots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // slots per online-softmax update
constexpr int kMaxGroup = 16;   // query heads per KV head
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ tables,
                    __nv_bfloat16* __restrict__ out,
                    int H, int KVH, int D, int NB, int BLK, int P,
                    float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G, D] the group's queries
  float* acc_s = q_s + G * D;      // [G, D] unnormalized output
  float* p_s = acc_s + G * D;      // [G, kTile] scores, then probabilities
  float* m_s = p_s + G * kTile;    // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* a_s = l_s + G;            // [G] this tile's rescale factor

  // Query heads h0 .. h0+G-1 read kv head `kvh` (repeat_kv's h // G).
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = __bfloat162float(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // A length past the table's reach would index past the row's table.
  const int len = max(0, min(lengths[b], P * BLK));
  const int n_pages = (len + BLK - 1) / BLK;
  const size_t slot_stride = (size_t)KVH * D;
  const size_t page_stride = (size_t)BLK * slot_stride;

  for (int pi = 0; pi < n_pages; ++pi) {
    const int page = tables[(size_t)b * P + pi];
    // A page id outside the pool is a caller bug: fail the launch loudly
    // instead of reading foreign memory.
    if (page < 0 || page >= NB) __trap();
    const int page_len = min(BLK, len - pi * BLK);
    const __nv_bfloat16* kp = k_pages + (size_t)page * page_stride + (size_t)kvh * D;
    const __nv_bfloat16* vp = v_pages + (size_t)page * page_stride + (size_t)kvh * D;
    for (int t0 = 0; t0 < page_len; t0 += kTile) {
      const int n = min(kTile, page_len - t0);

      // 1. Scores: warp w takes slots w, w + kWarps, ...; the lanes split
      //    the head dim, and one K row serves all G heads of the group.
      for (int t = warp; t < n; t += kWarps) {
        const __nv_bfloat16* krow = kp + (size_t)(t0 + t) * slot_stride;
        float dots[kMaxGroup];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) dots[g] = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float kd = __bfloat162float(krow[d]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < G) dots[g] += q_s[g * D + d] * kd;
        }
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float s = warp_sum(dots[g]);
            if (lane == 0) p_s[g * kTile + t] = s * scale;
          }
        }
      }
      __syncthreads();

      // 2. Online softmax: warp w takes heads w, w + kWarps, ...  The sum
      //    accumulates the float32 probabilities; the value product reads
      //    them rounded to bfloat16 (the reference's p.astype(v.dtype)).
      for (int g = warp; g < G; g += kWarps) {
        float* row = p_s + g * kTile;
        float mx = -INFINITY;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < n; t += 32) {
          const float p = expf(row[t] - m_new);
          sum += p;
          row[t] = __bfloat162float(__float2bfloat16(p));
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // 3. Value product: thread i owns output elements (g, d) = divmod(i,
      //    D); neighbouring threads read neighbouring d of one V slot.
      for (int i = tid; i < G * D; i += kThreads) {
        const int g = i / D;
        const int d = i - g * D;
        const float* prow = p_s + g * kTile;
        const __nv_bfloat16* vcol = vp + (size_t)t0 * slot_stride + d;
        float a = acc_s[i] * a_s[g];
        for (int t = 0; t < n; ++t)
          a += prow[t] * __bfloat162float(vcol[(size_t)t * slot_stride]);
        acc_s[i] = a;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    out[q_base + i] = __float2bfloat16(acc_s[i] / fmaxf(l_s[g], 1e-37f));
  }
}

}  // namespace

// Launch on `stream` without synchronising.  Returns the cudaError_t of
// cudaGetLastError() right after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int dlt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, void* out,
    int B, int H, int KVH, int D, int NB, int BLK, int P, float scale,
    void* stream) {
  if (B < 1 || B > 65535 || KVH < 1 || H % KVH != 0 || H / KVH > kMaxGroup ||
      D < 8 || D % 8 != 0 || D > kMaxHeadDim || NB < 1 || BLK < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = H / KVH;
  const size_t smem = (size_t)(2 * G * D + G * kTile + 3 * G) * sizeof(float);
  const dim3 grid(KVH, B);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int32_t*)lengths,
      (const int32_t*)tables, (__nv_bfloat16*)out, H, KVH, D, NB, BLK, P,
      scale);
  return (int)cudaGetLastError();
}
