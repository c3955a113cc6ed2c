// The online-softmax body shared by the port's decode-attention kernels
// (paged_decode_attn.cu: K1 and its int8 leg K1q; ragged_decode_attn.cu:
// K2).  It is the body of the TPU kernel all three replace,
// distributed_llms_tpu/ops/decode_attn.py `_kernel`: one query token per
// row, grouped-query attention, scores in float32 scaled by D^-0.5, a
// running max / running sum softmax in float32, each tile's probabilities
// rounded to bfloat16 before the value product, which accumulates in
// float32, and the output acc / max(l, 1e-37) in bfloat16.
//
// One block serves one (KV head, row) pair: the G = H / KVH query heads of
// the group sit in shared memory and share every K/V element read, so each
// element crosses from device memory once.  A caller walks the row's slots
// as SPANS — runs of slots contiguous in memory (one page of a pool, or a
// contiguous row's whole band) — and hands each span to attend_span().
//
// The int8 leg (kQuant) reads int8 K/V (one byte per element) and widens
// each element to a float exactly; the per-(slot, head) float32 absmax
// scales fold in where the TPU kernel folds them (:121-148): the score is
// (q . k_i8) * D^-0.5 * k_scale, the running sum adds p BEFORE v_scale, and
// the value product reads bf16(p * v_scale).  A dequantized K/V element
// never exists in device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dlt_decode {

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

__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

// Bytes of dynamic shared memory a block needs for group size G, head dim D.
__host__ __device__ inline size_t smem_bytes(int G, int D) {
  return (size_t)(2 * G * D + G * kTile + 3 * G) * sizeof(float);
}

// The block's online-softmax state in its dynamic shared memory
// (smem_bytes(G, D) bytes), carved into float arrays:
//   q_s   [G, D]      the group's queries
//   acc_s [G, D]      unnormalized output
//   p_s   [G, kTile]  scores, then probabilities
//   m_s, l_s, a_s [G] running max, running sum, this tile's rescale factor
// Each function carves its own pointers from the block's base: handing
// them around in a struct compiled to a slower loop on the H100 (the same
// arithmetic, bit-identical outputs).
#define DLT_DECODE_SMEM(smem, G, D)          \
  float* q_s = (smem);                       \
  float* acc_s = q_s + (G) * (D);            \
  float* p_s = acc_s + (G) * (D);            \
  float* m_s = p_s + (G) * kTile;            \
  float* l_s = m_s + (G);                    \
  float* a_s = l_s + (G);                    \
  (void)q_s, (void)acc_s, (void)p_s, (void)m_s, (void)l_s, (void)a_s;

// Load the group's queries (q_group: [G, D] bf16) and reset the
// accumulators.  Ends with a block barrier.
__device__ __forceinline__ void begin(float* smem, const __nv_bfloat16* q_group,
                                      int G, int D) {
  DLT_DECODE_SMEM(smem, G, D)
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    q_s[i] = __bfloat162float(q_group[i]);
    acc_s[i] = 0.f;
  }
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();
}

// Attend n slots contiguous in memory: slot t's K row for this block's KV
// head is kp[t * slot_stride .. + D) (likewise vp); in the int8 leg its
// scales are ksp[t * scale_stride] and vsp[t * scale_stride].
template <typename KV, bool kQuant>
__device__ __forceinline__ void attend_span(
    float* smem, int G, int D, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ksp,
    const float* __restrict__ vsp, int n_slots, size_t slot_stride,
    size_t scale_stride, float scale) {
  DLT_DECODE_SMEM(smem, G, D)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int t0 = 0; t0 < n_slots; t0 += kTile) {
    const int n = min(kTile, n_slots - t0);

    // 1. Scores: warp w takes slots w, w + kWarps, ...; the lanes split
    //    the head dim, and one K row serves all G heads of the group.
    for (int t = warp; t < n; t += kWarps) {
      const KV* krow = kp + (size_t)(t0 + t) * slot_stride;
      float dots[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) dots[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kd = widen(krow[d]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) dots[g] += q_s[g * D + d] * kd;
      }
      float ks = 1.f;
      if (kQuant) ks = ksp[(size_t)(t0 + t) * scale_stride];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float dot = warp_sum(dots[g]);
          if (lane == 0) p_s[g * kTile + t] = kQuant ? dot * scale * ks : dot * scale;
        }
      }
    }
    __syncthreads();

    // 2. Online softmax: warp w takes heads w, w + kWarps, ...  The sum
    //    accumulates the float32 probabilities; the value product reads
    //    them rounded to bfloat16 (the reference's p.astype(v.dtype)),
    //    after the int8 leg's v_scale multiplies them.
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTile;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        float p = expf(row[t] - m_new);
        sum += p;
        if (kQuant) p *= vsp[(size_t)(t0 + t) * scale_stride];
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
      const KV* vcol = vp + (size_t)t0 * slot_stride + d;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < n; ++t)
        a += prow[t] * widen(vcol[(size_t)t * slot_stride]);
      acc_s[i] = a;
    }
    __syncthreads();
  }
}

// Write the normalized output of the group (out_group: [G, D] bf16).
__device__ __forceinline__ void finish(float* smem, int G, int D,
                                       __nv_bfloat16* out_group) {
  DLT_DECODE_SMEM(smem, G, D)
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    out_group[i] = __float2bfloat16(acc_s[i] / fmaxf(l_s[g], 1e-37f));
  }
}

// True for head shapes no decode kernel takes.
__host__ inline bool bad_shape(int B, int H, int KVH, int D) {
  return B < 1 || B > 65535 || KVH < 1 || KVH > 65535 || H % KVH != 0 ||
         H / KVH > kMaxGroup || D < 8 || D % 8 != 0 || D > kMaxHeadDim;
}

}  // namespace dlt_decode
