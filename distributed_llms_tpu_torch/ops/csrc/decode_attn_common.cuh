// What the port's decode-attention kernels share beyond their split body
// (split_decode.cuh): the head shapes they take and the warp reductions
// of the merge.  Both kernels — paged_decode_attn.cu (K1 and its int8 leg
// K1q) and ragged_decode_attn.cu (K2, K2q) — replace the TPU kernel
// distributed_llms_tpu/ops/decode_attn.py `_kernel`: one query token per
// row, grouped-query attention, scores in float32 scaled by D^-0.5, a
// running max / running sum softmax in float32, the probabilities rounded
// to bfloat16 before the value product, which accumulates in float32, and
// the output acc / max(l, 1e-37) in bfloat16.  The int8 leg's scales fold
// in where the TPU kernel folds them (:121-148): the score is (q . k_i8) *
// D^-0.5 * k_scale, the running sum adds p BEFORE v_scale, and the value
// product reads bf16(p * v_scale); a dequantized K/V element never exists
// in device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dlt_decode {

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

// True for head shapes no decode kernel takes.
__host__ inline bool bad_shape(int B, int H, int KVH, int D) {
  return B < 1 || B > 65535 || KVH < 1 || KVH > 65535 || H % KVH != 0 ||
         H / KVH > kMaxGroup || D < 8 || D % 8 != 0 || D > kMaxHeadDim;
}

}  // namespace dlt_decode
