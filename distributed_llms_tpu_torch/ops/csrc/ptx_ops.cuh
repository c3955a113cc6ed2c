// PTX wrappers of the port's kernels: asynchronous global -> shared copies
// (the decode kernels' split body, split_decode.cuh, and K5,
// quant_matmul.cu), and for K5 bf16 tensor-core products, the block's
// dynamic shared memory and its thread-block cluster.  Everything the
// kernels do through inline PTX or cluster hardware goes through these
// few functions.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dlt_ptx {

// The block's dynamic shared memory (16-byte aligned).
__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// Asynchronous copy of kBytes (16, 8 or 4) from global to shared memory;
// a copy that is not `valid` reads nothing and fills the destination with
// zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d += a (16 x 16, row major) * b (16 x 8, column major): bf16 inputs,
// float32 accumulators, one warp.  Fragments as PTX's mma.m16n8k16 lays
// them out: lane (g = lane / 4, t = lane % 4) holds a = {A[g][2t..2t+1],
// A[g+8][2t..2t+1], A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]}, b = {B[2t..2t+1]
// [g], B[2t+8..2t+9][g]} (lower column / row in the low half) and d =
// {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Barrier over every thread of the block's cluster; shared-memory writes
// before it are visible to the cluster's blocks after it.
__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

// The address of `p` (in this block's shared memory) in the shared memory
// of the cluster's block `rank`.
__device__ __forceinline__ const float* cluster_smem(const float* p,
                                                    int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(
      const_cast<float*>(p), rank);
}

}  // namespace dlt_ptx
