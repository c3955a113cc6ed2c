// Weight-only quantized matrix product for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel distributed_llms_tpu/ops/quant_matmul.py
// `_quant_matmul_2d` -> `_kernel`:
//
//   w[k, n]   = T(float(q[k, n]) * s[k, n / block])       (T = x's dtype)
//   out[m, n] = T(sum_k float(x[m, k]) * float(w[k, n]))  (f32 accumulation)
//
// Layouts (all contiguous, row-major):
//   x    [M, K]              bf16 or float32 activations
//   q    [K, N] int8, or [K/2, N] row-packed int4: byte [r, n] holds
//        q[2r, n] in its low nibble and q[2r+1, n] in its high nibble,
//        both sign-extended
//   s    [K, N / block]      float32 absmax scales, one per (K row, block
//                            of N columns); any block that divides N
//   out  [M, N]              x's dtype
//
// What bounds it on the H100: at decode (M of a few rows) the bytes — every
// weight code is read once per product, K * N bytes in int8 and half that
// in int4, plus K * N / block scales — at 3.35 TB/s; at prefill (M in the
// hundreds) the 2 * M * K * N tensor-core operations at 989 TFLOP/s.
//
// This first design is simple and correct, not fast.  One block of four
// warps owns a BM x 64 output tile (BM = 16 when M <= 16, else 64) and walks
// K in steps of 64: each step stages the x tile and the weight tile in
// shared memory, the weight codes read with 16-byte loads along N
// (contiguous) and dequantized to T on the way in — a dequantized weight
// never exists in device memory — and the four warps run WMMA
// m16n16k16 bf16 products with f32 accumulators, one 16-column strip each.
// The next step's codes are fetched into registers while the current step
// computes.  float32 activations take a scalar-FMA body over the same
// tiles.  M and N tails and K tails are bounds-checked (zeros), not padded.
// Known weak spot, left for a later change: at decode the grid is N / 64
// blocks (16 for wk/wv's N = 1024 on 132 SMs) and each walks all of K
// serially — split-K, TMA and wgmma are the cure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // four warps
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // K rows (unpacked) per step

__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

union Chunk {  // 16 bytes: one vector load
  uint4 v;
  int8_t b[16];
};

// ---- x tile: rows m0 .. m0+BM-1, columns k0 .. k0+kBK-1 -------------------

template <typename T, int BM>
struct XTile {
  static constexpr int kVec = 16 / sizeof(T);            // elements per chunk
  static constexpr int kChunks = BM * kBK / kVec;         // per tile
  static constexpr int kPerThread = kChunks / kThreads;   // exact
  static constexpr int kLd = kBK + kVec;                  // smem row stride
  Chunk r[kPerThread];

  __device__ __forceinline__ void fetch(const T* __restrict__ x, int m0,
                                        int k0, int M, int K, bool vec) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (kBK / kVec);
      const int col = (c % (kBK / kVec)) * kVec;
      const int m = m0 + row, k = k0 + col;
      r[i].v = make_uint4(0, 0, 0, 0);
      if (m >= M) continue;
      const T* src = x + (size_t)m * K + k;
      if (vec) {  // K % kVec == 0: a chunk is all in or all out
        if (k < K) r[i].v = *reinterpret_cast<const uint4*>(src);
      } else {
        T* e = reinterpret_cast<T*>(r[i].b);
        for (int j = 0; j < kVec; ++j)
          e[j] = (k + j < K) ? src[j] : from_float<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void store(T* xs) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (kBK / kVec);
      const int col = (c % (kBK / kVec)) * kVec;
      *reinterpret_cast<uint4*>(xs + row * kLd + col) = r[i].v;
    }
  }
};

// ---- weight tile: unpacked rows k0 .. k0+kBK-1, columns n0 .. n0+kBN-1 ----

template <int BITS>
struct WTile {
  static constexpr int kRows = BITS == 8 ? kBK : kBK / 2;  // stored rows
  static constexpr int kChunks = kRows * (kBN / 16);
  static constexpr int kPerThread = kChunks / kThreads;    // exact
  static constexpr int kLd = kBN + 8;                      // smem row stride
  Chunk r[kPerThread];

  __device__ __forceinline__ void fetch(const int8_t* __restrict__ q,
                                        int k0, int n0, int K, int N,
                                        bool vec) {
    const int kp0 = BITS == 8 ? k0 : k0 / 2;
    const int Kp = BITS == 8 ? K : K / 2;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int kp = kp0 + c / (kBN / 16);
      const int n = n0 + (c % (kBN / 16)) * 16;
      r[i].v = make_uint4(0, 0, 0, 0);
      if (kp >= Kp || n >= N) continue;
      const int8_t* src = q + (size_t)kp * N + n;
      if (vec) {  // N % 16 == 0: a chunk is all in or all out
        r[i].v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        for (int j = 0; j < 16; ++j) r[i].b[j] = (n + j < N) ? src[j] : 0;
      }
    }
  }

  // Dequantize 16 codes of unpacked row k, columns n .. n+15, into dst.
  template <typename T>
  static __device__ __forceinline__ void dequant16(
      const int8_t* v, const float* __restrict__ s, int k, int n, int K,
      int N, int nb, int block, T* dst) {
    if (k >= K || n >= N) {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = from_float<T>(0.f);
      return;
    }
    const float* srow = s + (size_t)k * nb;
    if (block % 16 == 0 && n + 16 <= N) {
      // n is a multiple of 16 and so is every block edge: one scale.
      const float sc = __ldg(srow + n / block);
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = from_float<T>(to_float(v[j]) * sc);
    } else {
      for (int j = 0; j < 16; ++j)
        dst[j] = (n + j < N)
                     ? from_float<T>(to_float(v[j]) * __ldg(srow + (n + j) / block))
                     : from_float<T>(0.f);
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* ws, const float* __restrict__ s,
                                        int k0, int n0, int K, int N, int nb,
                                        int block) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (kBN / 16);
      const int col = (c % (kBN / 16)) * 16;
      const int n = n0 + col;
      if (BITS == 8) {
        dequant16(r[i].b, s, k0 + row, n, K, N, nb, block,
                  ws + row * kLd + col);
      } else {
        int8_t lo[16], hi[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int b = r[i].b[j];
          lo[j] = (int8_t)(((b & 0xF) ^ 8) - 8);  // sign-extended low nibble
          hi[j] = (int8_t)(b >> 4);               // arithmetic shift
        }
        dequant16(lo, s, k0 + 2 * row, n, K, N, nb, block,
                  ws + (2 * row) * kLd + col);
        dequant16(hi, s, k0 + 2 * row + 1, n, K, N, nb, block,
                  ws + (2 * row + 1) * kLd + col);
      }
    }
  }
};

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;
  void* out;
  int M, K, N, nb, block;
  bool xvec, wvec;
};

// bf16 activations: WMMA m16n16k16, f32 accumulators.  Warp w owns output
// columns [16w, 16w + 16) of the tile, all BM / 16 fragment rows.
template <int BM, int BITS>
__global__ void __launch_bounds__(kThreads) quant_matmul_bf16_kernel(Args a) {
  using T = __nv_bfloat16;
  using X = XTile<T, BM>;
  using W = WTile<BITS>;
  constexpr int kFr = BM / 16;
  constexpr int kLdc = kBN + 4;
  __shared__ __align__(128) T xs[BM * X::kLd];
  __shared__ __align__(128) T ws[kBK * W::kLd];
  __shared__ __align__(128) float cs[BM * kLdc];

  const T* x = static_cast<const T*>(a.x);
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFr];
#pragma unroll
  for (int i = 0; i < kFr; ++i) wmma::fill_fragment(acc[i], 0.f);

  X xt;
  W wt;
  xt.fetch(x, m0, 0, a.M, a.K, a.xvec);
  wt.fetch(a.q, 0, n0, a.K, a.N, a.wvec);
  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    xt.store(xs);
    wt.store(ws, a.s, k0, n0, a.K, a.N, a.nb, a.block);
    __syncthreads();
    if (k0 + kBK < a.K) {  // next step's codes in flight during the products
      xt.fetch(x, m0, k0 + kBK, a.M, a.K, a.xvec);
      wt.fetch(a.q, k0 + kBK, n0, a.K, a.N, a.wvec);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, ws + kk * W::kLd + warp * 16, W::kLd);
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
        wmma::load_matrix_sync(af, xs + i * 16 * X::kLd + kk, X::kLd);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFr; ++i)
    wmma::store_matrix_sync(cs + i * 16 * kLdc + warp * 16, acc[i], kLdc,
                            wmma::mem_row_major);
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < BM * kBN; e += kThreads) {
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m < a.M && n < a.N)
      out[(size_t)m * a.N + n] = __float2bfloat16_rn(cs[(e / kBN) * kLdc + e % kBN]);
  }
}

// float32 activations (small CPU-sized shapes): scalar FMAs over the same
// tiles; thread t owns column t % 64 of rows 8 * (t / 64) .. + 7.
template <int BITS>
__global__ void __launch_bounds__(kThreads) quant_matmul_f32_kernel(Args a) {
  constexpr int BM = 16;
  using X = XTile<float, BM>;
  using W = WTile<BITS>;
  __shared__ __align__(128) float xs[BM * X::kLd];
  __shared__ __align__(128) float ws[kBK * W::kLd];

  const float* x = static_cast<const float*>(a.x);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int col = threadIdx.x % kBN, r0 = (threadIdx.x / kBN) * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  X xt;
  W wt;
  xt.fetch(x, m0, 0, a.M, a.K, a.xvec);
  wt.fetch(a.q, 0, n0, a.K, a.N, a.wvec);
  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    xt.store(xs);
    wt.store(ws, a.s, k0, n0, a.K, a.N, a.nb, a.block);
    __syncthreads();
    if (k0 + kBK < a.K) {
      xt.fetch(x, m0, k0 + kBK, a.M, a.K, a.xvec);
      wt.fetch(a.q, k0 + kBK, n0, a.K, a.N, a.wvec);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = ws[kk * W::kLd + col];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(xs[(r0 + i) * X::kLd + kk], w, acc[i]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out);
  const int n = n0 + col;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + r0 + i;
    if (m < a.M && n < a.N) out[(size_t)m * a.N + n] = acc[i];
  }
}

template <int BITS>
cudaError_t launch(const Args& a, bool bf16, cudaStream_t stream) {
  const int gx = (a.N + kBN - 1) / kBN;
  if (!bf16) {
    const int gy = (a.M + 15) / 16;
    if (gy > 65535) return cudaErrorInvalidValue;
    quant_matmul_f32_kernel<BITS><<<dim3(gx, gy), kThreads, 0, stream>>>(a);
  } else if (a.M <= 16) {
    quant_matmul_bf16_kernel<16, BITS><<<dim3(gx, 1), kThreads, 0, stream>>>(a);
  } else {
    const int gy = (a.M + 63) / 64;
    if (gy > 65535) return cudaErrorInvalidValue;
    quant_matmul_bf16_kernel<64, BITS><<<dim3(gx, gy), kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// out[M, N] = x[M, K] @ dequant(q, s).  x_bf16: 1 for bfloat16 x and out,
// 0 for float32.  Returns a cudaError_t (0 = launched).
extern "C" int dlt_quant_matmul(const void* x, const void* q, const void* s,
                                void* out, int M, int K, int N, int nb,
                                int bits, int x_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 1 || nb < 1 || N % nb ||
      (bits != 8 && bits != 4) || (bits == 4 && K % 2))
    return (int)cudaErrorInvalidValue;
  const int vec_elems = x_bf16 ? 8 : 4;
  Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(s), out,
         M, K, N, nb, N / nb,
         (reinterpret_cast<uintptr_t>(x) % 16 == 0) && K % vec_elems == 0,
         (reinterpret_cast<uintptr_t>(q) % 16 == 0) && N % 16 == 0};
  const cudaError_t err =
      bits == 8 ? launch<8>(a, x_bf16 != 0, (cudaStream_t)stream)
                : launch<4>(a, x_bf16 != 0, (cudaStream_t)stream);
  return (int)err;
}
