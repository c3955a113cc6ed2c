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
// The bf16 design: split-K over tensor-core tiles, the weight dequantized
// in registers.
// - The product is computed transposed, out^T = W^T x^T, on mma.sync
//   m16n8k16 (bf16 in, float32 accumulators): the weight is the 16-row A
//   operand and x the 8-column B operand, so at decode N fills the
//   tensor core's long side and 8 rows of x its short one.
// - A block owns 32 x WARPS output columns (each warp 32 of them) and 8 x
//   FM rows of x, over one split of K: a run of whole 64-row tiles that
//   `qmm_plan` (ops/quant_matmul.py) picks from the shapes so that the
//   grid fills the card at decode; prefill takes 128-row x tiles (each
//   warp 32 columns by 128 rows: every code it dequantizes feeds 16
//   products) and no split.
// - Loads: codes stay 1 byte (int8) or half a byte (int4) until they reach
//   registers.  Each 64-row tile of codes, x and scales is copied with
//   cp.async (16-byte chunks; 4 bytes a scale) into a ring of kStages
//   shared-memory stages, kStages - 1 tiles in flight ahead of the
//   products.
// - Fragments: a warp's A fragments are permuted (rows to columns, K
//   within each 16-deep step — x's B fragments take the same K order)
//   so that lane (g, t) needs the 4 columns 4g .. 4g+3 of the K rows
//   4t .. 4t+3: one 32-bit shared load per K row (int8), or one per pair
//   of rows (int4, whose bytes already hold a (k, k+1) pair), and x's
//   4 values in one 8-byte load.
// - Dequantization happens in registers, straight into the fragments,
//   with the TPU kernel's rounding point: each code goes to float32 by a
//   byte permute and a subtraction, times its (k, n / block) scale,
//   rounded to bf16.  A dequantized weight never exists in memory.
// - The splits of one output tile run as one thread-block cluster (at most
//   kMaxSplits blocks).  Each block leaves its float32 partial tile in its
//   shared memory; after a cluster barrier, block r sums its share of the
//   tile over the cluster's blocks through distributed shared memory, in
//   rank order, rounds to bf16 and stores it.  No workspace, no second
//   kernel and no atomics: a call's bits do not change from run to run.
// Shapes off the tiles are masked: rows of K, N and M past the ends load
// as zeros and are not stored.  With N % 16 != 0 (or K % 8 != 0 for x)
// a 16-byte chunk may straddle a row end, and those loads go byte by byte
// (element by element) instead: a correctness leg for odd shapes, taken
// from the shapes alone.  float32 activations take a scalar body over the
// same product (no served path uses it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ptx_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dlt_ptx::cp_async;

constexpr int kBK = 64;          // K rows (unpacked) per pipeline stage
constexpr int kStages = 3;       // stages of the cp.async ring
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt into
constexpr int kMaxSplits = 16;   // blocks of a cluster (non-portable above 8)

// The tile of one instantiation: WARPS warps side by side along N, 32
// output columns each; FM groups of 8 rows of x.
template <int BITS, int WARPS, int FM>
struct Geo {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kBN = 32 * WARPS;  // output columns of a block
  static constexpr int kBM = 8 * FM;      // rows of x of a block
  static constexpr int kCodeRows = BITS == 8 ? kBK : kBK / 2;  // stored rows
  static constexpr int kCodeLd = kBN + 16;  // bytes per shared code row
  static constexpr int kXLd = kBK + 16;     // bf16 per shared x row
  static constexpr int kCodeBytes = kCodeRows * kCodeLd;
  static constexpr int kXBytes = kBM * kXLd * 2;
  // One stage: codes, then x, then sc_cols columns of kBK scales.
  __host__ __device__ static int stage_bytes(int sc_cols) {
    return kCodeBytes + kXBytes + sc_cols * kBK * 4;
  }
};

// Shared row of int8 code row r of a stage.  Within each 16-row step, lane
// t reads rows 4t .. 4t+3; the rows are placed so that the four lanes of
// one column group read four different banks.
template <int BITS>
__device__ __forceinline__ int code_row(int r) {
  if (BITS == 4) return r;
  const int t = (r >> 2) & 3, j = r & 3;
  return (r & ~15) + 2 * t + 8 * (j >> 1) + (j & 1);
}

struct Args {
  const bf16* x;
  const int8_t* q;
  const float* s;
  bf16* out;
  int M, K, N, nb, block;
  int tiles_per_split, n_splits, sc_cols;
  bool xvec, wvec;  // x rows and code rows load in 16-byte chunks
};

// float32 of the signed byte i of w ^ 0x80808080, exactly: 2^23 + (q + 128)
// built from its bits, less 2^23 + 128.
__device__ __forceinline__ float i8_float(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

// float32 of the signed nibble at bit `shift` of w ^ 0x88888888, exactly.
__device__ __forceinline__ float i4_float(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) | 0x4B000000u) - 8388616.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BITS, int WARPS, int FM>
__global__ void __launch_bounds__(32 * WARPS)
    quant_matmul_mma_kernel(const Args a) {
  using G = Geo<BITS, WARPS, FM>;
  unsigned char* const smem = dlt_ptx::dynamic_smem();
  const int stage_bytes = G::stage_bytes(a.sc_cols);
  const int m0 = blockIdx.x * G::kBM, n0 = blockIdx.y * G::kBN;
  const int split = blockIdx.z;
  const int k_tiles = (a.K + kBK - 1) / kBK;
  const int kt0 = split * a.tiles_per_split;
  const int kt1 = min(kt0 + a.tiles_per_split, k_tiles);
  const int b0 = n0 / a.block;  // the tile's first scale column
  // Scale columns this tile spans (at most a.sc_cols, the stage's room).
  const int tile_cols =
      min(a.sc_cols, (min(n0 + G::kBN, a.N) - 1) / a.block - b0 + 1);

  // The 16-byte chunks a thread copies, the same in every tile: code rows
  // crow, crow + 16, ... at one column ccol; x rows xrow, xrow + kXStep,
  // ... at one column xcol.
  constexpr int kRowChunks = G::kBN / 16;
  constexpr int kRowStep = G::kThreads / kRowChunks;  // 16
  constexpr int kCodeChunks = G::kCodeRows / kRowStep;
  const int crow = threadIdx.x / kRowChunks;
  const int ccol = (threadIdx.x % kRowChunks) * 16;
  const bool c_in = n0 + ccol < a.N;
  const int8_t* const q_thread = a.q + (size_t)crow * a.N + n0 + ccol;
  const size_t q_step = (size_t)kRowStep * a.N;
  const int c_dst = code_row<BITS>(crow) * G::kCodeLd + ccol;
  const int kp_end = BITS == 8 ? a.K : a.K / 2;
  constexpr int kRowX = kBK / 8;  // chunks of an x row
  constexpr int kXStep = G::kThreads / kRowX;
  constexpr int kXChunks = (G::kBM + kXStep - 1) / kXStep;
  const int xrow = threadIdx.x / kRowX, xcol = (threadIdx.x % kRowX) * 8;
  const bf16* const x_thread = a.x + (size_t)(m0 + xrow) * a.K + xcol;
  const size_t x_step = (size_t)kXStep * a.K;
  const int x_dst = xrow * G::kXLd + xcol;
  const bool vec = a.wvec && a.xvec;  // every chunk a whole 16-byte copy

  // Copy K tile kt (codes, x, scales) into the stage at `base`.
  auto load = [&](int kt, unsigned char* base) {
    int8_t* cs = reinterpret_cast<int8_t*>(base);
    bf16* xs = reinterpret_cast<bf16*>(base + G::kCodeBytes);
    float* ss = reinterpret_cast<float*>(base + G::kCodeBytes + G::kXBytes);
    const int k0 = kt * kBK;
    const int kp0 = BITS == 8 ? k0 : k0 / 2;
    if (vec) {
      const int8_t* src = q_thread + (size_t)kp0 * a.N;
#pragma unroll
      for (int i = 0; i < kCodeChunks; ++i) {
        const bool valid = c_in && kp0 + crow + kRowStep * i < kp_end;
        cp_async<16>(cs + c_dst + kRowStep * i * G::kCodeLd,
                     valid ? src : a.q, valid);
        src += q_step;
      }
      const bf16* xsrc = x_thread + k0;
      const bool k_in = k0 + xcol < a.K;
#pragma unroll
      for (int i = 0; i < kXChunks; ++i) {
        const int r = xrow + kXStep * i;
        if (kXStep * kXChunks == G::kBM || r < G::kBM) {
          const bool valid = k_in && m0 + r < a.M;
          cp_async<16>(xs + x_dst + kXStep * i * G::kXLd,
                       valid ? xsrc : a.x, valid);
        }
        xsrc += x_step;
      }
    } else {  // odd shapes: the chunks that straddle a row end, by element
      for (int c = threadIdx.x; c < G::kCodeRows * kRowChunks;
           c += G::kThreads) {
        const int r = c / kRowChunks, col = (c % kRowChunks) * 16;
        const int kp = kp0 + r, n = n0 + col;
        int8_t* dst = cs + code_row<BITS>(r) * G::kCodeLd + col;
        const int8_t* src = a.q + (size_t)kp * a.N + n;
        for (int j = 0; j < 16; ++j)
          dst[j] = (kp < kp_end && n + j < a.N) ? src[j] : (int8_t)0;
      }
      for (int c = threadIdx.x; c < G::kBM * kRowX; c += G::kThreads) {
        const int r = c / kRowX, col = (c % kRowX) * 8;
        const int m = m0 + r, k = k0 + col;
        bf16* dst = xs + r * G::kXLd + col;
        const bf16* src = a.x + (size_t)m * a.K + k;
        for (int j = 0; j < 8; ++j)
          dst[j] = (m < a.M && k + j < a.K) ? src[j] : __float2bfloat16_rn(0.f);
      }
    }
    for (int e = threadIdx.x; e < tile_cols * kBK; e += G::kThreads) {
      const int c = e / kBK, r = e % kBK;
      const int k = k0 + r, b = b0 + c;
      const bool valid = k < a.K && b < a.nb;
      cp_async<4>(ss + c * kBK + r, valid ? a.s + (size_t)k * a.nb + b : a.s,
                  valid);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = warp * 32 + 4 * g;  // the lane's 4 columns: n0 + nq + 0..3
  int col[4];  // their scale columns in the stage (clamped past N)
#pragma unroll
  for (int i = 0; i < 4; ++i)
    col[i] = min((n0 + nq + i) / a.block - b0, tile_cols - 1);
  // Lanes' 4 columns start on multiples of 4, so with a block that is one
  // too, each lane's columns share one scale column: one scale load per
  // K row, the same branch for every block of the grid.
  const bool one_col = a.block % 4 == 0;
  const int code_at = nq;  // the lane's byte in a shared code row
  const int x_at = g * G::kXLd + 4 * t;

  float acc[2][FM][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][i][e] = 0.f;

  // The products of the stage at `base`, for every 16-row step of K.
  auto compute = [&](const unsigned char* base, auto one_col_tag) {
    constexpr bool kOneCol = decltype(one_col_tag)::value;
    const int8_t* cs = reinterpret_cast<const int8_t*>(base) + code_at;
    const bf16* xs = reinterpret_cast<const bf16*>(base + G::kCodeBytes) + x_at;
    const float* ss =
        reinterpret_cast<const float*>(base + G::kCodeBytes + G::kXBytes) +
        4 * t;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // sv[i]: the scales of column i at K rows kk + 4t .. 4t+3.
      float4 sv[kOneCol ? 1 : 4];
#pragma unroll
      for (int i = 0; i < (kOneCol ? 1 : 4); ++i)
        sv[i] = *reinterpret_cast<const float4*>(ss + col[i] * kBK + kk);
      // w[i][r]: code of column nq + i, K row kk + 4t + r, as float32.
      float w[4][4];
      if (BITS == 8) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
                                    cs + code_row<8>(kk + 4 * t + r) *
                                             G::kCodeLd) ^
                                0x80808080u;
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i][r] = i8_float(word, i);
        }
      } else {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
                                    cs + (kk / 2 + 2 * t + p) * G::kCodeLd) ^
                                0x88888888u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i][2 * p] = i4_float(word, 8 * i);
            w[i][2 * p + 1] = i4_float(word, 8 * i + 4);
          }
        }
      }
      // A fragments: tile f's rows g and g + 8 are columns nq + 2f and
      // nq + 2f + 1; its K columns 2t, 2t+1 are rows 4t, 4t+1 and 2t+8,
      // 2t+9 are rows 4t+2, 4t+3.
      uint32_t af[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const int i = 2 * f + (reg & 1), r = 2 * (reg >> 1);
          const float4& sc = sv[kOneCol ? 0 : i];
          af[f][reg] = pack_bf16(w[i][r] * (r == 0 ? sc.x : sc.z),
                                 w[i][r + 1] * (r == 0 ? sc.y : sc.w));
        }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(xs + 8 * i * G::kXLd + kk);
        dlt_ptx::mma_bf16_16816(acc[0][i], af[0], b.x, b.y);
        dlt_ptx::mma_bf16_16816(acc[1][i], af[1], b.x, b.y);
      }
    }
  };

  // The ring: tile kt0 + j lives in stage j % kStages.
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (kt0 + j < kt1) load(kt0 + j, smem + j * stage_bytes);
    dlt_ptx::cp_async_commit();
  }
  int stage = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    dlt_ptx::cp_async_wait<kStages - 2>();
    __syncthreads();
    // Refill the stage every warp finished with in the last iteration.
    const int next = kt + kStages - 1;
    const int refill = stage == 0 ? kStages - 1 : stage - 1;
    if (next < kt1) load(next, smem + refill * stage_bytes);
    dlt_ptx::cp_async_commit();
    const unsigned char* base = smem + stage * stage_bytes;
    if (one_col)
      compute(base, std::true_type{});
    else
      compute(base, std::false_type{});
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }

  // Lane (g, t) holds rows m0 + 8i + 2t + h (h = 0, 1) at columns
  // n0 + nq + 0..3.
  if (a.n_splits == 1) {
    const int n = n0 + nq;
    const bool vec = a.N % 4 == 0 && n + 4 <= a.N;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * i + 2 * t + h;
        if (m >= a.M || n >= a.N) continue;
        const float v[4] = {acc[0][i][h], acc[0][i][2 + h], acc[1][i][h],
                            acc[1][i][2 + h]};
        bf16* dst = a.out + (size_t)m * a.N + n;
        if (vec) {
          uint2 packed;
          packed.x = pack_bf16(v[0], v[1]);
          packed.y = pack_bf16(v[2], v[3]);
          *reinterpret_cast<uint2*>(dst) = packed;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < a.N) dst[j] = __float2bfloat16_rn(v[j]);
        }
      }
    return;
  }
  // Split-K: the partial tile [kBM][kBN] goes to this block's shared
  // memory; then each block of the cluster sums every n_splits-th group of
  // 4 elements over the cluster's blocks, in rank (split) order.
  dlt_ptx::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + (8 * i + 2 * t + h) * G::kBN + nq) =
          make_float4(acc[0][i][h], acc[0][i][2 + h], acc[1][i][h],
                      acc[1][i][2 + h]);
  dlt_ptx::cluster_sync();
  constexpr int kGroups = G::kBM * G::kBN / 4;
  for (int u = split + a.n_splits * threadIdx.x; u < kGroups;
       u += a.n_splits * G::kThreads) {
    float4 sum = *reinterpret_cast<const float4*>(
        dlt_ptx::cluster_smem(part, 0) + 4 * u);
    for (int r = 1; r < a.n_splits; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          dlt_ptx::cluster_smem(part, r) + 4 * u);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int m = m0 + 4 * u / G::kBN, n = n0 + 4 * u % G::kBN;
    if (m >= a.M || n >= a.N) continue;
    bf16* dst = a.out + (size_t)m * a.N + n;
    if (a.N % 4 == 0) {
      uint2 packed;
      packed.x = pack_bf16(sum.x, sum.y);
      packed.y = pack_bf16(sum.z, sum.w);
      *reinterpret_cast<uint2*>(dst) = packed;
    } else {
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < a.N) dst[j] = __float2bfloat16_rn(v[j]);
    }
  }
  dlt_ptx::cluster_sync();  // no block leaves while others read its tile
}

// (tile_m, tile_n) -> the instantiation; the table is qmm_plan's TILES.
#define DLT_QMM_TILES(X) X(8, 128, 4, 1) X(8, 64, 2, 1) X(16, 128, 4, 2) \
                         X(16, 64, 2, 2) X(64, 128, 4, 8) X(128, 128, 4, 16)

// Dynamic shared memory of a launch: the stages and, with splits, room
// for the partial tile.
template <int BITS, int WARPS, int FM>
int smem_bytes(int sc_cols, int n_splits) {
  using G = Geo<BITS, WARPS, FM>;
  const int stages = kStages * G::stage_bytes(sc_cols);
  const int part = n_splits > 1 ? G::kBM * G::kBN * 4 : 0;
  return stages > part ? stages : part;
}

template <int BITS, int WARPS, int FM>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  using G = Geo<BITS, WARPS, FM>;
  auto kernel = quant_matmul_mma_kernel<BITS, WARPS, FM>;
  static const cudaError_t opted = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (opted != cudaSuccess) return opted;
  const int smem = smem_bytes<BITS, WARPS, FM>(a.sc_cols, a.n_splits);
  const dim3 grid((a.M + G::kBM - 1) / G::kBM, (a.N + G::kBN - 1) / G::kBN,
                  a.n_splits);
  if (smem > kSmemMax || grid.y > 65535) return cudaErrorInvalidValue;
  if (a.n_splits == 1) {
    kernel<<<grid, G::kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.n_splits;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(G::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Scale columns a tile of tile_n columns can span: ceil over any offset
// of the tile within a block, at most nb.
int scale_cols(int tile_n, int block, int nb) {
  const int cols = (block - 1 + tile_n - 1) / block + 1;
  return cols < nb ? cols : nb;
}

// ---- float32 activations: a scalar body (no served path) ----------------

namespace f32body {

constexpr int kThreads = 128;  // four warps
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // K rows (unpacked) per step

union Chunk {  // 16 bytes: one vector load
  uint4 v;
  int8_t b[16];
};

// x tile: rows m0 .. m0+15, columns k0 .. k0+kBK-1.
struct XTile {
  static constexpr int kBM = 16;
  static constexpr int kVec = 4;                         // floats a chunk
  static constexpr int kPerThread = kBM * kBK / kVec / kThreads;
  static constexpr int kLd = kBK + kVec;                 // smem row stride
  Chunk r[kPerThread];

  __device__ __forceinline__ void fetch(const float* __restrict__ x, int m0,
                                        int k0, int M, int K, bool vec) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (kBK / kVec);
      const int col = (c % (kBK / kVec)) * kVec;
      const int m = m0 + row, k = k0 + col;
      r[i].v = make_uint4(0, 0, 0, 0);
      if (m >= M) continue;
      const float* src = x + (size_t)m * K + k;
      if (vec) {  // K % 4 == 0: a chunk is all in or all out
        if (k < K) r[i].v = *reinterpret_cast<const uint4*>(src);
      } else {
        float* e = reinterpret_cast<float*>(r[i].b);
        for (int j = 0; j < kVec; ++j) e[j] = (k + j < K) ? src[j] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* xs) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (kBK / kVec);
      const int col = (c % (kBK / kVec)) * kVec;
      *reinterpret_cast<uint4*>(xs + row * kLd + col) = r[i].v;
    }
  }
};

// Weight tile: unpacked rows k0 .. k0+kBK-1, columns n0 .. n0+kBN-1.
template <int BITS>
struct WTile {
  static constexpr int kRows = BITS == 8 ? kBK : kBK / 2;  // stored rows
  static constexpr int kPerThread = kRows * (kBN / 16) / kThreads;
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
  static __device__ __forceinline__ void dequant16(
      const int8_t* v, const float* __restrict__ s, int k, int n, int K,
      int N, int nb, int block, float* dst) {
    const float* srow = s + (size_t)k * nb;
    for (int j = 0; j < 16; ++j)
      dst[j] = (k < K && n + j < N) ? (float)v[j] * __ldg(srow + (n + j) / block)
                                    : 0.f;
  }

  __device__ __forceinline__ void store(float* ws, const float* __restrict__ s,
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

// Thread t owns column t % 64 of rows 8 * (t / 64) .. + 7 of a 16 x 64
// tile; the next step's x and codes are fetched while this one computes.
template <int BITS>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_f32_kernel(const float* x, const int8_t* q, const float* s,
                            float* out, int M, int K, int N, int nb,
                            int block, bool xvec, bool wvec) {
  using W = WTile<BITS>;
  __shared__ __align__(128) float xs[XTile::kBM * XTile::kLd];
  __shared__ __align__(128) float ws[kBK * W::kLd];

  const int m0 = blockIdx.y * XTile::kBM, n0 = blockIdx.x * kBN;
  const int col = threadIdx.x % kBN, r0 = (threadIdx.x / kBN) * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  XTile xt;
  W wt;
  xt.fetch(x, m0, 0, M, K, xvec);
  wt.fetch(q, 0, n0, K, N, wvec);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    xt.store(xs);
    wt.store(ws, s, k0, n0, K, N, nb, block);
    __syncthreads();
    if (k0 + kBK < K) {
      xt.fetch(x, m0, k0 + kBK, M, K, xvec);
      wt.fetch(q, k0 + kBK, n0, K, N, wvec);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = ws[kk * W::kLd + col];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = fmaf(xs[(r0 + i) * XTile::kLd + kk], w, acc[i]);
    }
    __syncthreads();
  }
  const int n = n0 + col;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + r0 + i;
    if (m < M && n < N) out[(size_t)m * N + n] = acc[i];
  }
}

}  // namespace f32body

bool bad_operands(int M, int K, int N, int nb, int bits) {
  return M < 1 || K < 1 || N < 1 || nb < 1 || N % nb ||
         (bits != 8 && bits != 4) || (bits == 4 && K % 2);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int BITS, int WARPS, int FM>
int resources(int sc_cols, int* info) {
  using G = Geo<BITS, WARPS, FM>;
  auto kernel = quant_matmul_mma_kernel<BITS, WARPS, FM>;
  const int smem = smem_bytes<BITS, WARPS, FM>(sc_cols, 1);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  cudaFuncAttributes attr;
  int blocks = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      G::kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int got[7] = {G::kThreads, G::kBM, G::kBN, smem, blocks,
                      attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 7; ++i) info[i] = got[i];
  return 0;
}

}  // namespace

// out[M, N] = x[M, K] @ dequant(q, s) for bfloat16 x and out, on the plan
// (tile_m, tile_n, k_per_split, n_splits) of qmm_plan: splits of
// k_per_split K rows (whole 64-row tiles) covering K, at most kMaxSplits.
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch (0 = launched), or cudaErrorInvalidValue for shapes, plans or
// pointers the kernel does not take (x must be 16-byte aligned when
// K % 8 == 0, q when N % 16 == 0).
extern "C" int dlt_quant_matmul(const void* x, const void* q, const void* s,
                                void* out, int M, int K, int N, int nb,
                                int bits, int tile_m, int tile_n,
                                int k_per_split, int n_splits, void* stream) {
  if (bad_operands(M, K, N, nb, bits) || k_per_split < kBK ||
      k_per_split % kBK || n_splits < 1 || n_splits > kMaxSplits ||
      n_splits != (K + k_per_split - 1) / k_per_split)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
         static_cast<const float*>(s), static_cast<bf16*>(out), M, K, N, nb,
         N / nb, k_per_split / kBK, n_splits, scale_cols(tile_n, N / nb, nb),
         K % 8 == 0, N % 16 == 0};
  if ((a.xvec && !aligned16(x)) || (a.wvec && !aligned16(q)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DLT_QMM_LAUNCH(TM, TN, WARPS, FM)                         \
  if (tile_m == TM && tile_n == TN)                               \
    return (int)(bits == 8 ? launch_mma<8, WARPS, FM>(a, st)      \
                           : launch_mma<4, WARPS, FM>(a, st));
  DLT_QMM_TILES(DLT_QMM_LAUNCH)
#undef DLT_QMM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The same product for float32 x and out (the scalar body; no plan).
extern "C" int dlt_quant_matmul_f32(const void* x, const void* q,
                                    const void* s, void* out, int M, int K,
                                    int N, int nb, int bits, void* stream) {
  if (bad_operands(M, K, N, nb, bits)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + f32body::kBN - 1) / f32body::kBN,
                  (M + f32body::XTile::kBM - 1) / f32body::XTile::kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool xvec = aligned16(x) && K % 4 == 0;
  const bool wvec = aligned16(q) && N % 16 == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(s);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    f32body::quant_matmul_f32_kernel<8><<<grid, f32body::kThreads, 0, st>>>(
        xf, qb, sf, of, M, K, N, nb, N / nb, xvec, wvec);
  else
    f32body::quant_matmul_f32_kernel<4><<<grid, f32body::kThreads, 0, st>>>(
        xf, qb, sf, of, M, K, N, nb, N / nb, xvec, wvec);
  return (int)cudaGetLastError();
}

// Resources of the bf16 instantiation of a (tile_m, tile_n) tile (int8
// codes with bits = 8, int4 with 4) with scale blocks of `block` columns,
// into info[0..6]: {threads, tile_m, tile_n, dynamic shared memory bytes of
// the stages, resident blocks per SM, registers per thread, local (spill)
// bytes per thread}.
extern "C" int dlt_quant_matmul_resources(int tile_m, int tile_n, int bits,
                                          int block, int* info) {
  if ((bits != 8 && bits != 4) || block < 1) return (int)cudaErrorInvalidValue;
  const int sc_cols = scale_cols(tile_n, block, block + tile_n);
#define DLT_QMM_RESOURCES(TM, TN, WARPS, FM)                         \
  if (tile_m == TM && tile_n == TN)                                  \
    return bits == 8 ? resources<8, WARPS, FM>(sc_cols, info)        \
                     : resources<4, WARPS, FM>(sc_cols, info);
  DLT_QMM_TILES(DLT_QMM_RESOURCES)
#undef DLT_QMM_RESOURCES
  return (int)cudaErrorInvalidValue;
}
