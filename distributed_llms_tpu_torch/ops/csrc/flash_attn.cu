// Flash attention for Hopper (sm_90a): K3 (static causal) and K4 (dynamic
// positions and validity).
//
// Replaces the two TPU kernels of distributed_llms_tpu/ops/flash.py:
//   K3  `_flash` -> `_kernel_static`  (the call at :291): causal attention
//       with standard positions (Tq == S, row i attends keys j <= i, and
//       j > i - window with a window: INDEX space) — the training forward;
//   K4  `_flash` -> `_kernel_dynamic` (the call at :335): explicit
//       q_positions / k_positions / k_valid, optional causality and a
//       window in POSITION space (kpos > qpos - window) — the cached
//       prefill.
// Both keep the TPU kernels' numerics (`_scores`, `_accumulate`,
// `_finish`): scores (q . k) * D^-0.5 in float32, masked entries at
// finfo(float32).min, a running max / running sum softmax in float32 whose
// shift is 0 while a row has seen no live key (so such a row outputs
// zeros), each tile's probabilities rounded to bfloat16 before the value
// product, which accumulates in float32, and out = acc / max(l, 1e-37).
//
// Layouts (all contiguous; no transposed copies — the TPU wrapper's
// [B, H, T, D] relayout is not needed here):
//   q, out   [B, Tq, H, D]    bf16
//   k, v     [B, S, KVH, D]   bf16; query head h reads KV head h / (H / KVH)
//   qpos     [B, Tq] int32    (K4 only)
//   kpos     [B, S]  int32    (K4 only)
//   kval     [B, S]  int32    nonzero = a valid key slot (K4 only)
//
// What bounds it on the H100: the operations, 4 * D * H per live (row,
// key) pair (QK and PV, a multiply-add each) at 989 TFLOP/s in bf16; the
// bytes (q, k, v, out once) are far smaller at prefill and training
// lengths.  The kernel never holds the score matrix in device memory: one
// block owns a (query tile of 64 rows, head, batch row) triple, keeps its
// float32 accumulator in shared memory and walks the key tiles of 64
// slots in order with the online-softmax recurrence.  Four warps own 16
// query rows each and run WMMA m16n16k16 bf16 products with float32
// accumulators: the warp's queries stay in registers as matrix fragments
// for the whole walk, the K and V tiles are staged in shared memory once
// per tile and shared by the four warps.
//
// Tile skipping:
//   K3  computes its live key-tile range arithmetically — from the
//       diagonal above and the window's lower edge below, as the TPU
//       wrapper's clamped index map (:283-289) does — and never loads a
//       dead tile.  Only boundary tiles (crossing the diagonal or the
//       window edge) build the row/column mask.
//   K4  loads each tile's positions and validity first and skips the
//       tile's loads and products when no (row, key) pair is live, by a
//       block-wide __syncthreads_or (the TPU kernel's
//       pl.when(jnp.any(mask)), :201).
// Rows past Tq and slots past S are bounds-checked (zero-filled loads,
// masked keys, unwritten rows) where the TPU wrapper pads rows with
// position -1 and slots with validity 0 (:332-334): the same results.
//
// This first design is simple and correct, not fast: the loads are
// synchronous (no cp.async / TMA ring), the accumulator round-trips
// through shared memory at every tile, and wgmma is not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps, 16 query rows each
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key slots per tile
constexpr float kNegInf = -3.402823466e+38f;  // finfo(float32).min

// Dynamic shared memory of a block, in bytes from its base (each region a
// multiple of 128 bytes, so every WMMA pointer below is 32-byte aligned).
// The query tile is staged in the accumulator's region: it is read into
// fragments before the accumulator is zeroed.
template <int D>
struct Layout {
  static constexpr int kLdKV = D + 8;   // bf16 row stride: K, V, staged Q
  static constexpr int kLdS = kBK + 4;  // float row stride: scores
  static constexpr int kLdP = kBK + 8;  // bf16 row stride: probabilities
  static constexpr int kLdO = D + 4;    // float row stride: accumulator
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + (size_t)kBK * kLdKV * 2;
  static constexpr size_t kS = kV + (size_t)kBK * kLdKV * 2;
  static constexpr size_t kP = kS + (size_t)kBQ * kLdS * 4;
  static constexpr size_t kO = kP + (size_t)kBQ * kLdP * 2;
  static constexpr size_t kQPos = kO + (size_t)kBQ * kLdO * 4;
  static constexpr size_t kKPos = kQPos + kBQ * 4;
  static constexpr size_t kKVal = kKPos + kBK * 4;
  static constexpr size_t kBytes = kKVal + kBK * 4;
};

// Stage rows [row0, row0 + 64) of a [rows, D] operand whose row r starts
// at src + r * stride into dst (row stride ld); rows at or past `limit`
// are zeros.  16-byte loads, neighbouring threads on neighbouring chunks.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          size_t stride, int row0, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kBQ * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + col));
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// Whether key slot (kp, valid) is live for a query at position qp (K4).
__device__ __forceinline__ bool live_pair(int qp, int kp, int valid,
                                          int causal, int window) {
  return valid != 0 && (!causal || kp <= qp) &&
         (window <= 0 || (long long)kp > (long long)qp - window);
}

template <int D, bool kDynamic>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ kpos, const int32_t* __restrict__ kval,
             bf16* __restrict__ out, int Tq, int S, int H, int KVH,
             int causal, int window, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::kV);
  float* Ss = reinterpret_cast<float*>(smem + L::kS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::kP);
  float* Os = reinterpret_cast<float*>(smem + L::kO);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::kO);  // staging, see Layout
  int32_t* qpos_s = reinterpret_cast<int32_t*>(smem + L::kQPos);
  int32_t* kpos_s = reinterpret_cast<int32_t*>(smem + L::kKPos);
  int32_t* kval_s = reinterpret_cast<int32_t*>(smem + L::kKVal);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_rows = min(kBQ, Tq - q0);  // real query rows of this block
  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KVH * D;
  const bf16* qb = q + ((size_t)b * Tq * H + h) * D;
  const bf16* kb = k + ((size_t)b * S * KVH + kvh) * D;
  const bf16* vb = v + ((size_t)b * S * KVH + kvh) * D;

  // 1. The warp's 16 query rows as matrix fragments, kept for the walk.
  load_tile<D>(Qs, L::kLdKV, qb, q_stride, q0, Tq);
  if (kDynamic && tid < kBQ)
    qpos_s[tid] = tid < n_rows ? qpos[(size_t)b * Tq + q0 + tid] : 0;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * L::kLdKV + kk * 16, L::kLdKV);
  __syncthreads();  // every warp holds its queries before Os is zeroed

  // Lanes 2r and 2r+1 own row r of the warp's 16: half a row each.
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  float* orow = Os + r * L::kLdO + half * (D / 2);
  for (int j = 0; j < D / 2; ++j) orow[j] = 0.f;
  float m = kNegInf;  // running max (finfo.min while unseeded)
  float l = 0.f;      // running sum
  const int qp_row = kDynamic ? qpos_s[r] : q0 + r;

  // 2. The key tiles.  K3: only the live range [t_lo, t_hi); K4: all.
  const int q_last = q0 + n_rows - 1;
  int t_lo = 0;
  int t_hi = (S + kBK - 1) / kBK;
  if (!kDynamic) {
    t_hi = q_last / kBK + 1;  // above the diagonal: dead
    if (window > 0) t_lo = max(0, q0 - window + 1) / kBK;  // below the band
  }
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    bool masked;
    if (!kDynamic) {
      // Fully visible: every column <= every row, and (windowed) every
      // column > every row - window.  Otherwise a boundary tile.
      masked = !(k0 + kBK - 1 <= q0 && (window <= 0 || k0 > q_last - window));
    } else {
      if (tid < kBK) {
        const int s = k0 + tid;
        kpos_s[tid] = s < S ? kpos[(size_t)b * S + s] : 0;
        kval_s[tid] = s < S ? kval[(size_t)b * S + s] : 0;
      }
      __syncthreads();
      // Thread (c, half) checks slot c against half the block's rows.
      int live = 0;
      const int c = tid % kBK;
      if (kval_s[c]) {
        const int kp = kpos_s[c];
        const int r_end = min(n_rows, (tid / kBK + 1) * (kBQ / 2));
        for (int rr = (tid / kBK) * (kBQ / 2); rr < r_end; ++rr) {
          if (live_pair(qpos_s[rr], kp, 1, causal, window)) {
            live = 1;
            break;
          }
        }
      }
      if (!__syncthreads_or(live)) continue;  // no live pair: skip the tile
      masked = true;
    }
    load_tile<D>(Ks, L::kLdKV, kb, kv_stride, k0, S);
    load_tile<D>(Vs, L::kLdKV, vb, kv_stride, k0, S);
    __syncthreads();

    // 2a. Scores of the warp's rows against the tile: [16, 64] float32.
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * L::kLdKV + kk * 16, L::kLdKV);
        wmma::mma_sync(sc, qf[kk], kf, sc);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::kLdS + n * 16, sc, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // 2b. Online softmax over the lane's 32 columns of row r.
    const float* srow = Ss + r * L::kLdS + half * 32;
    float sv[32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = srow[j] * scale;
      if (masked) {
        const int col = half * 32 + j;
        bool keep;
        if (kDynamic) {
          keep = live_pair(qp_row, kpos_s[col], kval_s[col], causal, window);
        } else {
          const int kc = k0 + col;
          keep = kc <= qp_row && (window <= 0 || kc > qp_row - window);
        }
        if (!keep) x = kNegInf;
      }
      sv[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float safe = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    const float alpha = expf(m - safe);  // 0 while unseeded
    float sum = 0.f;
    bf16* prow = Ps + r * L::kLdP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - safe);
      sum += p;
      prow[j] = __float2bfloat16_rn(p);  // the reference's p.astype(v.dtype)
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    for (int j = 0; j < D / 2; ++j) orow[j] *= alpha;
    __syncwarp();

    // 2c. acc[16, D] += P[16, 64] @ V[64, D], through the accumulator tile.
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = Os + warp * 16 * L::kLdO + j * 16;
      wmma::load_matrix_sync(acc, optr, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + warp * 16 * L::kLdP + kk * 16, L::kLdP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * L::kLdKV + j * 16, L::kLdKV);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::kLdO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V, positions and the accumulator settle
  }

  // 3. out = acc / max(l, 1e-37) for the real rows.
  __syncwarp();
  if (q0 + r < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-37f);
    bf16* dst = out + ((size_t)b * Tq + q0 + r) * q_stride + (size_t)h * D + half * (D / 2);
    for (int j = 0; j < D / 2; ++j) dst[j] = __float2bfloat16_rn(orow[j] * inv);
  }
}

template <int D, bool kDynamic>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, const void* kval, void* out, int B, int Tq,
           int S, int H, int KVH, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kernel = flash_kernel<D, kDynamic>;
  const size_t bytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(kval),
      static_cast<bf16*>(out), Tq, S, H, KVH, causal, window, scale);
  return (int)cudaGetLastError();
}

template <bool kDynamic>
int dispatch(const void* q, const void* k, const void* v, const void* qpos,
             const void* kpos, const void* kval, void* out, int B, int Tq,
             int S, int H, int KVH, int D, int causal, int window,
             float scale, void* stream) {
  if (B < 1 || B > 65535 || Tq < 1 || S < 1 || H < 1 || H > 65535 ||
      KVH < 1 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, kDynamic>(q, k, v, qpos, kpos, kval, out, B, Tq, S, H,
                                  KVH, causal, window, scale, st);
    case 128:
      return launch<128, kDynamic>(q, k, v, qpos, kpos, kval, out, B, Tq, S,
                                   H, KVH, causal, window, scale, st);
    case 256:
      return launch<256, kDynamic>(q, k, v, qpos, kpos, kval, out, B, Tq, S,
                                   H, KVH, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K3: causal attention over standard positions, q [B, T, H, D] against k/v
// [B, T, KVH, D].  `window` <= 0 means no window.  Launches on `stream`
// without synchronising; returns the cudaError_t of the launch (0 =
// launched), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int dlt_flash_attention_static(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int T, int H, int KVH, int D,
                                          int window, float scale,
                                          void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, nullptr, out, B, T, T, H,
                         KVH, D, 1, window, scale, stream);
}

// K4: q [B, Tq, H, D] at positions qpos [B, Tq] against k/v [B, S, KVH, D]
// at positions kpos [B, S] with validity kval [B, S]; `causal` 0 or 1,
// `window` <= 0 means no window.  Same launch contract as K3.
extern "C" int dlt_flash_attention_dynamic(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, const void* kval, void* out, int B, int Tq, int S,
    int H, int KVH, int D, int causal, int window, float scale,
    void* stream) {
  return dispatch<true>(q, k, v, qpos, kpos, kval, out, B, Tq, S, H, KVH, D,
                        causal, window, scale, stream);
}
