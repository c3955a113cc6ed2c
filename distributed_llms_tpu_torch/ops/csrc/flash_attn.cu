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
// zeros), l summed from the float32 probabilities, each tile's
// probabilities rounded to bfloat16 before the value product, which
// accumulates in float32, and out = acc / max(l, 1e-37).  The exponent is
// taken as exp2 of scores pre-multiplied by D^-0.5 * log2(e) (and of the
// running max in the same units): the same function, rounded elsewhere.
//
// Layouts (all contiguous; no transposed copies):
//   q, out   [B, Tq, H, D]    bf16
//   k, v     [B, S, KVH, D]   bf16; query head h reads KV head h / (H / KVH)
//   qpos     [B, Tq] int32    (K4 only)
//   kpos     [B, S]  int32    (K4 only)
//   kval     [B, S]  int32    nonzero = a valid key slot (K4 only)
//   summary  [B, ceil(S / BK)] int4 {any valid | all valid << 1, min and
//            max position over the valid slots} per key tile (K4 only;
//            written by flash_kernel_tile_summary)
//
// What bounds it on the H100: the operations, 4 * D * H per live (row,
// key) pair (QK and PV, a multiply-add each) at 989 TFLOP/s in bf16; the
// bytes (q, k, v, out once) are far smaller at prefill and training
// lengths.  What the design does about it:
//   - one block owns 128 query rows of one head: two consumer warpgroups
//     of 64 rows each and a producer warpgroup, of which one warp works
//     and all give most of their registers to the consumers (setmaxnreg).
//     Each consumer keeps its scores [64, BK], probabilities (bf16, as
//     wgmma A fragments), running max and sum and the [64, D] accumulator
//     in registers for the whole walk; row reductions are shuffles within
//     a lane quad; while one consumer runs its softmax, the other's
//     products keep the tensor cores busy;
//   - both products are warpgroup wgmma: S = Q K^T with Q and the K tile
//     in shared memory (K-major), O += P V with P in registers and the V
//     tile read MN-major through the transpose bit;
//   - the producer warp fills a 2-stage ring of K/V tiles by TMA (one box
//     per 64 columns of D, 128-byte swizzle, rows past S zero-filled),
//     completing on mbarriers: K and V of a stage apart, so S = Q K^T
//     starts before V has landed; the next tile's copies overlap this
//     tile's products.  Q is loaded once.
//   - the query tiles of the longest walks launch first (blockIdx.y counts
//     query tiles from the last), and the query heads of one KV group sit
//     next to each other in blockIdx.x, so their K/V tiles meet in L2.
//
// Tile skipping:
//   K3  walks its live key-tile range [t_lo, t_hi), computed from the
//       diagonal above and the window's lower edge below, as the TPU
//       wrapper's clamped index map (:283-289) does.
//   K4  reads one summary entry per key tile (never the tile's positions)
//       and classes the tile against the block's query-position range:
//       dead (no valid slot, every position past the block's last query,
//       or every position at or below the window's lower edge of its first
//       query: skipped, never loaded), fully visible, or boundary.  The
//       rule is conservative for any positions, shuffled ones included: a
//       kept tile with no live pair for a row changes nothing there.
//   Only boundary tiles build the per-element mask (K4's from the tile's
//   positions and validity, which the producer stages beside the tile);
//   fully visible tiles take the scores as they are, on a loop of their
//   own (flash_variants.py times the mask test inside it).
// Rows past Tq are computed on zero-filled queries and never written.

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ptx_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dlt_ptx;

constexpr int kConsumerWarps = 8;  // two warpgroups of 64 query rows
constexpr int kThreads = 3 * 128;  // + the producer warpgroup (one warp works)
constexpr int kBQ = 128;           // query rows per block
// Registers a thread after the hand-over: the launch gives every thread
// 168 (65536 / 384, rounded down to 8); the producer warpgroup keeps 40
// and the consumers take 232 (4 x 40 + 8 x 232 = 12 x 168, warps' worth).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -3.402823466e+38f;  // finfo(float32).min
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFullTile = 1 << 30;  // in a stage's tile word: no mask
constexpr int kEndOfWalk = -1;      // the tile word after the last tile

// Tiles and shared memory of the instantiation for head dim D.  Every TMA
// box is 64 columns (128 bytes) wide, the widest the 128-byte swizzle
// takes: Q is D / 64 boxes of [128 rows, 64], a K or V tile D / 64 boxes of
// [BK rows, 64].  Offsets from a 1024-byte aligned base (the swizzle's
// period); each box is a multiple of 1024 bytes.
template <int D>
struct Tiles {
  static constexpr int kBK = D == 256 ? 64 : 128;  // key slots per tile
  static constexpr int kStages = 2;                // K/V ring depth
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = kBQ * 128;
  static constexpr int kKVBox = kBK * 128;
  static constexpr int kTile = kBoxes * kKVBox;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kKV = kBoxes * kQBox;  // stage s: K, then V
  static constexpr int kBar = kKV + 2 * kStages * kTile;
  // Barriers: Q, then full K[s], full V[s], empty[s]; then the tile words;
  // then K4's boundary-tile positions and validity.
  static constexpr int kMeta = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kSlots = kMeta + 4 * kStages;
  static constexpr int kBytes = kSlots + 2 * kStages * kBK * 4;
  static constexpr int kLaunchBytes = kBytes + 1024;  // + base alignment
};

struct Args {
  bf16* out;
  const int32_t* qpos;
  const int32_t* kpos;
  const int32_t* kval;
  const int4* summary;
  int Tq, S, H, KVH, causal, window, n_ktiles;
  float scale_log2;  // D^-0.5 * log2(e)
};

// The block's shared memory: Q, the K/V ring, barriers, tile words.  A
// stage's K and V land apart (the scores need only K) and are released
// together, once the tile's value product has finished.
template <int D>
struct Smem {
  using T = Tiles<D>;
  unsigned char* base;
  __device__ __forceinline__ uint64_t* q_bar() const {
    return reinterpret_cast<uint64_t*>(base + T::kBar);
  }
  __device__ __forceinline__ uint64_t* full_k(int s) const {
    return q_bar() + 1 + s;
  }
  __device__ __forceinline__ uint64_t* full_v(int s) const {
    return q_bar() + 1 + T::kStages + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return q_bar() + 1 + 2 * T::kStages + s;
  }
  __device__ __forceinline__ int* meta(int s) const {
    return reinterpret_cast<int*>(base + T::kMeta) + s;
  }
  // A boundary tile's key positions and validity (K4), slot by slot.
  __device__ __forceinline__ int* kpos(int s) const {
    return reinterpret_cast<int*>(base + T::kSlots) + 2 * s * T::kBK;
  }
  __device__ __forceinline__ int* kval(int s) const {
    return kpos(s) + T::kBK;
  }
  __device__ __forceinline__ unsigned char* k_tile(int s) const {
    return base + T::kKV + 2 * s * T::kTile;
  }
  __device__ __forceinline__ unsigned char* v_tile(int s) const {
    return k_tile(s) + T::kTile;
  }
};

// K4's class of a key tile from its summary entry against the block's
// query positions [qmin, qmax] (64-bit compares: window may be 2^31 - 1).
enum { kDead = 0, kBoundary = 1, kFull = 2 };

__device__ __forceinline__ int classify(int4 e, int qmin, int qmax,
                                        int causal, int window) {
  const long long kmin = e.y, kmax = e.z;
  if (!(e.x & 1) || (causal && kmin > qmax) ||
      (window > 0 && kmax <= (long long)qmin - window))
    return kDead;
  if ((e.x & 2) && (!causal || kmax <= qmin) &&
      (window <= 0 || kmin > (long long)qmax - window))
    return kFull;
  return kBoundary;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The producer warp: Q once, then each live key tile's K and V into the
// ring, in ascending tile order, then the end-of-walk word.
template <int D, bool kDynamic>
__device__ __forceinline__ void produce(const CUtensorMap* q_map,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        const Args& a, const Smem<D>& sm,
                                        int q0, int h, int kvh, int b,
                                        int lane) {
  using T = Tiles<D>;
  if (lane == 0) {
    mbar_arrive_tx(sm.q_bar(), T::kBoxes * T::kQBox);
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load_4d(sm.base + T::kQ + j * T::kQBox, q_map, sm.q_bar(), 64 * j,
                  h, q0, b);
  }
  int n = 0;  // tiles pushed
  auto push = [&](int tile, bool full) {
    const int st = n % T::kStages;
    const uint32_t parity = ((n / T::kStages) & 1) ^ 1;
    const int k0 = tile * T::kBK;
    mbar_wait(sm.empty(st), parity);
    if (kDynamic && !full) {  // the slots a boundary tile masks with
      for (int i = lane; i < T::kBK; i += 32) {
        const int slot = k0 + i;
        const bool valid =
            slot < a.S && a.kval[(size_t)b * a.S + slot] != 0;
        sm.kval(st)[i] = valid;
        sm.kpos(st)[i] = valid ? a.kpos[(size_t)b * a.S + slot] : 0;
      }
      __syncwarp();
    }
    if (lane == 0) {
      *sm.meta(st) = tile | (full ? kFullTile : 0);
      mbar_arrive_tx(sm.full_k(st), T::kTile);
      for (int j = 0; j < T::kBoxes; ++j)
        tma_load_4d(sm.k_tile(st) + j * T::kKVBox, k_map, sm.full_k(st),
                    64 * j, kvh, k0, b);
      mbar_arrive_tx(sm.full_v(st), T::kTile);
      for (int j = 0; j < T::kBoxes; ++j)
        tma_load_4d(sm.v_tile(st) + j * T::kKVBox, v_map, sm.full_v(st),
                    64 * j, kvh, k0, b);
    }
    ++n;
  };
  if (!kDynamic) {
    // Rows q0 .. q_last attend columns <= q_last (and > q0 - window).
    const int q_last = min(q0 + kBQ, a.Tq) - 1;
    const int t_lo =
        a.window > 0
            ? (int)(max(0LL, (long long)q0 - a.window + 1) / T::kBK)
            : 0;
    const int t_hi = q_last / T::kBK + 1;
    for (int t = t_lo; t < t_hi; ++t) {
      const int k0 = t * T::kBK;
      push(t, k0 + T::kBK - 1 <= q0 &&
                  (a.window <= 0 ||
                   (long long)k0 > (long long)q_last - a.window));
    }
  } else {
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = lane; r < kBQ && q0 + r < a.Tq; r += 32) {
      const int p = a.qpos[(size_t)b * a.Tq + q0 + r];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
    }
    const int4* row = a.summary + (size_t)b * a.n_ktiles;
    for (int c0 = 0; c0 < a.n_ktiles; c0 += 32) {
      const int t = c0 + lane;
      const int cls = t < a.n_ktiles
                          ? classify(row[t], qmin, qmax, a.causal, a.window)
                          : kDead;
      unsigned live = __ballot_sync(0xffffffffu, cls != kDead);
      const unsigned full = __ballot_sync(0xffffffffu, cls == kFull);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        push(c0 + j, (full >> j) & 1);
      }
    }
  }
  const int st = n % T::kStages;
  mbar_wait(sm.empty(st), ((n / T::kStages) & 1) ^ 1);
  if (lane == 0) {
    *sm.meta(st) = kEndOfWalk;
    mbar_arrive(sm.full_k(st));
  }
}

// A consumer thread's rows: thread (warp w of its warpgroup, lane g * 4 +
// c) owns rows 16 w + g and 16 w + g + 8 of the group's 64 and, of each
// 8-column chunk of a tile or of D, columns 2c and 2c + 1 (the wgmma
// accumulator layout, ptx_ops.cuh).
struct Rows {
  int qp[2];  // the rows' query positions (K3: their indices)
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};  // this thread's part of the running sum
  int c;                    // lane % 4
};

// A tile's scores in log2 units; with kMasked, those of pairs that are not
// live at finfo.min (K3: by index; K4: by the tile's positions and
// validity, staged in its stage).  Returns the rows' maxima over the tile.
template <int BK, bool kDynamic, bool kMasked>
__device__ __forceinline__ void scale_tile(float (&s)[BK / 2], int k0,
                                           const Args& a, const int* kpos,
                                           const int* kval, const Rows& rw,
                                           float (&mx)[2]) {
#pragma unroll
  for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n8 * 8 + 2 * rw.c + j;
      const int kc = k0 + col;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = s[n8 * 4 + i * 2 + j] * a.scale_log2;
        if (kMasked) {
          bool keep;
          if (kDynamic) {
            const int kp = kpos[col];
            keep = kval[col] && (!a.causal || kp <= rw.qp[i]) &&
                   (a.window <= 0 ||
                    (long long)kp > (long long)rw.qp[i] - a.window);
          } else {
            keep = kc <= rw.qp[i] &&
                   (a.window <= 0 ||
                    (long long)kc > (long long)rw.qp[i] - a.window);
          }
          if (!keep) x = kNegInf;
        }
        s[n8 * 4 + i * 2 + j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }
}

// One tile's online softmax: the scores s [64, BK] of tile word `word`
// (masked unless it carries kFullTile) folded into the rows' running max
// and sum; out: the probabilities as bf16 A fragments `pa` (k-step kk of
// 16 key slots) and the accumulator's rescale `alpha`.
template <int D, bool kDynamic>
__device__ __forceinline__ void softmax_tile(
    float (&s)[Tiles<D>::kBK / 2], int word, const Args& a,
    const int* kpos, const int* kval, Rows& rw, float (&alpha)[2],
    uint32_t (&pa)[Tiles<D>::kBK / 16][4]) {
  constexpr int BK = Tiles<D>::kBK;
  const int k0 = (word & (kFullTile - 1)) * BK;
  float mx[2] = {kNegInf, kNegInf};
  if (word & kFullTile)
    scale_tile<BK, kDynamic, false>(s, k0, a, kpos, kval, rw, mx);
  else
    scale_tile<BK, kDynamic, true>(s, k0, a, kpos, kval, rw, mx);
  float shift[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(rw.m[i], mx[i]);
    // 0 while the row has seen no live key: masked entries then give
    // exp2(finfo.min) = 0, and alpha = 0 clears nothing but zeros.
    shift[i] = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    alpha[i] = exp2_approx(rw.m[i] - shift[i]);
    rw.m[i] = m_new;
  }
  // p = exp2(x - shift) in float32 into l; bf16 into A fragments.
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // Fragment register f: chunk 2 kk + f / 2, row i = f % 2.
      const int idx = (2 * kk + f / 2) * 4 + (f % 2) * 2;
      const float p0 = exp2_approx(s[idx] - shift[f % 2]);
      const float p1 = exp2_approx(s[idx + 1] - shift[f % 2]);
      sum[f % 2] += p0 + p1;
      pa[kk][f] = pack_bf16(p0, p1);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) rw.l[i] = rw.l[i] * alpha[i] + sum[i];
}

// A consumer warpgroup's walk: per tile, the scores (wgmma from shared
// memory), the softmax in registers, the accumulator's rescale, the value
// product (wgmma, P from registers); then the stage goes back to the
// producer.  The other warpgroup's products fill the tensor cores while
// this one runs its softmax.
template <int D, bool kDynamic>
__device__ __forceinline__ void consume(const Args& a, const Smem<D>& sm,
                                        int q0, int h, int b, int warp,
                                        int lane) {
  using T = Tiles<D>;
  constexpr int BK = T::kBK;
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  Rows rw;
  rw.c = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    rw.qp[i] = !kDynamic ? r
               : r < a.Tq ? a.qpos[(size_t)b * a.Tq + r]
                          : 0;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const unsigned char* q_wg = sm.base + T::kQ + wg * 64 * 128;
  mbar_wait(sm.q_bar(), 0);

  for (int n = 0;; ++n) {
    const int st = n % T::kStages;
    const uint32_t parity = (n / T::kStages) & 1;
    mbar_wait(sm.full_k(st), parity);
    const int word = *sm.meta(st);
    if (word == kEndOfWalk) break;

    // S = Q K^T: [64, BK] float32, D / 16 steps of 16.
    float s[BK / 2];
    const unsigned char* kt = sm.k_tile(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(
          s,
          wgmma_desc(q_wg + (kk / 4) * T::kQBox + (kk % 4) * 32, 16, 1024),
          wgmma_desc(kt + (kk / 4) * T::kKVBox + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    float alpha[2];
    uint32_t pa[BK / 16][4];
    softmax_tile<D, kDynamic>(s, word, a, sm.kpos(st), sm.kval(st), rw, alpha,
                              pa);
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      acc[n8 * 4 + 0] *= alpha[0];
      acc[n8 * 4 + 1] *= alpha[0];
      acc[n8 * 4 + 2] *= alpha[1];
      acc[n8 * 4 + 3] *= alpha[1];
    }

    // O += P V: BK / 16 steps; V's [BK, D] tile is MN-major for B.
    const unsigned char* vt = sm.v_tile(st);
    mbar_wait(sm.full_v(st), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_mn<D>(acc, pa[kk],
                     wgmma_desc(vt + kk * 16 * 128, T::kKVBox, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) reg_fence(pa[kk]);
    if (lane == 0) mbar_arrive(sm.empty(st));
  }

  // out = acc / max(l, 1e-37) for the real rows.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = rw.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = row0 + 8 * i;
    if (r >= a.Tq) continue;
    const float den = fmaxf(l, 1e-37f);
    bf16* dst = a.out + ((size_t)b * a.Tq + r) * a.H * D + (size_t)h * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(dst + n8 * 8 + 2 * rw.c) =
          __floats2bfloat162_rn(acc[n8 * 4 + 2 * i] / den,
                                acc[n8 * 4 + 2 * i + 1] / den);
  }
}

template <int D, bool kDynamic>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const Args a) {
  using T = Tiles<D>;
  unsigned char* raw = dynamic_smem();
  const Smem<D> sm{raw + ((1024 - (smem_addr(raw) & 1023)) & 1023)};
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tiles first
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(sm.q_bar(), 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(sm.full_k(s), 1);
      mbar_init(sm.full_v(s), 1);
      mbar_init(sm.empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {
    reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps)
      produce<D, kDynamic>(&q_map, &k_map, &v_map, a, sm, q0, h,
                           h / (a.H / a.KVH), b, lane);
  } else {
    reg_alloc<kConsumerRegs>();
    consume<D, kDynamic>(a, sm, q0, h, b, warp, lane);
  }
}

// The pre-pass of K4: summary[b, t] = {any valid | all valid << 1, min and
// max position over the valid slots (INT_MAX / INT_MIN without one), 0}
// for key tile t (slots [t BK, (t + 1) BK), those past S invalid).  One
// warp a tile.
__global__ void __launch_bounds__(128)
flash_kernel_tile_summary(const int32_t* __restrict__ kpos,
                          const int32_t* __restrict__ kval,
                          int4* __restrict__ summary, int S, int BK,
                          int n_ktiles) {
  const int t = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  if (t >= n_ktiles) return;
  int lo = INT_MAX, hi = INT_MIN;
  bool any = false, all = true;
  for (int i = lane; i < BK; i += 32) {
    const int s = t * BK + i;
    if (s < S && kval[(size_t)b * S + s] != 0) {
      const int p = kpos[(size_t)b * S + s];
      lo = min(lo, p);
      hi = max(hi, p);
      any = true;
    } else {
      all = false;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  any = __any_sync(0xffffffffu, any);
  all = __all_sync(0xffffffffu, all);
  if (lane == 0)
    summary[(size_t)b * n_ktiles + t] =
        make_int4((any ? 1 : 0) | (all ? 2 : 0), lo, hi, 0);
}

// The tensor-map encoder cuTensorMapEncodeTiled, looked up once through the
// CUDA runtime (the library links only the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a [B, R, NH, D] bf16 tensor whose box is 64 columns of D by
// `rows` rows of R, for one head and one batch row: coordinates (column,
// head, row, batch).  Rows past R read as zeros.
bool make_map(CUtensorMap* map, const void* base, int B, int R, int NH,
              int D, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)R,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)NH * D * 2,
                                 (cuuint64_t)R * NH * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kDynamic>
int launch(const void* q, const void* k, const void* v, const Args& a,
           int B, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, a.Tq, a.H, D, kBQ) ||
      !make_map(&km, k, B, a.S, a.KVH, D, T::kBK) ||
      !make_map(&vm, v, B, a.S, a.KVH, D, T::kBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel<D, kDynamic>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kLaunchBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H, (a.Tq + kBQ - 1) / kBQ, B);
  kernel<<<grid, kThreads, T::kLaunchBytes, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

int key_tile(int D) {
  switch (D) {
    case 64: return Tiles<64>::kBK;
    case 128: return Tiles<128>::kBK;
    case 256: return Tiles<256>::kBK;
    default: return 0;
  }
}

template <bool kDynamic>
int dispatch(const void* q, const void* k, const void* v, const Args& a,
             int B, int D, void* stream) {
  if (B < 1 || B > 65535 || a.Tq < 1 || a.S < 1 || a.H < 1 || a.KVH < 1 ||
      a.H % a.KVH != 0 || (a.Tq + kBQ - 1) / kBQ > 65535 ||
      key_tile(D) == 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64, kDynamic>(q, k, v, a, B, st);
    case 128: return launch<128, kDynamic>(q, k, v, a, B, st);
    default: return launch<256, kDynamic>(q, k, v, a, B, st);
  }
}

template <int D, bool kDynamic>
int resources(int* info) {
  using T = Tiles<D>;
  auto kernel = flash_kernel<D, kDynamic>;
  cudaFuncAttributes attr, pre;
  int blocks = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kLaunchBytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&pre, flash_kernel_tile_summary);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads,
                                                      T::kLaunchBytes);
  if (e != cudaSuccess) return (int)e;
  const int got[9] = {kThreads,   kBQ,          T::kBK,
                      T::kStages, T::kLaunchBytes, blocks,
                      attr.numRegs, (int)attr.localSizeBytes, pre.numRegs};
  for (int i = 0; i < 9; ++i) info[i] = got[i];
  return 0;
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
  const Args a{static_cast<bf16*>(out), nullptr, nullptr, nullptr, nullptr,
               T, T, H, KVH, 1, window, 0, scale * kLog2e};
  return dispatch<false>(q, k, v, a, B, D, stream);
}

// K4's pre-pass: the tile summary [B, ceil(S / bk)] (int4 entries) of the
// key positions kpos [B, S] and validity kval [B, S].  Same launch
// contract as K3.
extern "C" int dlt_flash_tile_summary(const void* kpos, const void* kval,
                                      void* summary, int B, int S, int bk,
                                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  const int n_ktiles = (S + bk - 1) / bk;
  flash_kernel_tile_summary<<<dim3((n_ktiles + 3) / 4, B), 128, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(kval),
      static_cast<int4*>(summary), S, bk, n_ktiles);
  return (int)cudaGetLastError();
}

// K4: q [B, Tq, H, D] at positions qpos [B, Tq] against k/v [B, S, KVH, D]
// at positions kpos [B, S] with validity kval [B, S], walking the key
// tiles that `summary` (dlt_flash_tile_summary with the same bk) does not
// class dead; `causal` 0 or 1, `window` <= 0 means no window.  bk must be
// the key tile of head dim D.  Same launch contract as K3.
extern "C" int dlt_flash_attention_dynamic(
    const void* q, const void* k, const void* v, const void* qpos,
    const void* kpos, const void* kval, const void* summary, void* out,
    int B, int Tq, int S, int H, int KVH, int D, int bk, int causal,
    int window, float scale, void* stream) {
  if (bk != key_tile(D)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<bf16*>(out),
               static_cast<const int32_t*>(qpos),
               static_cast<const int32_t*>(kpos),
               static_cast<const int32_t*>(kval),
               static_cast<const int4*>(summary),
               Tq, S, H, KVH, causal, window, (S + bk - 1) / bk,
               scale * kLog2e};
  return dispatch<true>(q, k, v, a, B, D, stream);
}

// What the kernel of head dim D takes (dynamic = 0: K3, 1: K4) into
// info[0..8]: {threads, query rows and key slots a tile, ring stages,
// dynamic shared memory bytes, resident blocks per SM, registers and local
// (spill) bytes per thread, the pre-pass's registers}.
extern "C" int dlt_flash_resources(int D, int dynamic, int* info) {
  switch (D) {
    case 64: return dynamic ? resources<64, true>(info)
                            : resources<64, false>(info);
    case 128: return dynamic ? resources<128, true>(info)
                             : resources<128, false>(info);
    case 256: return dynamic ? resources<256, true>(info)
                             : resources<256, false>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
