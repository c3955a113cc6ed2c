// Split-K ("flash-decoding") body of the port's decode-attention kernels:
// one query token per row, grouped-query attention, a row's slots cut into
// SPLITS that separate blocks attend in parallel, each leaving a partial
// softmax state that a second kernel merges.  ragged_decode_attn.cu (K2,
// K2q) walks a contiguous row's band with it (ContiguousSlots);
// paged_decode_attn.cu (K1, K1q) walks a run of whole pages of the pool
// through the split's page ids (PagedSlots).  The addressing policy maps
// a split slot to its K/V rows and scales; everything else is shared.
//
// Why splits: decode attention moves bytes (every K/V element of the band
// is read once and serves the G = H / KVH query heads of its group, ~4
// operations per byte at G = 4, far below the ~295 at which the H100's
// bf16 tensor cores become the limit).  One block per (KV head, row)
// fills 64 of 132 SMs at batch 8 and 8 at batch 1 and walks the band
// serially; splitting the band gives the card enough blocks, and a block
// keeps bytes in flight so its SM's share of the 3.35 TB/s is used:
//
// - loads are 16 bytes a thread (8 bf16 or 16 int8 elements; int8 rows
//   whose D is not a multiple of 16 take 8 bytes), neighbouring threads on
//   neighbouring addresses, issued with cp.async into a ring of kStages
//   shared-memory tiles — double-buffered: the next 16 KB tile in flight
//   while one is reduced, one block barrier per tile, one pipeline over
//   the whole split (a paged tile may straddle pages: each of its rows
//   resolves its own page).  At D = 128, 6 K2 blocks fit an SM (96
//   KB in flight, ~4x what 3.35 TB/s at ~1 us needs; K2q: 4, bounded by
//   registers): the block is bound by its instruction issue, not by bytes
//   in flight (PERF.md);
// - the int8 leg's per-(slot, head) scales ride in the same tile, one
//   4-byte copy per slot issued by different threads, not a dependent load
//   per slot in the walk;
// - the block is (bdx, G, bdz) threads: bdx lanes split a row's D into
//   16-byte chunks, the G query heads of the group each own a lane group
//   (so one K/V chunk in shared memory serves all G heads), and bdz slot
//   groups take alternate runs of kSub slots of a tile, each with its own
//   running max / sum in registers (no shared memory, no barrier in the
//   softmax), merged at the end of the block.
//
// Numerics are the TPU kernel's (distributed_llms_tpu/ops/decode_attn.py
// `_kernel`): scores q . k in float32 times D^-0.5 (times k_scale in the
// int8 leg), a running max / running sum in float32, the sum adding p
// BEFORE the int8 leg's v_scale, the value product reading bf16(p *
// v_scale) (bf16(p) for bf16) and accumulating in float32, and a split or
// row with no live slot giving zeros, never NaN (an empty split writes
// its empty state and leaves before loading anything; the merge divides
// by max(l, 1e-37)).
// One rounding point differs, as it already differed by tile size between
// the TPU kernel's block (chosen by its wrapper) and any other: p is
// rounded to bf16 relative to the running max of its slot group's slots
// so far (a kSub-slot update), not of the whole row.  The merge rescales
// each partial by exp(m_s - M) in float32.

#pragma once

#include "decode_attn_common.cuh"

namespace dlt_split {

constexpr int kSub = 8;              // slots per online-softmax update
constexpr int kStages = 2;           // shared-memory tiles per block
constexpr int kStageKVBytes = 16384; // K + V bytes of one tile
constexpr int kMaxTile = 64;         // slots per tile at most
constexpr int kTargetThreads = 128;
constexpr int kMaxThreads = 512;     // bdx 32 x G 16 x bdz 1
constexpr int kMergeMaxThreads = 256;  // merge: a thread per element of D

// A block's shape for head dim D, group size G and kVec elements of KV
// per load; host and device compute it alike.
struct Geometry {
  int nch;      // 16-byte (8-byte) chunks of a row: D / kVec
  int bdx;      // lanes per row: nch rounded up to a power of two
  int bdz;      // slot groups, dividing the tile's kSub-slot runs
  int threads;  // bdx * G * bdz
  int tile;     // slots per shared-memory tile (a multiple of kSub)
  int stage_bytes;
  int smem;     // dynamic shared memory: the ring, or the block's merge
};

template <typename KV, bool kQuant, int kVec>
__host__ __device__ inline Geometry geometry(int D, int G) {
  Geometry g;
  g.nch = D / kVec;
  g.bdx = 1;
  while (g.bdx < g.nch) g.bdx <<= 1;
  const int row_bytes = D * (int)sizeof(KV);
  const int tile = kStageKVBytes / (2 * row_bytes) / kSub * kSub;
  g.tile = tile < kSub ? kSub : (tile > kMaxTile ? kMaxTile : tile);
  const int runs = g.tile / kSub;
  int bdz = kTargetThreads / (g.bdx * G);
  bdz = bdz < 1 ? 1 : (bdz > runs ? runs : bdz);
  while (runs % bdz) --bdz;  // every slot group walks as many runs
  g.bdz = bdz;
  g.threads = g.bdx * G * bdz;
  g.stage_bytes = 2 * g.tile * row_bytes +
                  (kQuant ? 2 * g.tile * (int)sizeof(float) : 0);
  const int ring = kStages * g.stage_bytes;
  const int merge = bdz * G * (D + 2) * (int)sizeof(float);
  g.smem = ring > merge ? ring : merge;
  return g;
}

// -- loads ------------------------------------------------------------------

// Asynchronous global -> shared copy of kBytes (16, 8 or 4); a copy that
// is not `valid` reads nothing and fills the destination with zeros.
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

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void bf16x2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// 8 bf16 at a 16-byte aligned address, widened exactly.
__device__ __forceinline__ void bf16x8(const __nv_bfloat16* p, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  bf16x2(w.x, x);
  bf16x2(w.y, x + 2);
  bf16x2(w.z, x + 4);
  bf16x2(w.w, x + 6);
}

__device__ __forceinline__ void i8x4(unsigned w, float* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = (float)((int)(w << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  bf16x8(p, x);
}

__device__ __forceinline__ void load_chunk(const int8_t* p, float (&x)[16]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  i8x4(w.x, x);
  i8x4(w.y, x + 4);
  i8x4(w.z, x + 8);
  i8x4(w.w, x + 12);
}

__device__ __forceinline__ void load_chunk(const int8_t* p, float (&x)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  i8x4(w.x, x);
  i8x4(w.y, x + 4);
}

// -- addressing: split slot t -> its K/V row and its scales ------------------

// A run of slots contiguous in memory (a contiguous row's band): slot t's
// K/V row at t * slot_stride elements, its scales at t * scale_stride.
struct ContiguousSlots {
  size_t slot_stride;
  size_t scale_stride;
  __device__ __forceinline__ size_t kv_offset(int t) const {
    return (size_t)t * slot_stride;
  }
  __device__ __forceinline__ size_t scale_offset(int t) const {
    return (size_t)t * scale_stride;
  }
};

// A run of whole pages of a [NB, BLK, KVH, ...] pool: slot t lies in page
// pages[t / blk] (the split's page ids, in shared memory), at row t % blk
// of it.  Offsets are from the KV head's first element of pool page 0.
struct PagedSlots {
  const int* pages;
  int blk;
  size_t page_stride;        // BLK * KVH * D elements
  size_t slot_stride;        // KVH * D
  size_t scale_page_stride;  // BLK * KVH
  size_t scale_slot_stride;  // KVH
  __device__ __forceinline__ size_t kv_offset(int t) const {
    const int i = t / blk;
    return (size_t)pages[i] * page_stride + (size_t)(t - i * blk) * slot_stride;
  }
  __device__ __forceinline__ size_t scale_offset(int t) const {
    const int i = t / blk;
    return (size_t)pages[i] * scale_page_stride +
           (size_t)(t - i * blk) * scale_slot_stride;
  }
};

// -- the split body ---------------------------------------------------------

// Attend n_slots slots for one (row, KV head): slot t's K row is
// kp[slots.kv_offset(t) .. + D) (likewise vp), its int8 scales
// ksp[slots.scale_offset(t)] and vsp[...].  Only slots t < n_slots are
// addressed.  q_group is the group's [G, D] bf16 queries.  With out_group
// set the block writes the normalized output ([G, D] bf16: the span is the
// row's whole band); otherwise its partial state: acc_part [G, D]
// (unnormalized), m_part and l_part [G].  An empty span (n_slots <= 0)
// writes zeros / m = -inf, l = 0, acc = 0.  Every thread of the block must
// call it.
template <typename KV, bool kQuant, int kVec, typename Slots>
__device__ __forceinline__ void attend_split(
    const __nv_bfloat16* __restrict__ q_group, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ksp,
    const float* __restrict__ vsp, int n_slots, const Slots slots, int G,
    int D, float scale, __nv_bfloat16* __restrict__ out_group,
    float* __restrict__ acc_part, float* __restrict__ m_part,
    float* __restrict__ l_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunkBytes = kVec * (int)sizeof(KV);
  const Geometry geo = geometry<KV, kQuant, kVec>(D, G);
  const int tid = threadIdx.x;
  const int tx = tid % geo.bdx;
  const int ty = (tid / geo.bdx) % G;
  const int tz = tid / (geo.bdx * G);
  const bool lane_live = tx < geo.nch;  // lanes past D (D = 72: 9 of 16)
  const int e0 = tx * kVec;
  // Shuffles stay inside a bdx-lane group; the last warp may be partial.
  const int warp_base = tid & ~31;
  const int in_warp = min(32, geo.threads - warp_base);
  const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;

  if (n_slots <= 0) {  // uniform over the block: write the empty state, leave
    if (tz == 0 && lane_live) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        if (out_group != nullptr) {
          *reinterpret_cast<uint2*>(out_group + ty * D + e0 + e) =
              make_uint2(0u, 0u);
        } else {
          *reinterpret_cast<float4*>(acc_part + ty * D + e0 + e) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    if (tz == 0 && tx == 0 && out_group == nullptr) {
      m_part[ty] = -INFINITY;
      l_part[ty] = 0.f;
    }
    return;
  }

  float qv[kVec], o[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] = o[e] = 0.f;
  if (lane_live) {
#pragma unroll
    for (int c = 0; c < kVec; c += 8) bf16x8(q_group + ty * D + e0 + c, qv + c);
  }
  float m = -INFINITY, l = 0.f;

  const int n_tiles = n_slots > 0 ? (n_slots + geo.tile - 1) / geo.tile : 0;
  const int rows_per_pass = geo.threads / geo.bdx;

  auto load_tile = [&](int it) {
    unsigned char* st = smem + (size_t)(it % kStages) * geo.stage_bytes;
    KV* k_s = reinterpret_cast<KV*>(st);
    KV* v_s = k_s + geo.tile * D;
    const int base = it * geo.tile;
    if (lane_live) {
      for (int r = tid / geo.bdx; r < geo.tile; r += rows_per_pass) {
        const bool valid = base + r < n_slots;
        const size_t src = valid ? slots.kv_offset(base + r) + e0 : 0;
        cp_async<kChunkBytes>(k_s + r * D + e0, kp + src, valid);
        cp_async<kChunkBytes>(v_s + r * D + e0, vp + src, valid);
      }
    }
    if (kQuant) {
      float* ks_s = reinterpret_cast<float*>(v_s + geo.tile * D);
      for (int i = tid; i < 2 * geo.tile; i += geo.threads) {
        const int r = i < geo.tile ? i : i - geo.tile;
        const bool valid = base + r < n_slots;
        const size_t src = valid ? slots.scale_offset(base + r) : 0;
        cp_async<4>(ks_s + i, (i < geo.tile ? ksp : vsp) + src, valid);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    // Tile `it` has landed for every thread, and every thread is done
    // with tile it - 1, whose buffer the next copy overwrites.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (size_t)(it % kStages) * geo.stage_bytes;
    const KV* k_s = reinterpret_cast<const KV*>(st);
    const KV* v_s = k_s + geo.tile * D;
    const float* ks_s = reinterpret_cast<const float*>(v_s + geo.tile * D);
    const float* vs_s = ks_s + geo.tile;
    const int base = it * geo.tile;
    for (int j = tz; j < geo.tile / kSub; j += geo.bdz) {
      const int r0 = j * kSub;
      float s[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        float dot = 0.f;
        if (lane_live) {
          float kv[kVec];
          load_chunk(k_s + (r0 + t) * D + e0, kv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot += qv[e] * kv[e];
        }
        s[t] = dot;
      }
      for (int off = geo.bdx >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int t = 0; t < kSub; ++t)
          s[t] += __shfl_xor_sync(mask, s[t], off);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        float sc = s[t] * scale;
        if (kQuant) sc *= ks_s[r0 + t];
        s[t] = base + r0 + t < n_slots ? sc : -INFINITY;
        mx = fmaxf(mx, s[t]);
      }
      const float m_new = fmaxf(m, mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - safe);
      float sum = 0.f;
      float pb[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        float p = expf(s[t] - safe);
        sum += p;
        if (kQuant) p *= vs_s[r0 + t];
        pb[t] = __bfloat162float(__float2bfloat16(p));
      }
      l = l * alpha + sum;
      m = m_new;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] *= alpha;
      if (lane_live) {
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          float vv[kVec];
          load_chunk(v_s + (r0 + t) * D + e0, vv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) o[e] += pb[t] * vv[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the slot groups' merge

  if (geo.bdz > 1) {
    float* red_o = reinterpret_cast<float*>(smem);  // [bdz, G, D]
    float* red_m = red_o + geo.bdz * G * D;          // [bdz, G]
    float* red_l = red_m + geo.bdz * G;
    if (lane_live) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) red_o[(tz * G + ty) * D + e0 + e] = o[e];
    }
    if (tx == 0) {
      red_m[tz * G + ty] = m;
      red_l[tz * G + ty] = l;
    }
    __syncthreads();
    if (tz == 0) {
      float mm = -INFINITY;
      for (int z = 0; z < geo.bdz; ++z) mm = fmaxf(mm, red_m[z * G + ty]);
      const float safe = mm == -INFINITY ? 0.f : mm;
      l = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = 0.f;
      for (int z = 0; z < geo.bdz; ++z) {
        const float w = expf(red_m[z * G + ty] - safe);
        l += w * red_l[z * G + ty];
        if (lane_live) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            o[e] += w * red_o[(z * G + ty) * D + e0 + e];
        }
      }
      m = mm;
    }
  }
  if (tz != 0) return;
  if (out_group != nullptr) {
    if (lane_live) {
      const float inv = 1.f / fmaxf(l, 1e-37f);
#pragma unroll
      for (int e = 0; e < kVec; e += 2)
        *reinterpret_cast<__nv_bfloat162*>(out_group + ty * D + e0 + e) =
            __floats2bfloat162_rn(o[e] * inv, o[e + 1] * inv);
    }
    return;
  }
  if (lane_live) {
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(acc_part + ty * D + e0 + e) =
          make_float4(o[e], o[e + 1], o[e + 2], o[e + 3]);
  }
  if (tx == 0) {
    m_part[ty] = m;
    l_part[ty] = l;
  }
}

// The merge: block (g, KV head, row) combines query head g's n_splits
// partials ([B, KVH, n_splits, G, D] acc, [B, KVH, n_splits, G] m and l)
// into its row of out [B, 1, H, D] bf16: sum_s w_s acc_s / max(sum_s w_s
// l_s, 1e-37) with w_s = exp(m_s - M), M = max_s m_s; a row with no live
// slot (M = -inf) outputs zeros.  The first warp computes the weights once
// into shared memory (n_splits + 1 floats: merge_smem()); then thread d
// sums its element over the splits, loads independent across splits.
__host__ __device__ inline int merge_threads(int D) { return (D + 31) / 32 * 32; }
__host__ __device__ inline int merge_smem(int n_splits) {
  return (n_splits + 1) * (int)sizeof(float);
}

__global__ void __launch_bounds__(kMergeMaxThreads)
split_decode_merge_kernel(const float* __restrict__ acc,
                          const float* __restrict__ pm,
                          const float* __restrict__ pl,
                          __nv_bfloat16* __restrict__ out, int H, int KVH,
                          int D, int n_splits) {
  extern __shared__ float w_s[];  // [n_splits] weights, then the sum of l
  const int g = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const size_t part = ((size_t)b * KVH + kvh) * n_splits;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mm = -INFINITY;
    for (int s = lane; s < n_splits; s += 32)
      mm = fmaxf(mm, pm[(part + s) * G + g]);
    mm = dlt_decode::warp_max(mm);
    float den = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float w =
          mm == -INFINITY ? 0.f : expf(pm[(part + s) * G + g] - mm);
      w_s[s] = w;
      den += w * pl[(part + s) * G + g];
    }
    den = dlt_decode::warp_sum(den);
    if (lane == 0) w_s[n_splits] = den;
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= D) return;
  const float* a = acc + (part * G + g) * D + d;
  const size_t stride = (size_t)G * D;
  float num = 0.f;
#pragma unroll 16
  for (int s = 0; s < n_splits; ++s) num += w_s[s] * a[s * stride];
  out[((size_t)b * H + (size_t)kvh * G + g) * D + d] =
      __float2bfloat16(num / fmaxf(w_s[n_splits], 1e-37f));
}

}  // namespace dlt_split
