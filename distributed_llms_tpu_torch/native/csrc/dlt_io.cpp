// Native IO for the shard store (distributed_llms_tpu_torch/checkpoint/store.py).
//
// The checkpoint path of a serving framework is IO-bound at cold start:
// loading an 8B bf16 model is ~16 GB of disk reads.  This library does
// the store reads the way a C++ runtime would:
//   - pread() of each segment in chunks of at most 64 MB fanned out over a
//     thread pool (no GIL, no Python object churn, page-cache friendly; a
//     multi-GB array spreads over the threads too);
//   - CRC32 (zlib polynomial, slice-by-8) computed in the same pass, chunk
//     by chunk and combined per segment, for integrity checking —
//     corruption surfaces as a checksum mismatch at load time, not NaNs
//     at step 40k.
//
// Exposed as a plain C ABI consumed via ctypes: the build is a single
// `g++ -shared`, no PyTorch headers.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

uint32_t crc_table[8][256];

void init_crc_tables() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      crc_table[s][i] =
          crc_table[0][crc_table[s - 1][i] & 0xFF] ^ (crc_table[s - 1][i] >> 8);
}

struct CrcInit {
  CrcInit() { init_crc_tables(); }
} crc_init;

uint32_t crc32_update(uint32_t crc, const uint8_t* p, uint64_t len) {
  crc = ~crc;
  // slice-by-8
  while (len >= 8) {
    uint32_t lo;
    uint32_t hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^
          crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24] ^
          crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
          crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    p += 8;
    len -= 8;
  }
  while (len--) crc = crc_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// CRC32 of A||B from crc(A), crc(B) and len(B): zlib's crc32_combine
// (GF(2) matrix powers of the CRC's shift operator).
uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  for (int i = 0; vec; i++, vec >>= 1)
    if (vec & 1) sum ^= mat[i];
  return sum;
}

void gf2_square(uint32_t* square, const uint32_t* mat) {
  for (int n = 0; n < 32; n++) square[n] = gf2_times(mat, mat[n]);
}

uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  if (len2 == 0) return crc1;
  uint32_t even[32], odd[32];
  odd[0] = 0xEDB88320u;  // the operator of one zero bit
  uint32_t row = 1;
  for (int n = 1; n < 32; n++, row <<= 1) odd[n] = row;
  gf2_square(even, odd);  // two zero bits
  gf2_square(odd, even);  // four
  do {  // apply len2 zero bytes to crc1
    gf2_square(even, odd);
    if (len2 & 1) crc1 = gf2_times(even, crc1);
    len2 >>= 1;
    if (!len2) break;
    gf2_square(odd, even);
    if (len2 & 1) crc1 = gf2_times(odd, crc1);
    len2 >>= 1;
  } while (len2);
  return crc1 ^ crc2;
}

// Segments are read in chunks of at most this many bytes, so that one
// large array (a stacked layer leaf of several GB) spreads over the
// threads too; each chunk's CRC is combined into its segment's.
constexpr uint64_t kChunk = 64ull << 20;

struct Chunk {
  int64_t seg;
  uint64_t off;  // within the segment
  uint64_t len;
};

}  // namespace

extern "C" {

uint32_t dlt_crc32(const uint8_t* data, uint64_t len, uint32_t seed) {
  return crc32_update(seed, data, len);
}

// Read `count` segments — paths[i] at byte offsets[i], nbytes[i] bytes —
// into caller-owned bufs[i], optionally writing CRC32s to crcs_out.
// Returns 0 on success, or (1 + i) for the first segment that failed.
int64_t dlt_read_segments(const char** paths, const uint64_t* offsets,
                          const uint64_t* nbytes, uint8_t** bufs,
                          uint32_t* crcs_out, int64_t count, int threads) {
  if (count <= 0) return 0;
  std::vector<Chunk> chunks;
  for (int64_t i = 0; i < count; i++) {
    uint64_t off = 0;
    do {
      uint64_t len = std::min(kChunk, nbytes[i] - off);
      chunks.push_back({i, off, len});
      off += len;
    } while (off < nbytes[i]);
  }
  const int64_t n = static_cast<int64_t>(chunks.size());
  if (threads < 1) threads = 1;
  if (threads > n) threads = static_cast<int>(n);
  std::vector<uint32_t> chunk_crc(n, 0);

  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(0);  // 0 = ok, else 1-based segment index

  auto worker = [&]() {
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= n || failed.load(std::memory_order_relaxed)) break;
      const Chunk& ch = chunks[c];
      int fd = open(paths[ch.seg], O_RDONLY);
      if (fd < 0) {
        failed.store(ch.seg + 1);
        break;
      }
      uint8_t* dst = bufs[ch.seg] + ch.off;
      uint64_t done = 0;
      bool ok = true;
      while (done < ch.len) {
        ssize_t r = pread(fd, dst + done, ch.len - done,
                          static_cast<off_t>(offsets[ch.seg] + ch.off + done));
        if (r <= 0) {
          ok = false;
          break;
        }
        done += static_cast<uint64_t>(r);
      }
      close(fd);
      if (!ok) {
        failed.store(ch.seg + 1);
        break;
      }
      if (crcs_out) chunk_crc[c] = crc32_update(0, dst, ch.len);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (failed.load() || !crcs_out) return failed.load();
  // Chunks were listed segment by segment, in order.
  for (int64_t c = 0; c < n; c++) {
    const Chunk& ch = chunks[c];
    crcs_out[ch.seg] = ch.off == 0
        ? chunk_crc[c]
        : crc32_combine(crcs_out[ch.seg], chunk_crc[c], ch.len);
  }
  return 0;
}

}  // extern "C"
