// Native governance core: multithreaded file hashing + Hamming dedup scans.
//
// The reference's governance tools are single-threaded Python loops over
// files (tool/find_repeated.py walks + hashes one file at a time; the
// perceptual dedup is an O(N^2) interpreted scan). This library provides the
// CPU-side heavy lifting for the framework's governance path:
//
//   - md5_files:        thread-pool MD5 over file CONTENTS (byte-exact dedup
//                       and manifest fingerprints). Self-contained MD5
//                       (RFC 1321) — no OpenSSL dependency.
//   - hamming_first_match: threaded keep-first duplicate scan over packed
//                       uint64 perceptual hashes — for each row i, the first
//                       j < i with ANY of the H hash kinds within the
//                       threshold (mirrors mmrs_tpu.govern.dedup semantics).
//   - hamming_cross_any: for each row of A, the first row of B within the
//                       threshold (leakage checks at tolerance > 0).
//
// Exposed as a plain C ABI for ctypes; built by native/build.sh.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// MD5 (RFC 1321), minimal implementation
// ---------------------------------------------------------------------------

namespace md5impl {

struct Ctx {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_len = 0;
};

static inline uint32_t rotl(uint32_t x, int c) {
  return (x << c) | (x >> (32 - c));
}

static const uint32_t K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                          7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                          5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                          4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                          6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                          6, 10, 15, 21};

static void block(Ctx& ctx, const uint8_t* p) {
  uint32_t m[16];
  memcpy(m, p, 64);
  uint32_t a = ctx.a, b = ctx.b, c = ctx.c, d = ctx.d;
  for (int i = 0; i < 64; i++) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & c) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & c);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + K[i] + m[g], S[i]);
    a = tmp;
  }
  ctx.a += a;
  ctx.b += b;
  ctx.c += c;
  ctx.d += d;
}

static void update(Ctx& ctx, const uint8_t* data, size_t n) {
  ctx.len += n;
  while (n > 0) {
    size_t take = 64 - ctx.buf_len;
    if (take > n) take = n;
    memcpy(ctx.buf + ctx.buf_len, data, take);
    ctx.buf_len += take;
    data += take;
    n -= take;
    if (ctx.buf_len == 64) {
      block(ctx, ctx.buf);
      ctx.buf_len = 0;
    }
  }
}

static void final(Ctx& ctx, uint8_t out[16]) {
  uint64_t bit_len = ctx.len * 8;
  uint8_t pad = 0x80;
  update(ctx, &pad, 1);
  uint8_t zero = 0;
  while (ctx.buf_len != 56) update(ctx, &zero, 1);
  uint8_t lenb[8];
  memcpy(lenb, &bit_len, 8);
  update(ctx, lenb, 8);
  memcpy(out + 0, &ctx.a, 4);
  memcpy(out + 4, &ctx.b, 4);
  memcpy(out + 8, &ctx.c, 4);
  memcpy(out + 12, &ctx.d, 4);
}

}  // namespace md5impl

extern "C" {

// MD5 of a raw buffer (pixel-hash parity with hashlib.md5(img.tobytes())).
void md5_buffer(const uint8_t* data, int64_t n, uint8_t out16[16]) {
  md5impl::Ctx ctx;
  md5impl::update(ctx, data, (size_t)n);
  md5impl::final(ctx, out16);
}

// Thread-pool MD5 over file contents.
//   paths:    n zero-terminated strings, concatenated
//   offsets:  n start offsets into paths
//   out:      n * 16 bytes (zeros on read failure)
//   ok:       n bytes, 1 on success
// Returns number of successfully hashed files.
int64_t md5_files(const char* paths, const int64_t* offsets, int64_t n,
                  uint8_t* out, uint8_t* ok, int threads) {
  std::atomic<int64_t> next(0), done(0);
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 4;
  auto worker = [&]() {
    std::vector<uint8_t> buf(1 << 20);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      ok[i] = 0;
      memset(out + i * 16, 0, 16);
      FILE* f = fopen(paths + offsets[i], "rb");
      if (!f) continue;
      md5impl::Ctx ctx;
      size_t got;
      while ((got = fread(buf.data(), 1, buf.size(), f)) > 0)
        md5impl::update(ctx, buf.data(), got);
      bool failed = ferror(f) != 0;
      fclose(f);
      if (failed) continue;
      md5impl::final(ctx, out + i * 16);
      ok[i] = 1;
      done.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return done.load();
}

// Keep-first duplicate scan over H packed-uint64 hash kinds.
//   hashes: [H][N] uint64 (kind-major)
//   out:    [N] int64 — first j < i with ANY kind's popcount(xor) <= thr,
//           else -1
void hamming_first_match(const uint64_t* hashes, int64_t h, int64_t n,
                         int thr, int64_t* out, int threads) {
  std::atomic<int64_t> next(0);
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 4;
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t hit = -1;
      for (int64_t j = 0; j < i && hit < 0; j++) {
        for (int64_t k = 0; k < h; k++) {
          uint64_t x = hashes[k * n + i] ^ hashes[k * n + j];
          if (__builtin_popcountll(x) <= thr) {
            hit = j;
            break;
          }
        }
      }
      out[i] = hit;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// For each row of A, first row of B with ANY kind within thr (else -1).
void hamming_cross_any(const uint64_t* a, const uint64_t* b, int64_t h,
                       int64_t na, int64_t nb, int thr, int64_t* out,
                       int threads) {
  std::atomic<int64_t> next(0);
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 4;
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= na) return;
      int64_t hit = -1;
      for (int64_t j = 0; j < nb && hit < 0; j++) {
        for (int64_t k = 0; k < h; k++) {
          uint64_t x = a[k * na + i] ^ b[k * nb + j];
          if (__builtin_popcountll(x) <= thr) {
            hit = j;
            break;
          }
        }
      }
      out[i] = hit;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
