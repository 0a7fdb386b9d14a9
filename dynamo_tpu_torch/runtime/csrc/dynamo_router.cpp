// Native router core: weighted rendezvous (HRW) pick over worker candidates.
//
// The reference's router lives in the consumed Dynamo runtime's native (Rust)
// frontend (SURVEY.md §2b "OpenAI-compatible frontend + router"); this is the
// port's own copy of dynamo_tpu/runtime/csrc/dynamo_router.cpp, the same hot
// path in C++. The Python router (dynamo_tpu_torch/serving/router.py) computes, per request, one SHA-256 over
// (affinity_key | url) per candidate and takes the max weighted draw; this
// library does the whole loop in one call. Scores are BIT-IDENTICAL to the
// Python implementation (same hash, same big-endian u64 -> double division,
// same 0.25 + 0.75*headroom weighting), so native and fallback paths make
// identical routing decisions — asserted by tests/test_router_native.py and
// tests/test_torch_router_parity.py for this copy.
//
// Plain C ABI (ctypes-loaded; pybind11 is not in the image).

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------- sha256 --
// Compact SHA-256 (FIPS 180-4). Message sizes here are tiny (affinity key +
// URL, < a few KB), so a straightforward single-shot implementation is
// plenty; no streaming interface needed.

struct Sha256 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t len = 0;
  size_t fill = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  void block(const uint8_t* p) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + k[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    len += n;
    while (n > 0) {
      size_t take = 64 - fill < n ? 64 - fill : n;
      std::memcpy(buf + fill, p, take);
      fill += take; p += take; n -= take;
      if (fill == 64) { block(buf); fill = 0; }
    }
  }

  // first 8 digest bytes as a big-endian u64 (== h[0]<<32 | h[1])
  uint64_t final_u64() {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenb, 8);
    return (uint64_t(h[0]) << 32) | uint64_t(h[1]);
  }
};

}  // namespace

extern "C" {

// Weighted-rendezvous pick: returns the index of the winning candidate, or
// -1 when n <= 0. urls[i] are NUL-terminated; headroom[i] in [0, 1].
// Mirrors Router.pick's scoring exactly:
//   score_i = sha256(key + "|" + url_i)[:8] as big-endian u64 / 2^64
//             * (0.25 + 0.75 * headroom_i)
int dr_pick(const char* key, const char* const* urls, const double* headroom,
            int n) {
  if (n <= 0 || key == nullptr) return -1;
  const size_t keylen = std::strlen(key);
  int best = -1;
  double best_score = -1.0;
  for (int i = 0; i < n; i++) {
    Sha256 s;
    s.update(reinterpret_cast<const uint8_t*>(key), keylen);
    s.update(reinterpret_cast<const uint8_t*>("|"), 1);
    s.update(reinterpret_cast<const uint8_t*>(urls[i]),
             std::strlen(urls[i]));
    // u64 -> double rounds to nearest (same as Python int/int division);
    // division by 2^64 is exact
    double hash_score = double(s.final_u64()) / 18446744073709551616.0;
    double score = hash_score * (0.25 + 0.75 * headroom[i]);
    if (score > best_score) { best_score = score; best = i; }
  }
  return best;
}

// Self-test hook: big-endian u64 of sha256(msg)[:8], for hash parity checks.
uint64_t dr_hash64(const char* msg) {
  Sha256 s;
  s.update(reinterpret_cast<const uint8_t*>(msg), std::strlen(msg));
  return s.final_u64();
}

}  // extern "C"
