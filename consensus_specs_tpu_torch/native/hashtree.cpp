// Batched SHA-256 / Merkle-level engine (host-side fast path).
//
// Role: the native analog of the reference's pycryptodome C sha256
// (SURVEY.md §2.2) for the HOST side of Merkleization — hashing sibling
// pairs level-by-level (the dominant host cost of hash_tree_root) without
// per-call Python/hashlib overhead. The DEVICE path is ops/sha256_jax.py;
// this engine covers control-flow-heavy host hashing (SSZ trees, deposit
// trees, proof folding) where kernel launches don't pay.
//
// Self-contained SHA-256 (FIPS 180-4), no external deps. Exposed C ABI:
//   hashtree_sha256(in, len, out32)                 one-shot digest
//   hashtree_hash_pairs(in, n, out)                 n x 64B -> n x 32B
//   hashtree_merkle_root(leaves, n, depth, out32)   padded-tree root via
//                                                   zero-hash ladder
// All loops are cache-friendly sequential passes; hash_pairs is the API the
// Python binding batches whole tree levels through.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#define HASHTREE_X86 1
#include <immintrin.h>
#include <cpuid.h>
#endif

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
inline uint32_t load_be(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
inline void store_be(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16); p[2] = uint8_t(v >> 8); p[3] = uint8_t(v);
}

void compress(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++) w[i] = load_be(block + 4 * i);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + s1 + ch + K[i] + w[i];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

#ifdef HASHTREE_X86
// SHA-NI single-block compression (the Intel SHA extensions flow; same
// instruction sequence every hardware sha256 implementation uses). The
// 64-byte Merkle-pair digest is two of these: data block + fixed padding.
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani(uint32_t state[8], const uint8_t block[64]) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i STATE0, STATE1, MSG, TMP, MSG0, MSG1, MSG2, MSG3;

  TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[0]));
  STATE1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);        // CDAB
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);  // EFGH
  STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);  // ABEF
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);  // CDGH

  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;

#define QROUND(Ka, Kb, MA)                                   \
  MSG = _mm_add_epi32(MA, _mm_set_epi64x(Kb, Ka));           \
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);       \
  MSG = _mm_shuffle_epi32(MSG, 0x0E);                        \
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG)

  // rounds 0-15: raw message words
  MSG0 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 0)), MASK);
  QROUND(0x71374491428A2F98LL, 0xE9B5DBA5B5C0FBCFLL, MSG0);
  MSG1 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 16)), MASK);
  QROUND(0x59F111F13956C25BLL, 0xAB1C5ED5923F82A4LL, MSG1);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);
  MSG2 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 32)), MASK);
  QROUND(0x12835B01D807AA98LL, 0x550C7DC3243185BELL, MSG2);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);
  MSG3 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 48)), MASK);

  // rounds 12-51: full schedule pipeline, registers rotating
#define SCHED_QROUND(Ka, Kb, MA, MB, MC, MD)                 \
  MSG = _mm_add_epi32(MA, _mm_set_epi64x(Kb, Ka));           \
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);       \
  TMP = _mm_alignr_epi8(MA, MD, 4);                          \
  MB = _mm_add_epi32(MB, TMP);                               \
  MB = _mm_sha256msg2_epu32(MB, MA);                         \
  MSG = _mm_shuffle_epi32(MSG, 0x0E);                        \
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);       \
  MD = _mm_sha256msg1_epu32(MD, MA)

  SCHED_QROUND(0x80DEB1FE72BE5D74LL, 0xC19BF1749BDC06A7LL, MSG3, MSG0, MSG1, MSG2);
  SCHED_QROUND(0xEFBE4786E49B69C1LL, 0x240CA1CC0FC19DC6LL, MSG0, MSG1, MSG2, MSG3);
  SCHED_QROUND(0x4A7484AA2DE92C6FLL, 0x76F988DA5CB0A9DCLL, MSG1, MSG2, MSG3, MSG0);
  SCHED_QROUND(0xA831C66D983E5152LL, 0xBF597FC7B00327C8LL, MSG2, MSG3, MSG0, MSG1);
  SCHED_QROUND(0xD5A79147C6E00BF3LL, 0x1429296706CA6351LL, MSG3, MSG0, MSG1, MSG2);
  SCHED_QROUND(0x2E1B213827B70A85LL, 0x53380D134D2C6DFCLL, MSG0, MSG1, MSG2, MSG3);
  SCHED_QROUND(0x766A0ABB650A7354LL, 0x92722C8581C2C92ELL, MSG1, MSG2, MSG3, MSG0);
  SCHED_QROUND(0xA81A664BA2BFE8A1LL, 0xC76C51A3C24B8B70LL, MSG2, MSG3, MSG0, MSG1);
  SCHED_QROUND(0xD6990624D192E819LL, 0x106AA070F40E3585LL, MSG3, MSG0, MSG1, MSG2);

  // rounds 48-51: last group that still primes a register (MSG3 feeds the
  // 60-63 words); afterwards only msg2 chains remain
  MSG = _mm_add_epi32(MSG0, _mm_set_epi64x(0x34B0BCB52748774CLL, 0x1E376C0819A4C116LL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  MSG = _mm_add_epi32(MSG1, _mm_set_epi64x(0x682E6FF35B9CCA4FLL, 0x4ED8AA4A391C0CB3LL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  // rounds 60-63
  MSG = _mm_add_epi32(MSG2, _mm_set_epi64x(0x8CC7020884C87814LL, 0x78A5636F748F82EELL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  MSG = _mm_add_epi32(MSG3, _mm_set_epi64x(0xC67178F2BEF9A3F7LL, 0xA4506CEB90BEFFFALL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

#undef QROUND
#undef SCHED_QROUND

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
  TMP = _mm_shuffle_epi32(STATE0, 0x1B);        // FEBA
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);     // DCHG
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);  // DCBA
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);     // HGFE
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), STATE0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), STATE1);
}

bool have_shani() {
  // __builtin_cpu_supports has no "sha" feature name on older GCC; read
  // CPUID leaf 7 (EBX bit 29 = SHA extensions) directly.
  static const bool v = [] {
    unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    const bool sha = (ebx >> 29) & 1u;
    return sha && __builtin_cpu_supports("sse4.1");
  }();
  return v;
}
#endif  // HASHTREE_X86

inline void compress_dispatch(uint32_t state[8], const uint8_t block[64]) {
#ifdef HASHTREE_X86
  if (have_shani()) { compress_shani(state, block); return; }
#endif
  compress(state, block);
}

// Digest of exactly one 64-byte input (the Merkle pair case): one data
// block plus one constant padding block (0x80, zeros, bit-length 512).
void sha256_64(const uint8_t in[64], uint8_t out[32]) {
  uint32_t st[8];
  std::memcpy(st, H0, sizeof st);
  compress_dispatch(st, in);
  uint8_t pad[64] = {0};
  pad[0] = 0x80;
  pad[62] = 0x02;  // 512 bits, big-endian in the last 8 bytes
  compress_dispatch(st, pad);
  for (int i = 0; i < 8; i++) store_be(out + 4 * i, st[i]);
}

void sha256_any(const uint8_t* in, size_t len, uint8_t* out) {
  uint32_t st[8];
  std::memcpy(st, H0, sizeof st);
  size_t off = 0;
  for (; off + 64 <= len; off += 64) compress_dispatch(st, in + off);
  uint8_t tail[128] = {0};
  size_t rem = len - off;
  std::memcpy(tail, in + off, rem);
  tail[rem] = 0x80;
  size_t tail_blocks = (rem + 1 + 8 <= 64) ? 1 : 2;
  uint64_t bits = uint64_t(len) * 8;
  uint8_t* lenp = tail + tail_blocks * 64 - 8;
  for (int i = 0; i < 8; i++) lenp[i] = uint8_t(bits >> (56 - 8 * i));
  compress_dispatch(st, tail);
  if (tail_blocks == 2) compress_dispatch(st, tail + 64);
  for (int i = 0; i < 8; i++) store_be(out + 4 * i, st[i]);
}

}  // namespace

extern "C" {

void hashtree_sha256(const uint8_t* in, size_t len, uint8_t* out32) {
  sha256_any(in, len, out32);
}

// n sibling pairs (n * 64 bytes contiguous) -> n parents (n * 32 bytes).
// Large batches fan out over hardware threads; the in-place aliased call
// (merkle_root's in==out reduction) must stay sequential because parent
// writes at 32*i overlap later pair reads at 64*j across thread boundaries.
void hashtree_hash_pairs(const uint8_t* in, size_t n, uint8_t* out) {
  const size_t kParThreshold = 8192;
  unsigned hw = std::thread::hardware_concurrency();
  if (n < kParThreshold || hw < 2 || in == out) {
    for (size_t i = 0; i < n; i++) sha256_64(in + 64 * i, out + 32 * i);
    return;
  }
  unsigned nt = hw > 16 ? 16 : hw;
  size_t per = (n + nt - 1) / nt;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nt; t++) {
    size_t b = t * per, e = b + per < n ? b + per : n;
    if (b >= e) break;
    ts.emplace_back([in, out, b, e]() {
      for (size_t i = b; i < e; i++) sha256_64(in + 64 * i, out + 32 * i);
    });
  }
  for (auto& th : ts) th.join();
}

// Build every parent level of the chunk tree bottom-up into `out`
// contiguously: level 1 (ceil(n/2) nodes), level 2, ... single final node.
// Odd levels pad with the zero-hash of their height — the same virtual
// padding rule IncrementalTree applies. Returns nodes written (0 if n < 2).
long hashtree_build_tree(const uint8_t* leaves, size_t n, uint8_t* out) {
  if (n < 2) return 0;
  uint8_t zero[64][32];
  std::memset(zero[0], 0, 32);
  for (size_t h = 0; h + 1 < 64; h++) {
    uint8_t pair[64];
    std::memcpy(pair, zero[h], 32);
    std::memcpy(pair + 32, zero[h], 32);
    sha256_64(pair, zero[h + 1]);
  }
  const uint8_t* cur = leaves;
  uint8_t* w = out;
  size_t count = n, h = 0;
  while (count > 1) {
    size_t pairs = count / 2;
    size_t parents = (count + 1) / 2;
    hashtree_hash_pairs(cur, pairs, w);
    if (count & 1) {
      uint8_t block[64];
      std::memcpy(block, cur + (count - 1) * 32, 32);
      std::memcpy(block + 32, zero[h], 32);
      sha256_64(block, w + pairs * 32);
    }
    cur = w;
    w += parents * 32;
    count = parents;
    h++;
  }
  return (long)((w - out) / 32);
}

// Root of the binary tree over `n` 32-byte leaves padded with zero-subtrees
// to 2^depth leaves. Scratch is a running level buffer (caller-independent).
long hashtree_merkle_root(const uint8_t* leaves, size_t n, size_t depth, uint8_t* out32) {
  if (n > (depth >= 48 ? ~size_t(0) : (size_t(1) << depth))) return -1;
  // zero-hash ladder
  uint8_t zero[64][32];
  std::memset(zero[0], 0, 32);
  for (size_t h = 0; h + 1 <= depth && h < 63; h++) {
    uint8_t pair[64];
    std::memcpy(pair, zero[h], 32);
    std::memcpy(pair + 32, zero[h], 32);
    sha256_64(pair, zero[h + 1]);
  }
  if (n == 0) {
    std::memcpy(out32, zero[depth], 32);
    return 0;
  }
  // level-by-level reduction in place
  uint8_t* buf = new uint8_t[((n + 1) / 2 * 2) * 32];
  std::memcpy(buf, leaves, n * 32);
  size_t count = n;
  for (size_t h = 0; h < depth; h++) {
    if (count & 1) {
      std::memcpy(buf + count * 32, zero[h], 32);
      count++;
    }
    hashtree_hash_pairs(buf, count / 2, buf);
    count /= 2;
  }
  std::memcpy(out32, buf, 32);
  delete[] buf;
  return 0;
}

}  // extern "C"
