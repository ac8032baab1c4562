// sha256 of one 64-byte message per thread, as device functions shared by
// the K1 (sha256.cu) and K2 (state_root.cu) kernels.
//
// Replaces the TPU program's `_compress` (consensus_specs_tpu/ops/sha256_jax.py:28),
// which materialises the message schedule as a (..., 64) array: here the
// schedule lives in a 16-word ring in registers, every round index is a
// compile-time constant after full unrolling, and the second compression
// (over the constant padding block of a 64-byte message) reads K[t] + W[t]
// precomputed in constant memory, so it needs no schedule at all.
#pragma once
#include <stdint.h>

__constant__ uint32_t SHA_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// K[t] + W[t] of the padding block {0x80000000, 0, ..., 0, 512}.
__constant__ uint32_t SHA_KPAD64[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

__device__ __forceinline__ uint32_t sha_rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void sha_round(uint32_t& a, uint32_t& b, uint32_t& c,
                                          uint32_t& d, uint32_t& e, uint32_t& f,
                                          uint32_t& g, uint32_t& h, uint32_t kw) {
    uint32_t s1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + s1 + ch + kw;
    uint32_t s0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + s0 + maj;
}

// st <- compress(st, w); w (16 words) is used as the schedule ring and
// overwritten.
__device__ __forceinline__ void sha_compress(uint32_t st[8], uint32_t w[16]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            uint32_t s0 = sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3);
            uint32_t s1 = sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;  // w[t & 15] held w[t - 16]
            w[t & 15] = wt;
        }
        sha_round(a, b, c, d, e, f, g, h, SHA_K[t] + wt);
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__device__ __forceinline__ void sha_compress_pad64(uint32_t st[8]) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) sha_round(a, b, c, d, e, f, g, h, SHA_KPAD64[t]);
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// out <- sha256(msg) for a 64-byte message given as 16 big-endian words;
// msg is clobbered.
__device__ __forceinline__ void sha256_64B(uint32_t msg[16], uint32_t out[8]) {
    out[0] = 0x6a09e667u; out[1] = 0xbb67ae85u; out[2] = 0x3c6ef372u; out[3] = 0xa54ff53au;
    out[4] = 0x510e527fu; out[5] = 0x9b05688cu; out[6] = 0x1f83d9abu; out[7] = 0x5be0cd19u;
    sha_compress(out, msg);
    sha_compress_pad64(out);
}

// out <- sha256(left || right) for two 8-word roots.
__device__ __forceinline__ void sha256_pair(const uint32_t left[8], const uint32_t right[8],
                                            uint32_t out[8]) {
    uint32_t msg[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) { msg[i] = left[i]; msg[8 + i] = right[i]; }
    sha256_64B(msg, out);
}
