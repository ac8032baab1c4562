// The BLS12-381 scalar field Fr on the card: eight 32-bit little-endian
// words, Montgomery form with R = 2^256, every value canonical in [0, r).
//
// Replaces the Fr instance of consensus_specs_tpu/ops/limb_mont.py:39
// (`MontgomeryField(R_MODULUS, 16)`: `_add`, `_sub`, `_mont_mul`,
// `_pow_const`, `inv`) as ops/fr_jax.py:55-59 binds it. The TPU program
// keeps 16 sixteen-bit limbs in uint32 lanes with uint64 columns; JAX's
// R = 2^(16·16) is the same R as 2^(32·8) here, so a Montgomery value is the
// same integer in both packages. One thread owns an element and runs CIOS
// over 32-bit words with 64-bit accumulators:
// t[j] + a[j]·b[i] + carry <= (2^32-1) + (2^32-1)^2 + (2^32-1) = 2^64 - 1,
// so every step is exact. The result is t = (a·b + m·r) / R with m < R; for
// a, b < r that is below (r·r + R·r) / R = r·(r/R + 1) < 2r, since
// r < 2^255 = R/2. So t < 2r < R fits the eight words plus a zero top word,
// and one conditional subtraction makes it canonical, as JAX's outputs are:
// equality is a word compare. With b < r and a any eight words, a·b < R·r
// and t < 2r all the same: a product by R^2 mod r takes any words, reduced
// or not, to the canonical Montgomery form.
//
// Bound: operations (about 300 instructions a product, none of them memory
// traffic).
//
// The file is plain C++ apart from the qualifiers in FR_INLINE and the
// __constant__ tables below (tests/test_torch_fr.py holds them equal to
// ops/fr.py's constants).
#pragma once
#include <stdint.h>

#define FR_INLINE __device__ __forceinline__

// r, little-endian words
__constant__ uint32_t FR_R[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                                 0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// R mod r: the Montgomery one
__constant__ uint32_t FR_ONE[8] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                                   0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
// R^2 mod r: a product by it takes canonical words into the Montgomery domain
__constant__ uint32_t FR_R2[8] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                                  0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
// r - 2: Fermat's inverse exponent (bit 254 its top bit)
__constant__ uint32_t FR_EXP_INV[8] = {0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u,
                                       0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// -r^-1 mod 2^32 (r = 1 mod 2^32)
#define FR_N0 0xffffffffu
#define FR_EXP_INV_TOP 254

struct fr {
    uint32_t w[8];
};

FR_INLINE bool fr_is_zero(const fr &a) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) x |= a.w[j];
    return x == 0;
}

// r = t mod r for a 9-word t < 2r
FR_INLINE void fr_reduce_once(fr &r, const uint32_t *t) {
    uint32_t d[8];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint64_t x = (uint64_t)t[j] - FR_R[j] - borrow;
        d[j] = (uint32_t)x;
        borrow = x >> 63;
    }
    bool keep = (t[8] == 0) & (borrow != 0);  // t < r
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = keep ? t[j] : d[j];
}

FR_INLINE void fr_add(fr &r, const fr &a, const fr &b) {
    uint32_t t[9];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (uint64_t)a.w[j] + b.w[j] + (c >> 32);
        t[j] = (uint32_t)c;
    }
    t[8] = (uint32_t)(c >> 32);  // 0: a + b < 2r < 2^256
    fr_reduce_once(r, t);
}

// a - b, plus r where it borrows. b = 0 never borrows and returns a, the
// value limb_mont.py:159-163 reaches through a + r and one cond_sub_mod.
FR_INLINE void fr_sub(fr &r, const fr &a, const fr &b) {
    uint32_t d[8];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint64_t x = (uint64_t)a.w[j] - b.w[j] - borrow;
        d[j] = (uint32_t)x;
        borrow = x >> 63;
    }
    uint32_t mask = 0u - (uint32_t)borrow;  // a < b: add r back
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        c = (uint64_t)d[j] + (FR_R[j] & mask) + (c >> 32);
        r.w[j] = (uint32_t)c;
    }
}

// Montgomery product a·b·2^-256 mod r (CIOS)
FR_INLINE void fr_mul(fr &r, const fr &a, const fr &b) {
    uint32_t t[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint32_t bi = b.w[i];
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c = (uint64_t)t[j] + (uint64_t)a.w[j] * bi + (c >> 32);
            t[j] = (uint32_t)c;
        }
        c = (uint64_t)t[8] + (c >> 32);
        t[8] = (uint32_t)c;
        t[9] = (uint32_t)(c >> 32);
        uint32_t m = t[0] * FR_N0;
        c = (uint64_t)t[0] + (uint64_t)m * FR_R[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) {
            c = (uint64_t)t[j] + (uint64_t)m * FR_R[j] + (c >> 32);
            t[j - 1] = (uint32_t)c;
        }
        c = (uint64_t)t[8] + (c >> 32);
        t[7] = (uint32_t)c;
        t[8] = t[9] + (uint32_t)(c >> 32);
    }
    fr_reduce_once(r, t);
}

// Fermat inverse a^(r-2), square-and-multiply from the top bit (the bit
// loop stays rolled); zero maps to zero (limb_mont.py:219-220).
FR_INLINE void fr_inv(fr &r, const fr &a) {
    fr acc;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.w[j] = FR_ONE[j];
#pragma unroll 1
    for (int i = FR_EXP_INV_TOP; i >= 0; --i) {
        fr_mul(acc, acc, acc);
        if ((FR_EXP_INV[i >> 5] >> (i & 31)) & 1) fr_mul(acc, acc, a);
    }
    r = acc;
}
