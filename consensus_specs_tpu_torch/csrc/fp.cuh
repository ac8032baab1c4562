// The BLS12-381 base field Fp on the card: twelve 32-bit little-endian
// words, Montgomery form with R = 2^384, every value canonical in [0, p).
//
// Replaces the field of consensus_specs_tpu/ops/limb_mont.py:39
// (`MontgomeryField`: `_add`, `_sub`, `_neg`, `_mont_mul`, `_pow_const`,
// `inv`) and ops/fp_jax.py:70-125. The TPU program multiplies 24 sixteen-bit
// limbs in uint64 columns with per-limb loops so that one vector op covers a
// whole batch; on the card one thread owns an element and runs CIOS over
// 32-bit words with 64-bit accumulators:
// t[j] + a[j]·b[i] + carry <= (2^32-1) + (2^32-1)^2 + (2^32-1) = 2^64 - 1,
// so every step is exact. p < 2^382 < R/4 keeps the result below 2p, and
// one conditional subtraction makes it canonical, as JAX's outputs are:
// equality is a word compare.
//
// Bound: operations (about 600 instructions a product, no memory traffic
// inside a pairing). Products are `fp_mul` (not inlined: the towers call it
// hundreds of times, and inlining it everywhere costs nvcc minutes and the
// thread registers); `fp_mul_inl` is the same code inlined, for K8.
//
// The file is plain C++ apart from the qualifiers in BLS_INLINE/BLS_NOINLINE
// and the __constant__ tables of bls_constants.cuh.
#pragma once
#include <stdint.h>

#include "bls_constants.cuh"

#define BLS_INLINE __device__ __forceinline__
#define BLS_NOINLINE __device__ __noinline__

struct fp {
    uint32_t w[12];
    static constexpr int LANES = 1;   // threads an element
    static constexpr int WORDS = 12;  // words an element in memory
};

BLS_INLINE void fp_set_zero(fp &r) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.w[j] = 0;
}

BLS_INLINE void fp_set_one(fp &r) {
#pragma unroll
    for (int j = 0; j < 12; ++j) r.w[j] = FP_ONE[j];
}

BLS_INLINE bool fp_is_zero(const fp &a) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) x |= a.w[j];
    return x == 0;
}

BLS_INLINE bool fp_is_one(const fp &a) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) x |= a.w[j] ^ FP_ONE[j];
    return x == 0;
}

// r = t mod p for a 13-word t < 2p
BLS_INLINE void fp_reduce_once(fp &r, const uint32_t *t) {
    uint32_t d[12];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        uint64_t x = (uint64_t)t[j] - FP_P[j] - borrow;
        d[j] = (uint32_t)x;
        borrow = x >> 63;
    }
    bool keep = (t[12] == 0) & (borrow != 0);  // t < p
#pragma unroll
    for (int j = 0; j < 12; ++j) r.w[j] = keep ? t[j] : d[j];
}

BLS_INLINE void fp_add(fp &r, const fp &a, const fp &b) {
    uint32_t t[13];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        c = (uint64_t)a.w[j] + b.w[j] + (c >> 32);
        t[j] = (uint32_t)c;
    }
    t[12] = (uint32_t)(c >> 32);
    fp_reduce_once(r, t);
}

BLS_INLINE void fp_sub(fp &r, const fp &a, const fp &b) {
    uint32_t d[12];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        uint64_t x = (uint64_t)a.w[j] - b.w[j] - borrow;
        d[j] = (uint32_t)x;
        borrow = x >> 63;
    }
    uint32_t mask = 0u - (uint32_t)borrow;  // a < b: add p back
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        c = (uint64_t)d[j] + (FP_P[j] & mask) + (c >> 32);
        r.w[j] = (uint32_t)c;
    }
}

BLS_INLINE void fp_neg(fp &r, const fp &a) {
    bool z = fp_is_zero(a);
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
        uint64_t x = (uint64_t)FP_P[j] - a.w[j] - borrow;
        borrow = x >> 63;
        r.w[j] = z ? 0u : (uint32_t)x;
    }
}

// Montgomery product a·b·2^-384 mod p (CIOS)
BLS_INLINE void fp_mul_inl(fp &r, const fp &a, const fp &b) {
    uint32_t t[14];
#pragma unroll
    for (int j = 0; j < 14; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
        uint32_t bi = b.w[i];
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 12; ++j) {
            c = (uint64_t)t[j] + (uint64_t)a.w[j] * bi + (c >> 32);
            t[j] = (uint32_t)c;
        }
        c = (uint64_t)t[12] + (c >> 32);
        t[12] = (uint32_t)c;
        t[13] = (uint32_t)(c >> 32);
        uint32_t m = t[0] * FP_N0;
        c = (uint64_t)t[0] + (uint64_t)m * FP_P[0];
#pragma unroll
        for (int j = 1; j < 12; ++j) {
            c = (uint64_t)t[j] + (uint64_t)m * FP_P[j] + (c >> 32);
            t[j - 1] = (uint32_t)c;
        }
        c = (uint64_t)t[12] + (c >> 32);
        t[11] = (uint32_t)c;
        t[12] = t[13] + (uint32_t)(c >> 32);
    }
    fp_reduce_once(r, t);
}

BLS_NOINLINE void fp_mul(fp &r, const fp &a, const fp &b) { fp_mul_inl(r, a, b); }

BLS_INLINE void fp_sqr(fp &r, const fp &a) { fp_mul(r, a, a); }

// a^((p+1)/4), square-and-multiply from the top bit of FP_EXP_SQRT; the
// bit loop stays rolled.
BLS_NOINLINE void fp_sqrt_candidate(fp &r, const fp &a) {
    fp acc;
    fp_set_one(acc);
    int top = 383;
    while (top > 0 && !((FP_EXP_SQRT[top >> 5] >> (top & 31)) & 1)) --top;
#pragma unroll 1
    for (int i = top; i >= 0; --i) {
        fp_mul(acc, acc, acc);
        if ((FP_EXP_SQRT[i >> 5] >> (i & 31)) & 1) fp_mul(acc, acc, a);
    }
    r = acc;
}

// --- the inverse: Bernstein-Yang divsteps (safegcd, ePrint 2019/266) ---------
//
// The constant-time modular inverse of libsecp256k1's modinv32 over 13
// signed 30-bit limbs (390 bits: p and every intermediate with its sign),
// with the original divstep (delta from 1, here eta = -delta). A round runs
// 30 divsteps on the low words of f and g alone, which fix its transition
// matrix t (entries within 2^30), then applies t to the full (f, g) with an
// exact division by 2^30 and to (d, e) modulo p (adding the multiples of p
// that clear the low 30 bits), keeping f = d·x and g = e·x mod p. From
// (f, g, d, e) = (p, x, 0, 1), GCD_ROUNDS = 37 rounds (1,110 divsteps) reach
// g = 0 for every x < p (Bernstein-Yang, theorem 11.2: floor((49·381 +
// 57)/17) = 1,101 for 381-bit inputs); then f = +-1 and x^-1 = +-d. The
// count is fixed and every step branch-free, so the time does not depend on
// the value and a lane group never parts on it. x = 0 keeps d = 0: zero maps
// to zero. ops/fp.py `gcd_inverse_int` is the same algorithm step for step
// over Python ints (tests/test_torch_fp.py holds it against a^(p-2)).
//
// Cost: a round is 30 divsteps of about 14 instructions on one 32-bit word
// and two 13-limb matrix products (about 110 wide multiply-adds), so the
// whole inverse is about the instructions of 25-30 Fp products, where
// Fermat's a^(p-2) is 608 products in one chain.
#define FP_S30 13
#define FP_GCD_ROUNDS 37
#define FP_M30 0x3fffffff

BLS_INLINE int32_t fp_divsteps30(int32_t eta, uint32_t f, uint32_t g, int32_t t[4]) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
    for (int i = 0; i < 30; ++i) {
        uint32_t c1 = (uint32_t)(eta >> 31);  // eta < 0
        uint32_t c2 = 0u - (g & 1u);           // g odd
        uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
        g += x & c2;
        q += y & c2;
        r += z & c2;
        c1 &= c2;  // swap: eta < 0 and g odd
        eta = (eta ^ (int32_t)c1) - ((int32_t)c1 + 1);
        f += g & c1;
        u += q & c1;
        v += r & c1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t[0] = (int32_t)u;
    t[1] = (int32_t)v;
    t[2] = (int32_t)q;
    t[3] = (int32_t)r;
    return eta;
}

// [f, g] <- t·[f, g] / 2^30, exact
BLS_INLINE void fp_update_fg30(int32_t *f, int32_t *g, const int32_t t[4]) {
    const int64_t u = t[0], v = t[1], q = t[2], r = t[3];
    int64_t cf = (u * f[0] + v * g[0]) >> 30;
    int64_t cg = (q * f[0] + r * g[0]) >> 30;
#pragma unroll
    for (int i = 1; i < FP_S30; ++i) {
        cf += u * f[i] + v * g[i];
        cg += q * f[i] + r * g[i];
        f[i - 1] = (int32_t)cf & FP_M30;
        cf >>= 30;
        g[i - 1] = (int32_t)cg & FP_M30;
        cg >>= 30;
    }
    f[FP_S30 - 1] = (int32_t)cf;
    g[FP_S30 - 1] = (int32_t)cg;
}

// [d, e] <- t·[d, e] / 2^30 mod p, both kept in (-2p, p)
BLS_INLINE void fp_update_de30(int32_t *d, int32_t *e, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    const int32_t sd = d[FP_S30 - 1] >> 31, se = e[FP_S30 - 1] >> 31;
    int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
    int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
    int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
    md -= (int32_t)((FP_PINV30 * (uint32_t)cd + (uint32_t)md) & FP_M30);
    me -= (int32_t)((FP_PINV30 * (uint32_t)ce + (uint32_t)me) & FP_M30);
    cd = (cd + (int64_t)FP_P30[0] * md) >> 30;
    ce = (ce + (int64_t)FP_P30[0] * me) >> 30;
#pragma unroll
    for (int i = 1; i < FP_S30; ++i) {
        cd += (int64_t)u * d[i] + (int64_t)v * e[i] + (int64_t)FP_P30[i] * md;
        ce += (int64_t)q * d[i] + (int64_t)r * e[i] + (int64_t)FP_P30[i] * me;
        d[i - 1] = (int32_t)cd & FP_M30;
        cd >>= 30;
        e[i - 1] = (int32_t)ce & FP_M30;
        ce >>= 30;
    }
    d[FP_S30 - 1] = (int32_t)cd;
    e[FP_S30 - 1] = (int32_t)ce;
}

// d in (-2p, p) -> d·sign(f) in [0, p)
BLS_INLINE void fp_normalize30(int32_t *d, int32_t sign) {
    int32_t neg = d[FP_S30 - 1] >> 31, flip = sign >> 31;
#pragma unroll
    for (int i = 0; i < FP_S30; ++i) d[i] = ((d[i] + (FP_P30[i] & neg)) ^ flip) - flip;
#pragma unroll
    for (int i = 0; i < FP_S30 - 1; ++i) {
        d[i + 1] += d[i] >> 30;
        d[i] &= FP_M30;
    }
    neg = d[FP_S30 - 1] >> 31;
#pragma unroll
    for (int i = 0; i < FP_S30; ++i) d[i] += FP_P30[i] & neg;
#pragma unroll
    for (int i = 0; i < FP_S30 - 1; ++i) {
        d[i + 1] += d[i] >> 30;
        d[i] &= FP_M30;
    }
}

// The inverse of the Montgomery value aR: the divsteps give (aR)^-1 =
// a^-1 R^-1, and one Montgomery product by R^3 mod p makes it a^-1 R,
// canonical. Zero maps to zero (limb_mont.inv), so the affine image of the
// point at infinity is (0, 0).
BLS_NOINLINE void fp_inv(fp &r, const fp &a) {
    int32_t f[FP_S30], g[FP_S30], d[FP_S30], e[FP_S30];
#pragma unroll
    for (int i = 0; i < FP_S30; ++i) {  // g: the 30-bit limbs of a's words
        const int bit = 30 * i, w = bit >> 5, sh = bit & 31;
        uint64_t x = ((uint64_t)(w + 1 < 12 ? a.w[w + 1] : 0u) << 32) | a.w[w];
        g[i] = (int32_t)((x >> sh) & FP_M30);
        f[i] = FP_P30[i];
        d[i] = 0;
        e[i] = i == 0;
    }
    int32_t eta = -1;
#pragma unroll 1
    for (int k = 0; k < FP_GCD_ROUNDS; ++k) {
        int32_t t[4];
        eta = fp_divsteps30(eta, (uint32_t)f[0], (uint32_t)g[0], t);
        fp_update_de30(d, e, t);
        fp_update_fg30(f, g, t);
    }
    fp_normalize30(d, f[FP_S30 - 1]);
    fp x, r3;
#pragma unroll
    for (int j = 0; j < 12; ++j) {  // back to 32-bit words: bits 32j .. 32j + 31
        const int bit = 32 * j, i = bit / 30, sh = bit % 30;
        // sh is even, at most 28: limbs i and i + 1 hold the 32 bits
        uint64_t v = ((uint64_t)(uint32_t)d[i] >> sh) | ((uint64_t)(uint32_t)d[i + 1] << (30 - sh));
        x.w[j] = (uint32_t)v;
        r3.w[j] = FP_R3[j];
    }
    fp_mul(r, x, r3);
}

// an element in memory: its twelve words
BLS_INLINE void fp_load(fp &x, const uint32_t *p) {
#pragma unroll
    for (int j = 0; j < 12; ++j) x.w[j] = p[j];
}

BLS_INLINE void fp_store(uint32_t *p, const fp &x) {
#pragma unroll
    for (int j = 0; j < 12; ++j) p[j] = x.w[j];
}

// the limb field keeps its constants in constant memory: nothing to load
BLS_INLINE void field_prologue(fp *) {}
