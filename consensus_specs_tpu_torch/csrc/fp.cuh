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

// a^e for the exponent table `which` (0: p - 2, the inverse; 1: (p + 1)/4,
// the square root candidate), square-and-multiply from the top bit. The
// bit loop stays rolled.
BLS_NOINLINE void fp_pow_table(fp &r, const fp &a, int which) {
    fp base = a, acc;
    fp_set_one(acc);
    int top = 383;
    while (top > 0 && !(((which ? FP_EXP_SQRT[top >> 5] : FP_EXP_INV[top >> 5]) >> (top & 31)) & 1))
        --top;
#pragma unroll 1
    for (int i = top; i >= 0; --i) {
        fp_mul(acc, acc, acc);
        uint32_t word = which ? FP_EXP_SQRT[i >> 5] : FP_EXP_INV[i >> 5];
        if ((word >> (i & 31)) & 1) fp_mul(acc, acc, base);
    }
    r = acc;
}

// Fermat inverse a^(p-2); zero maps to zero (limb_mont.inv), so the affine
// image of the point at infinity is (0, 0).
BLS_INLINE void fp_inv(fp &r, const fp &a) { fp_pow_table(r, a, 0); }

BLS_INLINE void fp_sqrt_candidate(fp &r, const fp &a) { fp_pow_table(r, a, 1); }

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
