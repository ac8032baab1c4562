// The BLS12-381 base field in a residue number system on the card: an
// element is 64 int32 residues modulo the 15-bit primes of
// rns_constants.cuh (base A = channels 0..31, base B = 32..63), Montgomery
// form with R = M_A, values signed and redundant exactly as
// ops/fp_rns.py keeps them (a product lands in (-p/2^9, 3p); equality goes
// through the class compares of rns_is_zero / rns_is_one).
//
// Replaces consensus_specs_tpu/ops/fp_rns.py: `_add`/`_sub`/`_neg`
// (:239-250), `_mul_wide` (:290), `_mont_reduce` (:300) with its two base
// extensions `_extend` (:255), `_mont_mul` (:320), `_pow_const` (:325),
// `fp_sum_stack` (:353) and `fp_is_zero`/`fp_is_one_mont` (:381-390). The
// TPU program splits each extension's (.., 32) x (32, 32) product into four
// int8 matmuls for the MXU; here one thread owns an element and accumulates
// the 32 products of a destination channel in 64 bits (each below 2^30, the
// sum below 2^35), which reaches the same canonical residue. Every other
// reduction is JAX's: folds through 2^15 = delta (mod m) and one
// conditional subtraction.
//
// alpha: the float32 sum of sigma_i * (1/m_i), in channel order 0..31, with
// __fmul_rn / __fadd_rn so that nvcc never contracts it into an FMA (an FMA
// rounds once where the plain version rounds twice); offset -1/4 on the
// first extension, +1/4 on the second, floorf, int.
//
// Bound: a Montgomery product needs about 3,700 lane instructions (2 x 1024
// 64-bit multiply-adds, 320 channel products with their reductions, the
// alpha sums; chip_smoke.py's `rns_least_instructions`) against 512 bytes
// read and 256 written, under the ten instructions a byte at which the card's
// issue rate meets its memory rate: bytes. The code here executes several
// times that many instructions (the rolled extension loops).
//
// Plain C++ apart from the qualifiers in RNS_INLINE and __constant__: with
// those defined empty (and __fmul_rn/__fadd_rn as plain float ops under
// -ffp-contract=off) g++ builds it on a host.
#pragma once
#include <math.h>
#include <stdint.h>

#include "rns_constants.cuh"

#define RNS_INLINE __device__ __forceinline__
#define RNS_N 64
#define RNS_K 32

struct rns {
    int v[RNS_N];
};

// one fold: (x >> 15)·delta + (x & 32767), the same value mod m
RNS_INLINE uint32_t rns_fold(uint32_t x, uint32_t delta) {
    return (x >> 15) * delta + (x & 32767u);
}

RNS_INLINE uint32_t rns_cond_sub(uint32_t x, uint32_t m) { return x >= m ? x - m : x; }

// x in [0, 2^31) -> x mod m (ops/fp_rns.py:215 `_red_full`)
RNS_INLINE uint32_t rns_red_full(uint32_t x, uint32_t m, uint32_t delta) {
    x = rns_fold(x, delta);
    x = rns_fold(x, delta);
    x = rns_fold(x, delta);
    x = rns_fold(x, delta);
    return rns_cond_sub(x, m);
}

// x in [0, ~2^18) -> x mod m (:225 `_red_small`)
RNS_INLINE uint32_t rns_red_small(uint32_t x, uint32_t m, uint32_t delta) {
    return rns_cond_sub(rns_fold(rns_fold(x, delta), delta), m);
}

// One base extension: out[j] = (sum_i sigma_i·C[i][j] - alpha·M_src) mod dst_j,
// canonical. sigma: 32 canonical residues of the source base.
RNS_INLINE void rns_extend(int *out, const int *sigma, const int *C, const int *mmod,
                           const unsigned *inv_bits, const int *dst_m, const int *dst_delta,
                           float offset) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < RNS_K; i++)
        s = __fadd_rn(s, __fmul_rn((float)sigma[i], __uint_as_float(inv_bits[i])));
    int alpha = (int)floorf(__fadd_rn(s, offset));  // in [-1, 32]
    // one trip a destination channel, its 32 products unrolled (with this
    // loop unrolled too, cicc of CUDA 12.9 crashed on the 32 x 32 nest)
#pragma unroll 1
    for (int j = 0; j < RNS_K; j++) {
        unsigned long long acc = 0;
#pragma unroll
        for (int i = 0; i < RNS_K; i++)
            acc += (unsigned long long)(uint32_t)sigma[i] * (uint32_t)C[i * RNS_K + j];
        uint32_t m = (uint32_t)dst_m[j], d = (uint32_t)dst_delta[j];
        // acc < 2^35: one 64-bit fold brings it below 2^31
        uint32_t x = (uint32_t)((acc >> 15) * d + (acc & 32767ull));
        x = rns_red_full(x, m, d);
        // alpha·M_src <= 2^20 < m << 11 keeps the value positive (JAX's offset)
        int y = (int)x + (int)(m << 11) - alpha * mmod[j];
        out[j] = (int)rns_red_full((uint32_t)y, m, d);
    }
}

// t -> t·M_A^-1 (mod p), in (-p/2^9, 3p); t any channel-reduced value
RNS_INLINE void rns_mont_reduce(rns &r, const rns &t) {
    int sigma[RNS_K], qhat[RNS_K], sigma2[RNS_K];
#pragma unroll
    for (int i = 0; i < RNS_K; i++) {
        uint32_t m = (uint32_t)RNS_M[i], d = (uint32_t)RNS_DELTA[i];
        uint32_t q = rns_red_full((uint32_t)t.v[i] * (uint32_t)RNS_NEG_PINV_A[i], m, d);
        sigma[i] = (int)rns_red_full(q * (uint32_t)RNS_AB_WINV[i], m, d);
    }
    // alpha may fall one short (offset -1/4): q_hat < 2·M_A, the result + p
    rns_extend(qhat, sigma, RNS_AB_C, RNS_AB_MMOD, RNS_AB_INV, RNS_M + RNS_K, RNS_DELTA + RNS_K,
               -0.25f);
#pragma unroll
    for (int j = 0; j < RNS_K; j++) {
        uint32_t m = (uint32_t)RNS_M[RNS_K + j], d = (uint32_t)RNS_DELTA[RNS_K + j];
        uint32_t qp = rns_red_full((uint32_t)qhat[j] * (uint32_t)RNS_P_MOD_B[j], m, d);
        uint32_t u = rns_red_full((uint32_t)t.v[RNS_K + j] + qp, m, d);
        uint32_t rb = rns_red_full(u * (uint32_t)RNS_MAINV_MOD_B[j], m, d);
        r.v[RNS_K + j] = (int)rb;
        sigma2[j] = (int)rns_red_full(rb * (uint32_t)RNS_BA_WINV[j], m, d);
    }
    // exact: |r| < 3p << M_B parks the fractional sum far from the floor
    rns_extend(r.v, sigma2, RNS_BA_C, RNS_BA_MMOD, RNS_BA_INV, RNS_M, RNS_DELTA, 0.25f);
}

// per-channel product, not Montgomery-reduced (:290 `_mul_wide`)
RNS_INLINE void rns_mul_wide(rns &r, const rns &x, const rns &y) {
#pragma unroll
    for (int c = 0; c < RNS_N; c++)
        r.v[c] = (int)rns_red_full((uint32_t)x.v[c] * (uint32_t)y.v[c], (uint32_t)RNS_M[c],
                                   (uint32_t)RNS_DELTA[c]);
}

RNS_INLINE void rns_mont_mul(rns &r, const rns &x, const rns &y) {
    rns t;
    rns_mul_wide(t, x, y);
    rns_mont_reduce(r, t);
}

RNS_INLINE void rns_add(rns &r, const rns &a, const rns &b) {
#pragma unroll
    for (int c = 0; c < RNS_N; c++)
        r.v[c] = (int)rns_cond_sub((uint32_t)(a.v[c] + b.v[c]), (uint32_t)RNS_M[c]);
}

// the signed integer a - b, channel by channel: a + (m - b), no normalisation
RNS_INLINE void rns_sub(rns &r, const rns &a, const rns &b) {
#pragma unroll
    for (int c = 0; c < RNS_N; c++)
        r.v[c] = (int)rns_cond_sub((uint32_t)(a.v[c] + (RNS_M[c] - b.v[c])), (uint32_t)RNS_M[c]);
}

RNS_INLINE void rns_neg(rns &r, const rns &a) {
#pragma unroll
    for (int c = 0; c < RNS_N; c++)
        r.v[c] = (int)rns_cond_sub((uint32_t)(RNS_M[c] - a.v[c]), (uint32_t)RNS_M[c]);
}

// a^e from the top bit of e (nbits bits, little-endian words): a square,
// then the product JAX always computes, selected by the bit (:325)
RNS_INLINE void rns_pow(rns &acc, const rns &a, const unsigned *e, int nbits) {
#pragma unroll
    for (int c = 0; c < RNS_N; c++) acc.v[c] = RNS_ONE_MONT[c];
#pragma unroll 1
    for (int k = nbits - 1; k >= 0; k--) {
        rns sq, mul;
        rns_mont_mul(sq, acc, acc);
        rns_mont_mul(mul, sq, a);
        bool bit = (e[k >> 5] >> (k & 31)) & 1u;
#pragma unroll
        for (int c = 0; c < RNS_N; c++) acc.v[c] = bit ? mul.v[c] : sq.v[c];
    }
}

// shrink (a product by the Montgomery one, into (-p/2^9, 3p)) and compare
// with the three class vectors {v, v + p, v + 2p} (:381-390)
RNS_INLINE bool rns_in_classes(const rns &a, const int *classes) {
    rns one, s;
#pragma unroll
    for (int c = 0; c < RNS_N; c++) one.v[c] = RNS_ONE_MONT[c];
    rns_mont_mul(s, a, one);
    int any = 0;
#pragma unroll
    for (int k = 0; k < 3; k++) {
        int eq = 1;
#pragma unroll
        for (int c = 0; c < RNS_N; c++) eq &= (s.v[c] == classes[k * RNS_N + c]);
        any |= eq;
    }
    return any != 0;
}
