// The BLS12-381 base field in a residue number system on the card, one warp
// an element: an element is 64 int32 residues modulo the 15-bit primes of
// rns_constants.cuh (base A = channels 0..31, base B = 32..63), and lane c
// of the warp holds residue c (base A) and residue 32 + c (base B), two
// registers a lane. Montgomery form with R = M_A, values signed and
// redundant exactly as ops/fp_rns.py keeps them (a product lands in
// (-p/2^9, 3p); equality goes through the class compares of fp_is_zero /
// fp_is_one).
//
// Replaces consensus_specs_tpu/ops/fp_rns.py: `_add`/`_sub`/`_neg`
// (:239-250), `_mul_wide` (:290), `_mont_reduce` (:300) with its two base
// extensions `_extend` (:255), `_mont_mul` (:320), `_pow_const` (:325),
// `fp_sum_stack` (:353) and `fp_is_zero`/`fp_is_one_mont` (:381-390). The
// TPU program splits each extension's (.., 32) x (32, 32) product into four
// int8 matmuls for the MXU; here lane j is destination channel j, receives
// the 32 source sigma_i by __shfl_sync and accumulates sigma_i·C[i][j] in 64
// bits (each term below 2^30, the sum below 2^35), which reaches the same
// canonical residue. Every other reduction is JAX's: folds through
// 2^15 = delta (mod m) and one conditional subtraction.
//
// alpha: every lane sums sigma_i·(1/m_i) itself, in channel order 0..31,
// with __fmul_rn / __fadd_rn along the loop that receives the shuffles (a
// shuffle tree would reorder the sum; an FMA would round once where the
// plain version rounds twice); offset -1/4 on the first extension, +1/4 on
// the second, floorf, int. So alpha is bit-equal to the plain version's
// (ROADMAP C7) and the same on every lane.
//
// The windows (checked by ops/bls12.py's window mode, tests/
// test_torch_bls_rns_fused.py). A mont_reduce input t stands for the
// integer T, the representative in (-M/2, M/2) of its residues (M = M_A·M_B,
// about 2^958). q_hat is q or q + M_A (alpha one short under the -1/4
// offset), so r = (T + q_hat·p)/M_A lies in (T/M_A, T/M_A + 2p):
//   - result in (-p/2^9, 3p) while T in (-p·M_A/2^9, p·M_A);
//   - second extension exact while r in (-M_B/4 + 2^-12·M_B, 3·M_B/4 -
//     2^-12·M_B) (alpha's float32 sum of 32 terms is within 2^-12 of the
//     true sum), which the first window implies: |r| < 3p << M_B / 4.
// A product of two shrunk values (each in (-p/2^9, 3p)) is below 9p^2,
// about 2^-96 of p·M_A; the towers' sums of a few such values stay far
// inside both windows.
//
// Every branch the towers and curves take on a field value (is_zero,
// is_one) is a class compare on every lane combined by __all_sync, so it is
// uniform across the warp: the warp never diverges and every shuffle sees
// all 32 lanes.
//
// Tables: the two 32 x 32 extension matrices and the per-channel vectors
// live in shared memory (`RNS_SH`), copied from rns_constants.cuh by
// `field_prologue` at the start of every kernel that uses the field (all
// threads, before any returns): lane j reads column j of a matrix row
// (conflict-free), lane c entry c of a vector. alpha's 1/m_i and the
// exponents are read at one address by the whole warp (broadcast).
//
// Bound: a Montgomery product needs about 3,700 lane instructions of
// arithmetic in all (chip_smoke.py's `rns_least_instructions`), spread here
// over 32 lanes: 2 x 32 shuffles with their 64-bit multiply-adds, matrix
// loads and alpha terms, plus each lane's own reductions.
#pragma once
#include <math.h>
#include <stdint.h>

#include "rns_constants.cuh"

#define RNS_INLINE __device__ __forceinline__
#define RNS_NOINLINE __device__ __noinline__
#define RNS_N 64
#define RNS_K 32
#define RNS_FULL 0xffffffffu

struct rns_w {
    int a, b;  // lane c: residue c (base A), residue 32 + c (base B)
    static constexpr int LANES = 32;  // threads an element
    static constexpr int WORDS = RNS_N;  // int32 words an element in memory
};

// the per-channel vectors of the shared tables, by row
enum {
    RV_MA, RV_MB, RV_NEG_PINV_A, RV_AB_WINV, RV_P_MOD_B, RV_MAINV_MOD_B, RV_BA_WINV, RV_AB_MMOD,
    RV_BA_MMOD, RV_ONE_A, RV_ONE_B, RV_ZERO, RV_ONE = RV_ZERO + 6, RV_ROWS = RV_ONE + 6
};

struct rns_tables {
    int c_ab[RNS_K * RNS_K];  // C[i][j] = (M_A / a_i) mod b_j, row i
    int c_ba[RNS_K * RNS_K];  // C[i][j] = (M_B / b_i) mod a_j
    int v[RV_ROWS][RNS_K];    // per-channel vectors, entry c for lane c
    float inv_ab[RNS_K], inv_ba[RNS_K];  // 1 / m_i of the source base
};

__shared__ rns_tables RNS_SH;

RNS_INLINE int rns_lane() { return threadIdx.x & 31; }

RNS_INLINE int rns_v(int row) { return RNS_SH.v[row][rns_lane()]; }

// Copy the tables into shared memory; every thread of the block calls it
// before any thread uses the field.
RNS_INLINE void rns_load_tables() {
    for (int i = threadIdx.x; i < RNS_K * RNS_K; i += blockDim.x) {
        RNS_SH.c_ab[i] = RNS_AB_C[i];
        RNS_SH.c_ba[i] = RNS_BA_C[i];
    }
    for (int i = threadIdx.x; i < RV_ROWS * RNS_K; i += blockDim.x) {
        int row = i / RNS_K, c = i % RNS_K, x;
        switch (row) {
            case RV_MA: x = RNS_M[c]; break;
            case RV_MB: x = RNS_M[RNS_K + c]; break;
            case RV_NEG_PINV_A: x = RNS_NEG_PINV_A[c]; break;
            case RV_AB_WINV: x = RNS_AB_WINV[c]; break;
            case RV_P_MOD_B: x = RNS_P_MOD_B[c]; break;
            case RV_MAINV_MOD_B: x = RNS_MAINV_MOD_B[c]; break;
            case RV_BA_WINV: x = RNS_BA_WINV[c]; break;
            case RV_AB_MMOD: x = RNS_AB_MMOD[c]; break;
            case RV_BA_MMOD: x = RNS_BA_MMOD[c]; break;
            case RV_ONE_A: x = RNS_ONE_MONT[c]; break;
            case RV_ONE_B: x = RNS_ONE_MONT[RNS_K + c]; break;
            default: {  // class k of zero or one, half h (A or B)
                int k = (row - RV_ZERO) % 6 / 2, h = (row - RV_ZERO) % 2;
                const int *cls = row < RV_ONE ? RNS_ZERO_CLASSES : RNS_ONE_CLASSES;
                x = cls[k * RNS_N + h * RNS_K + c];
            }
        }
        RNS_SH.v[row][c] = x;
    }
    for (int i = threadIdx.x; i < RNS_K; i += blockDim.x) {
        RNS_SH.inv_ab[i] = __uint_as_float(RNS_AB_INV[i]);
        RNS_SH.inv_ba[i] = __uint_as_float(RNS_BA_INV[i]);
    }
    __syncthreads();
}

// one fold: (x >> 15)·delta + (x & 32767), the same value mod m (delta =
// 2^15 - m)
RNS_INLINE uint32_t rns_fold(uint32_t x, uint32_t delta) {
    return (x >> 15) * delta + (x & 32767u);
}

RNS_INLINE uint32_t rns_cond_sub(uint32_t x, uint32_t m) { return x >= m ? x - m : x; }

// x in [0, 2^31) -> x mod m (ops/fp_rns.py:215 `_red_full`)
RNS_INLINE uint32_t rns_red_full(uint32_t x, uint32_t m) {
    uint32_t d = 32768u - m;
    x = rns_fold(x, d);
    x = rns_fold(x, d);
    x = rns_fold(x, d);
    x = rns_fold(x, d);
    return rns_cond_sub(x, m);
}

// x in [0, ~2^18) -> x mod m (:225 `_red_small`)
RNS_INLINE uint32_t rns_red_small(uint32_t x, uint32_t m) {
    uint32_t d = 32768u - m;
    return rns_cond_sub(rns_fold(rns_fold(x, d), d), m);
}

// One base extension, lane j the destination channel j: (sum_i sigma_i·C[i][j]
// - alpha·M_src) mod m, canonical. sigma: this lane's canonical source
// residue; the 32 of the warp are gathered by shuffles.
RNS_INLINE uint32_t rns_extend(uint32_t sigma, const int *C, const float *inv, int mmod,
                               uint32_t m, float offset) {
    const int j = rns_lane();
    float s = 0.0f;
    unsigned long long acc = 0;
#pragma unroll
    for (int i = 0; i < RNS_K; i++) {
        uint32_t si = __shfl_sync(RNS_FULL, sigma, i);
        acc += (unsigned long long)si * (uint32_t)C[i * RNS_K + j];
        s = __fadd_rn(s, __fmul_rn((float)si, inv[i]));
    }
    int alpha = (int)floorf(__fadd_rn(s, offset));  // in [-1, 32]
    // acc < 2^35: one 64-bit fold brings it below 2^31
    uint32_t x = (uint32_t)((acc >> 15) * (32768u - m) + (acc & 32767ull));
    x = rns_red_full(x, m);
    // alpha·M_src <= 2^20 < m << 11 keeps the value positive (JAX's offset)
    int y = (int)x + (int)(m << 11) - alpha * mmod;
    return rns_red_full((uint32_t)y, m);
}

// t -> t·M_A^-1 (mod p), in (-p/2^9, 3p) for t inside the window above
RNS_NOINLINE void rns_mont_reduce(rns_w &r, const rns_w &t) {
    const uint32_t ma = (uint32_t)rns_v(RV_MA), mb = (uint32_t)rns_v(RV_MB);
    uint32_t q = rns_red_full((uint32_t)t.a * (uint32_t)rns_v(RV_NEG_PINV_A), ma);
    uint32_t sigma = rns_red_full(q * (uint32_t)rns_v(RV_AB_WINV), ma);
    // alpha may fall one short (offset -1/4): q_hat < 2·M_A, the result + p
    uint32_t qhat = rns_extend(sigma, RNS_SH.c_ab, RNS_SH.inv_ab, rns_v(RV_AB_MMOD), mb, -0.25f);
    uint32_t qp = rns_red_full(qhat * (uint32_t)rns_v(RV_P_MOD_B), mb);
    uint32_t u = rns_red_full((uint32_t)t.b + qp, mb);
    uint32_t rb = rns_red_full(u * (uint32_t)rns_v(RV_MAINV_MOD_B), mb);
    uint32_t sigma2 = rns_red_full(rb * (uint32_t)rns_v(RV_BA_WINV), mb);
    // exact: |r| < 3p << M_B parks the fractional sum far from the floor
    uint32_t ra = rns_extend(sigma2, RNS_SH.c_ba, RNS_SH.inv_ba, rns_v(RV_BA_MMOD), ma, 0.25f);
    r.a = (int)ra;
    r.b = (int)rb;
}

// per-channel product, not Montgomery-reduced (:290 `_mul_wide`)
RNS_INLINE void rns_mul_wide(rns_w &r, const rns_w &x, const rns_w &y) {
    int a = (int)rns_red_full((uint32_t)x.a * (uint32_t)y.a, (uint32_t)rns_v(RV_MA));
    int b = (int)rns_red_full((uint32_t)x.b * (uint32_t)y.b, (uint32_t)rns_v(RV_MB));
    r.a = a;
    r.b = b;
}

// --- the field's interface, under the limb field's names (csrc/fp.cuh) -----

RNS_NOINLINE void fp_mul(rns_w &r, const rns_w &x, const rns_w &y) {
    rns_w t;
    rns_mul_wide(t, x, y);
    rns_mont_reduce(r, t);
}

RNS_INLINE void fp_sqr(rns_w &r, const rns_w &a) { fp_mul(r, a, a); }

RNS_INLINE void fp_add(rns_w &r, const rns_w &x, const rns_w &y) {
    uint32_t ma = (uint32_t)rns_v(RV_MA), mb = (uint32_t)rns_v(RV_MB);
    int a = (int)rns_cond_sub((uint32_t)(x.a + y.a), ma);
    int b = (int)rns_cond_sub((uint32_t)(x.b + y.b), mb);
    r.a = a;
    r.b = b;
}

// the signed integer x - y, channel by channel: x + (m - y), no normalisation
RNS_INLINE void fp_sub(rns_w &r, const rns_w &x, const rns_w &y) {
    int ma = rns_v(RV_MA), mb = rns_v(RV_MB);
    int a = (int)rns_cond_sub((uint32_t)(x.a + (ma - y.a)), (uint32_t)ma);
    int b = (int)rns_cond_sub((uint32_t)(x.b + (mb - y.b)), (uint32_t)mb);
    r.a = a;
    r.b = b;
}

RNS_INLINE void fp_neg(rns_w &r, const rns_w &x) {
    int ma = rns_v(RV_MA), mb = rns_v(RV_MB);
    r.a = (int)rns_cond_sub((uint32_t)(ma - x.a), (uint32_t)ma);
    r.b = (int)rns_cond_sub((uint32_t)(mb - x.b), (uint32_t)mb);
}

RNS_INLINE void fp_set_zero(rns_w &r) { r.a = r.b = 0; }

RNS_INLINE void fp_set_one(rns_w &r) {
    r.a = rns_v(RV_ONE_A);
    r.b = rns_v(RV_ONE_B);
}

// a^e from the top bit of e (nbits bits, little-endian words; the top bit
// set): a square, then the product where the bit is set (:325; JAX computes
// the product always and selects, the same values)
RNS_NOINLINE void rns_pow(rns_w &r, const rns_w &a, const unsigned *e, int nbits) {
    rns_w acc;
    fp_set_one(acc);
#pragma unroll 1
    for (int k = nbits - 1; k >= 0; k--) {
        fp_mul(acc, acc, acc);
        if ((e[k >> 5] >> (k & 31)) & 1u) fp_mul(acc, acc, a);
    }
    r = acc;
}

// Fermat inverse a^(p-2); zero maps to zero
RNS_INLINE void fp_inv(rns_w &r, const rns_w &a) { rns_pow(r, a, RNS_EXP_INV, RNS_EXP_INV_BITS); }

RNS_INLINE void fp_sqrt_candidate(rns_w &r, const rns_w &a) {
    rns_pow(r, a, RNS_EXP_SQRT, RNS_EXP_SQRT_BITS);
}

// shrink (a product by the Montgomery one, into (-p/2^9, 3p)) and compare
// with the three class vectors {v, v + p, v + 2p} (:381-390), every lane its
// two channels, the warp's verdict by __all_sync
RNS_NOINLINE bool rns_in_classes(const rns_w &x, int row0) {
    rns_w one, s;
    fp_set_one(one);
    fp_mul(s, x, one);
    bool any = false;
#pragma unroll
    for (int k = 0; k < 3; k++)
        any |= __all_sync(RNS_FULL, (s.a == rns_v(row0 + 2 * k)) & (s.b == rns_v(row0 + 2 * k + 1)))
               != 0;
    return any;
}

RNS_INLINE bool fp_is_zero(const rns_w &x) { return rns_in_classes(x, RV_ZERO); }

RNS_INLINE bool fp_is_one(const rns_w &x) { return rns_in_classes(x, RV_ONE); }

// an element in memory: 64 int32 residues; lane c reads c and 32 + c (each
// half one 128-byte warp transaction)
RNS_INLINE void fp_load(rns_w &x, const uint32_t *p) {
    const int c = rns_lane();
    x.a = (int)p[c];
    x.b = (int)p[RNS_K + c];
}

RNS_INLINE void fp_store(uint32_t *p, const rns_w &x) {
    const int c = rns_lane();
    p[c] = (uint32_t)x.a;
    p[RNS_K + c] = (uint32_t)x.b;
}

RNS_INLINE void field_prologue(rns_w *) { rns_load_tables(); }
