// The BLS12-381 towers on the card, templates over the base field F: the
// limb field `fp` (csrc/fp.cuh, one thread an element) or the RNS field
// `rns_w` (csrc/fp_rns.cuh, one warp an element). Fp2 = Fp[u]/(u^2 + 1),
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v), xi = 1 + u. An Fp12
// is held as the Fp6 pair (a, b) = (coefficients 0, 2, 4 of w; coefficients
// 1, 3, 5), and stored as the JAX package's six Fp2 coefficients of w^k
// (row 2k + c; 144 words over the limb field, 768 over RNS).
//
// Replaces consensus_specs_tpu/ops/bls12_jax.py:82-436 (`f2_*`, `f2_inv`
// :158, `_f6_mul`/`_f6_inv` :324-350, `f12_inv` :364, `f12_conj`). The TPU
// program stacks independent products into one wide field call; here each
// thread (each warp, under rns_w) runs the formulas in sequence. The final
// exponentiation's Fp12 product (:241), squaring, Frobenius maps (:423-440)
// and cyclotomic squaring (:539) run on a group of units instead
// (csrc/f12_group.cuh), and so does the Miller loop's squaring (:250) and
// line product (:312) (csrc/bls_group.cuh's programs), each with the
// one-unit formulas.
// Both instances run these same formulas. Limb values are canonical, so the
// Karatsuba forms give JAX's words exactly. RNS values are redundant: a
// result's residues depend on the integers fed to each Montgomery product,
// so ops/bls12.py's plain version, which is bit-equal to both instances,
// feeds every product the same sums and differences as these formulas (and
// counts the same Fp products).
//
// Every function writes its result after reading all its inputs, so a
// result may alias an input. The Fp2/Fp6/Fp12 functions are not inlined:
// inlined Fp12 code takes nvcc minutes and the registers of a thread.
#pragma once
#include "fp.cuh"
#include "fp_rns.cuh"

template <typename F>
struct fp2_t {
    F c0, c1;
};
template <typename F>
struct fp6_t {
    fp2_t<F> c[3];
};
template <typename F>
struct fp12_t {
    fp6_t<F> a, b;
};
using fp2 = fp2_t<fp>;
using fp6 = fp6_t<fp>;
using fp12 = fp12_t<fp>;

// threads an element of F or of a tower over it
template <typename F>
struct lanes_of {
    static constexpr int value = F::LANES;
};
template <typename F>
struct lanes_of<fp2_t<F>> {
    static constexpr int value = F::LANES;
};

// int32 words an element of F or of Fp2 over it takes in memory
template <typename F>
struct words_of {
    static constexpr int value = F::WORDS;
};
template <typename F>
struct words_of<fp2_t<F>> {
    static constexpr int value = 2 * F::WORDS;
};

// --- Fp2 ---------------------------------------------------------------------

template <typename F>
BLS_NOINLINE void f2_add(fp2_t<F> &r, const fp2_t<F> &x, const fp2_t<F> &y) {
    F a, b;
    fp_add(a, x.c0, y.c0);
    fp_add(b, x.c1, y.c1);
    r.c0 = a;
    r.c1 = b;
}

template <typename F>
BLS_NOINLINE void f2_sub(fp2_t<F> &r, const fp2_t<F> &x, const fp2_t<F> &y) {
    F a, b;
    fp_sub(a, x.c0, y.c0);
    fp_sub(b, x.c1, y.c1);
    r.c0 = a;
    r.c1 = b;
}

template <typename F>
BLS_INLINE void f2_dbl(fp2_t<F> &r, const fp2_t<F> &x) { f2_add(r, x, x); }

template <typename F>
BLS_NOINLINE void f2_neg(fp2_t<F> &r, const fp2_t<F> &x) {
    fp_neg(r.c0, x.c0);
    fp_neg(r.c1, x.c1);
}

template <typename F>
BLS_NOINLINE void f2_conj(fp2_t<F> &r, const fp2_t<F> &x) {
    r.c0 = x.c0;
    fp_neg(r.c1, x.c1);
}

template <typename F>
BLS_INLINE void f2_set_zero(fp2_t<F> &r) {
    fp_set_zero(r.c0);
    fp_set_zero(r.c1);
}

template <typename F>
BLS_INLINE void f2_set_one(fp2_t<F> &r) {
    fp_set_one(r.c0);
    fp_set_zero(r.c1);
}

template <typename F>
BLS_INLINE bool f2_is_zero(const fp2_t<F> &x) { return fp_is_zero(x.c0) & fp_is_zero(x.c1); }

// Karatsuba: ac - bd, (a + b)(c + d) - ac - bd; 3 Fp products
template <typename F>
BLS_NOINLINE void f2_mul(fp2_t<F> &r, const fp2_t<F> &x, const fp2_t<F> &y) {
    F ac, bd, s, t;
    fp_mul(ac, x.c0, y.c0);
    fp_mul(bd, x.c1, y.c1);
    fp_add(s, x.c0, x.c1);
    fp_add(t, y.c0, y.c1);
    fp_mul(t, s, t);
    fp_sub(t, t, ac);
    fp_sub(r.c1, t, bd);
    fp_sub(r.c0, ac, bd);
}

// (a + b)(a - b), 2a·b; 2 Fp products
template <typename F>
BLS_NOINLINE void f2_sqr(fp2_t<F> &r, const fp2_t<F> &x) {
    F s, d, t;
    fp_add(s, x.c0, x.c1);
    fp_sub(d, x.c0, x.c1);
    fp_add(t, x.c0, x.c0);
    fp_mul(t, t, x.c1);
    fp_mul(r.c0, s, d);
    r.c1 = t;
}

// x·(1 + u) = (a - b) + (a + b)u
template <typename F>
BLS_NOINLINE void f2_mul_xi(fp2_t<F> &r, const fp2_t<F> &x) {
    F a, b;
    fp_sub(a, x.c0, x.c1);
    fp_add(b, x.c0, x.c1);
    r.c0 = a;
    r.c1 = b;
}

template <typename F>
BLS_NOINLINE void f2_inv(fp2_t<F> &r, const fp2_t<F> &x) {
    F n, t;
    fp_sqr(n, x.c0);
    fp_sqr(t, x.c1);
    fp_add(n, n, t);
    fp_inv(n, n);
    fp_mul(t, x.c1, n);
    fp_mul(r.c0, x.c0, n);
    fp_neg(r.c1, t);
}

// --- Fp6 ---------------------------------------------------------------------

template <typename F>
BLS_NOINLINE void f6_sub(fp6_t<F> &r, const fp6_t<F> &x, const fp6_t<F> &y) {
    for (int k = 0; k < 3; ++k) f2_sub(r.c[k], x.c[k], y.c[k]);
}

template <typename F>
BLS_NOINLINE void f6_neg(fp6_t<F> &r, const fp6_t<F> &x) {
    for (int k = 0; k < 3; ++k) f2_neg(r.c[k], x.c[k]);
}

// v·(a0, a1, a2) = (xi a2, a0, a1)
template <typename F>
BLS_NOINLINE void f6_mul_by_v(fp6_t<F> &r, const fp6_t<F> &x) {
    fp2_t<F> t;
    f2_mul_xi(t, x.c[2]);
    r.c[2] = x.c[1];
    r.c[1] = x.c[0];
    r.c[0] = t;
}

// Karatsuba over Fp2: 6 Fp2 products
template <typename F>
BLS_NOINLINE void f6_mul(fp6_t<F> &r, const fp6_t<F> &x, const fp6_t<F> &y) {
    fp2_t<F> t0, t1, t2, s, u, c0, c1, c2;
    f2_mul(t0, x.c[0], y.c[0]);
    f2_mul(t1, x.c[1], y.c[1]);
    f2_mul(t2, x.c[2], y.c[2]);
    // c0 = t0 + xi((a1 + a2)(b1 + b2) - t1 - t2)
    f2_add(s, x.c[1], x.c[2]);
    f2_add(u, y.c[1], y.c[2]);
    f2_mul(s, s, u);
    f2_add(u, t1, t2);
    f2_sub(s, s, u);
    f2_mul_xi(s, s);
    f2_add(c0, t0, s);
    // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
    f2_add(s, x.c[0], x.c[1]);
    f2_add(u, y.c[0], y.c[1]);
    f2_mul(s, s, u);
    f2_add(u, t0, t1);
    f2_sub(s, s, u);
    f2_mul_xi(u, t2);
    f2_add(c1, s, u);
    // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
    f2_add(s, x.c[0], x.c[2]);
    f2_add(u, y.c[0], y.c[2]);
    f2_mul(s, s, u);
    f2_add(u, t0, t2);
    f2_sub(s, s, u);
    f2_add(c2, s, t1);
    r.c[0] = c0;
    r.c[1] = c1;
    r.c[2] = c2;
}

template <typename F>
BLS_NOINLINE void f6_inv(fp6_t<F> &r, const fp6_t<F> &x) {
    fp2_t<F> c0, c1, c2, t, u;
    f2_sqr(c0, x.c[0]);
    f2_mul(t, x.c[1], x.c[2]);
    f2_mul_xi(t, t);
    f2_sub(c0, c0, t);  // a0^2 - xi a1 a2
    f2_sqr(c1, x.c[2]);
    f2_mul_xi(c1, c1);
    f2_mul(t, x.c[0], x.c[1]);
    f2_sub(c1, c1, t);  // xi a2^2 - a0 a1
    f2_sqr(c2, x.c[1]);
    f2_mul(t, x.c[0], x.c[2]);
    f2_sub(c2, c2, t);  // a1^2 - a0 a2
    f2_mul(t, x.c[0], c0);
    f2_mul(u, x.c[2], c1);
    fp2_t<F> w;
    f2_mul(w, x.c[1], c2);
    f2_add(u, u, w);
    f2_mul_xi(u, u);
    f2_add(t, t, u);  // a0 c0 + xi (a2 c1 + a1 c2)
    f2_inv(t, t);
    f2_mul(r.c[0], c0, t);
    f2_mul(r.c[1], c1, t);
    f2_mul(r.c[2], c2, t);
}

// --- Fp12 --------------------------------------------------------------------

// the Fp2 coefficient of w^k
template <typename F>
BLS_INLINE fp2_t<F> &f12_coeff(fp12_t<F> &x, int k) {
    return (k & 1) ? x.b.c[k >> 1] : x.a.c[k >> 1];
}

template <typename F>
BLS_INLINE const fp2_t<F> &f12_coeff(const fp12_t<F> &x, int k) {
    return (k & 1) ? x.b.c[k >> 1] : x.a.c[k >> 1];
}

// the six Fp2 coefficients of w^k in memory, row 2k + c an element (144
// words for the limb field, 768 for RNS)
template <typename F>
BLS_INLINE void f12_load(fp12_t<F> &r, const uint32_t *src) {
    for (int k = 0; k < 6; ++k) {
        fp2_t<F> &c = f12_coeff(r, k);
        fp_load(c.c0, src + (2 * k) * F::WORDS);
        fp_load(c.c1, src + (2 * k + 1) * F::WORDS);
    }
}

template <typename F>
BLS_INLINE void f12_store(uint32_t *dst, const fp12_t<F> &x) {
    for (int k = 0; k < 6; ++k) {
        const fp2_t<F> &c = f12_coeff(x, k);
        fp_store(dst + (2 * k) * F::WORDS, c.c0);
        fp_store(dst + (2 * k + 1) * F::WORDS, c.c1);
    }
}

template <typename F>
BLS_NOINLINE bool f12_is_one(const fp12_t<F> &x) {
    bool ok = fp_is_one(x.a.c[0].c0) & fp_is_zero(x.a.c[0].c1);
    for (int k = 1; k < 3; ++k) ok = ok & f2_is_zero(x.a.c[k]);
    for (int k = 0; k < 3; ++k) ok = ok & f2_is_zero(x.b.c[k]);
    return ok;
}

// f^(p^6): the odd coefficients negated
template <typename F>
BLS_NOINLINE void f12_conj(fp12_t<F> &r, const fp12_t<F> &x) {
    r.a = x.a;
    f6_neg(r.b, x.b);
}

// (a + b w)^-1 = (a - b w)/(a^2 - v b^2)
template <typename F>
BLS_NOINLINE void f12_inv(fp12_t<F> &r, const fp12_t<F> &x) {
    fp6_t<F> s, t;
    f6_mul(s, x.a, x.a);
    f6_mul(t, x.b, x.b);
    f6_mul_by_v(t, t);
    f6_sub(s, s, t);
    f6_inv(s, s);
    f6_mul(t, x.b, s);
    f6_mul(r.a, x.a, s);
    f6_neg(r.b, t);
}

// gamma1^k (p = 1) or gamma2^k (p = 2): limb words in constant memory, RNS
// residues in global memory (each lane its two channels)
BLS_INLINE void f2_gamma(fp2 &r, int p, int k) {
    for (int j = 0; j < 12; ++j) {
        r.c0.w[j] = p == 1 ? GAMMA1[k][0][j] : GAMMA2[k][0][j];
        r.c1.w[j] = p == 1 ? GAMMA1[k][1][j] : GAMMA2[k][1][j];
    }
}

BLS_INLINE void f2_gamma(fp2_t<rns_w> &r, int p, int k) {
    const int(*g)[2][RNS_N] = p == 1 ? RNS_GAMMA1 : RNS_GAMMA2;
    fp_load(r.c0, (const uint32_t *)g[k][0]);
    fp_load(r.c1, (const uint32_t *)g[k][1]);
}
