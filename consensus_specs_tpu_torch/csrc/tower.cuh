// The BLS12-381 towers on the card, templates over the base field F: the
// limb field `fp` (csrc/fp.cuh, one thread an element) or the RNS field
// `rns_w` (csrc/fp_rns.cuh, one warp an element). Fp2 = Fp[u]/(u^2 + 1),
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v), xi = 1 + u. An Fp12
// is held as the Fp6 pair (a, b) = (coefficients 0, 2, 4 of w; coefficients
// 1, 3, 5), and stored as the JAX package's six Fp2 coefficients of w^k
// (row 2k + c; 144 words over the limb field, 768 over RNS).
//
// Replaces consensus_specs_tpu/ops/bls12_jax.py:82-436 (`f2_*`, `f2_inv`
// :158, `f12_mul` :241, `f12_sqr` :250, `f12_mul_sparse035` :312,
// `_f6_mul`/`_f6_inv` :324-350, `f12_inv` :364, `f12_conj`,
// `f12_frobenius`/`f12_frobenius2` :423-440) and `f12_cyclotomic_sqr`
// :539. The TPU program stacks independent products into one wide field call;
// here each thread (each warp, under rns_w) runs the formulas in sequence.
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
BLS_NOINLINE void f2_mul_fp(fp2_t<F> &r, const fp2_t<F> &x, const F &s) {
    F a, b;
    fp_mul(a, x.c0, s);
    fp_mul(b, x.c1, s);
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
BLS_NOINLINE void f6_add(fp6_t<F> &r, const fp6_t<F> &x, const fp6_t<F> &y) {
    for (int k = 0; k < 3; ++k) f2_add(r.c[k], x.c[k], y.c[k]);
}

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

template <typename F>
BLS_INLINE void f12_set_one(fp12_t<F> &r) {
    for (int k = 0; k < 3; ++k) {
        f2_set_zero(r.a.c[k]);
        f2_set_zero(r.b.c[k]);
    }
    f2_set_one(r.a.c[0]);
}

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

// (a0 + a1 w)(b0 + b1 w) = a0 b0 + v a1 b1 + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) w
template <typename F>
BLS_NOINLINE void f12_mul(fp12_t<F> &r, const fp12_t<F> &x, const fp12_t<F> &y) {
    fp6_t<F> t0, t1, s, u;
    f6_mul(t0, x.a, y.a);
    f6_mul(t1, x.b, y.b);
    f6_add(s, x.a, x.b);
    f6_add(u, y.a, y.b);
    f6_mul(s, s, u);
    f6_add(u, t0, t1);
    f6_sub(r.b, s, u);
    f6_mul_by_v(t1, t1);
    f6_add(r.a, t0, t1);
}

// (a + b w)^2 = (a + b)(a + v b) - ab - v ab + 2ab w
template <typename F>
BLS_NOINLINE void f12_sqr(fp12_t<F> &r, const fp12_t<F> &x) {
    fp6_t<F> t, s, u;
    f6_mul(t, x.a, x.b);
    f6_add(s, x.a, x.b);
    f6_mul_by_v(u, x.b);
    f6_add(u, x.a, u);
    f6_mul(s, s, u);
    f6_mul_by_v(u, t);
    f6_add(u, t, u);
    f6_sub(r.a, s, u);
    f6_add(r.b, t, t);
}

// f·(l0 + l3 w^3 + l5 w^5): the line is (l0, 0, 0) + (0, l3, l5) w
template <typename F>
BLS_NOINLINE void f12_mul_sparse035(fp12_t<F> &r, const fp12_t<F> &f, const fp2_t<F> &l0,
                                    const fp2_t<F> &l3, const fp2_t<F> &l5) {
    fp6_t<F> t0, t1, t2, L;
    for (int k = 0; k < 3; ++k) f2_mul(t0.c[k], f.a.c[k], l0);
    f2_set_zero(L.c[0]);
    L.c[1] = l3;
    L.c[2] = l5;
    f6_mul(t1, f.b, L);
    L.c[0] = l0;
    f6_add(t2, f.a, f.b);
    f6_mul(t2, t2, L);
    f6_add(L, t0, t1);
    f6_sub(r.b, t2, L);
    f6_mul_by_v(t1, t1);
    f6_add(r.a, t0, t1);
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

// f^p: coefficient k conjugated, times gamma1^k
template <typename F>
BLS_NOINLINE void f12_frobenius(fp12_t<F> &r, const fp12_t<F> &x) {
    fp12_t<F> y = x;
    for (int k = 0; k < 6; ++k) {
        fp2_t<F> g, c;
        f2_gamma(g, 1, k);
        f2_conj(c, f12_coeff(y, k));
        f2_mul(f12_coeff(y, k), c, g);
    }
    r = y;
}

// f^(p^2): coefficient k times gamma2^k
template <typename F>
BLS_NOINLINE void f12_frobenius2(fp12_t<F> &r, const fp12_t<F> &x) {
    fp12_t<F> y = x;
    for (int k = 0; k < 6; ++k) {
        fp2_t<F> g;
        f2_gamma(g, 2, k);
        f2_mul(f12_coeff(y, k), f12_coeff(y, k), g);
    }
    r = y;
}

// Granger-Scott squaring of a unitary f: with s = w^3 and f = A + B w + C w^2
// over Fp4 = Fp2[s], A = (c0, c3), B = (c1, c4), C = (c2, c5),
// f^2 = (3A^2 - 2 conj A) + (3 s C^2 + 2 conj B) w + (3B^2 - 2 conj C) w^2
template <typename F>
BLS_NOINLINE void f12_cyclotomic_sqr(fp12_t<F> &r, const fp12_t<F> &f) {
    fp12_t<F> x = f;
    fp2_t<F> re[3], im[3];
    for (int k = 0; k < 3; ++k) {  // A, B, C: (a + b s)^2 = (a^2 + xi b^2) + 2ab s
        const fp2_t<F> &a = f12_coeff(x, k);
        const fp2_t<F> &b = f12_coeff(x, k + 3);
        fp2_t<F> a2, b2, ab;
        f2_sqr(a2, a);
        f2_sqr(b2, b);
        f2_mul(ab, a, b);
        f2_mul_xi(b2, b2);
        f2_add(re[k], a2, b2);
        f2_add(im[k], ab, ab);
    }
    fp2_t<F> t, u;
    // 3t - 2c or 3t + 2c into coefficient k
#define BLS_CYC(k, tv, sign)                  \
    f2_add(t, tv, tv);                        \
    f2_add(t, t, tv);                         \
    f2_add(u, f12_coeff(x, k), f12_coeff(x, k)); \
    if (sign) f2_add(f12_coeff(r, k), t, u);  \
    else f2_sub(f12_coeff(r, k), t, u);
    BLS_CYC(0, re[0], 0)
    BLS_CYC(3, im[0], 1)
    fp2_t<F> xic;
    f2_mul_xi(xic, im[2]);
    BLS_CYC(1, xic, 1)
    BLS_CYC(4, re[2], 0)
    BLS_CYC(2, re[1], 0)
    BLS_CYC(5, im[1], 1)
#undef BLS_CYC
}

// f^x for unitary f, x < 0: the conjugate of f^|x| (the 63 bits of |x|
// below its top one, rolled)
template <typename F>
BLS_NOINLINE void f12_pow_x(fp12_t<F> &r, const fp12_t<F> &f) {
    fp12_t<F> base = f, acc = f;
#pragma unroll 1
    for (int i = 62; i >= 0; --i) {
        f12_cyclotomic_sqr(acc, acc);
        if ((X_ABS >> i) & 1) f12_mul(acc, acc, base);
    }
    f12_conj(r, acc);
}

// The cube of the reduced pairing (consensus_specs_tpu/ops/bls12_jax.py:611):
// the easy part f^((p^6 - 1)(p^2 + 1)), then the hard part
// (x-1)^2 (x+p) (x^2+p^2-1) + 3 = 3 (p^4 - p^2 + 1)/r.
template <typename F>
BLS_NOINLINE void final_exponentiation(fp12_t<F> &r, const fp12_t<F> &m) {
    fp12_t<F> f, t, a, b, c, x;
    f12_conj(t, m);
    f12_inv(f, m);
    f12_mul(f, t, f);
    f12_frobenius2(t, f);
    f12_mul(f, t, f);
    f12_pow_x(x, f);
    f12_conj(t, f);
    f12_mul(a, x, t);  // f^(x-1)
    f12_pow_x(x, a);
    f12_conj(t, a);
    f12_mul(a, x, t);  // ^(x-1)^2
    f12_pow_x(x, a);
    f12_frobenius(t, a);
    f12_mul(b, x, t);  // ^(x+p)
    f12_pow_x(x, b);
    f12_pow_x(x, x);
    f12_frobenius2(t, b);
    f12_mul(c, x, t);
    f12_conj(t, b);
    f12_mul(c, c, t);  // ^(x^2+p^2-1)
    f12_sqr(t, f);
    f12_mul(t, t, f);
    f12_mul(r, c, t);
}
