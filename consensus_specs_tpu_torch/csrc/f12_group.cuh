// K12's unit group: one final exponentiation, and one Fp12 product of the
// tree of K12's tail and K25, on a group of G units, a unit being a thread
// (limb, csrc/fp.cuh) or a warp (RNS, csrc/fp_rns.cuh). Only csrc/pairing.cu
// includes it.
//
// In one unit the exponentiation is about 9,300 Fp products in one line
// (7,965 of them the hard part's five f^x, each 63 cyclotomic squarings of
// 21 products and 5 Fp12 products of 54), at one unit's latency: 22.6 ms
// under limb, 21.0 under RNS, on an H100. Inside a cyclotomic squaring the
// 21 products are independent once their operands' sums are formed, and so
// are the 54 of an Fp12 product. Here every unit of the group holds the
// whole Fp12 (as csrc/g1_lanes.cuh holds a point), the products of one
// squaring or Fp12 product go out one to a unit, G at a time, each unit
// forming its product's operand sums itself, and the units exchange the
// products through shared memory. The combine is spread the same way: each
// output Fp (an Fp6 product's coefficient, a result's coefficient) goes to
// one unit, which runs the one-unit formula's sums for it from the
// exchanged products, and the outputs are exchanged in turn. So a
// cyclotomic squaring takes ceil(21/G) products' time and two short
// stages, an Fp12 product ceil(54/G) and three. The Fp12 squaring and the
// Frobenius maps run on the group too; the Fp12 inverse (one Fp inverse
// and about 100 products, once an exponentiation) runs on every unit alike
// with the one-unit tower.cuh f12_inv.
//
// The formulas are the one-unit ones (csrc/tower.cuh f2_mul, f2_sqr, f6_mul,
// f12_sqr; the Fp12 product, Frobenius maps and Granger-Scott squaring as
// ops/bls12.py's plain versions write them): every product has the same
// operands, formed by the same sums, and every output the same sums of the
// same products. Limb
// values are canonical anyway; RNS residues depend on every product's
// inputs, so this is what keeps the RNS instance bit-equal to ops/bls12.py
// `final_exponentiation_limbs` over RNS.
//
// The group, by field:
// - limb: G = 32, the lanes of a warp. A lane's job picks its operands by
//   pointer, so the lanes run one instruction stream (the one-thread
//   fp_mul) on 32 products; __syncwarp orders the exchange. A squaring
//   takes one product's time, an Fp12 product two. 32 lanes ran the tail
//   at B = 257 faster than 16 and 16 faster than 8 (PERF.md).
// - RNS: G = 8 warps of a block (the block is the group: `index` is 0 and
//   `sync` is __syncthreads, so a block holds one group): a warp's job is
//   one warp-wide product. A squaring takes 3 products' time, an Fp12
//   product 7.
// Branches inside a job or an output stage would part a limb group's lanes,
// so each runs every sum its kind might need and selects: the code is
// branch-free over the unit's rank. The exchange holds 72 Fp a group (54
// products and 18 outputs): 3,456 bytes (limb), 18,432 (RNS).
#pragma once
#include "tower.cuh"
#include "unit_group.cuh"

// K12's group by field (csrc/unit_group.cuh)
template <typename F>
struct fe_group;
template <>
struct fe_group<fp> {
    using type = lanes<32>;  // the 32 lanes of a warp
};
template <>
struct fe_group<rns_w> {
    using type = warps<8, 1>;  // the 8 warps of a block
};

// threads of one group, and int32 words of one group's exchange
template <typename F>
__host__ __device__ constexpr int group_threads() {
    return fe_group<F>::type::SIZE * F::LANES;
}
template <typename F>
__host__ __device__ constexpr int group_words() {
    return 72 * F::WORDS;
}

// --- Fp2 sums inline (the same Fp sums as tower.cuh's f2_add, f2_sub,
// f2_mul_xi) -------------------------------------------------------------------

template <typename F>
BLS_INLINE void g2_add(fp2_t<F> &r, const fp2_t<F> &x, const fp2_t<F> &y) {
    fp_add(r.c0, x.c0, y.c0);
    fp_add(r.c1, x.c1, y.c1);
}

template <typename F>
BLS_INLINE void g2_sub(fp2_t<F> &r, const fp2_t<F> &x, const fp2_t<F> &y) {
    fp_sub(r.c0, x.c0, y.c0);
    fp_sub(r.c1, x.c1, y.c1);
}

template <typename F>
BLS_INLINE void g2_mul_xi(fp2_t<F> &r, const fp2_t<F> &x) {
    F a, b;
    fp_sub(a, x.c0, x.c1);
    fp_add(b, x.c0, x.c1);
    r.c0 = a;
    r.c1 = b;
}

// product k of the exchange
template <typename F>
BLS_INLINE void xget(F &r, const uint32_t *buf, int k) {
    fp_load(r, buf + k * F::WORDS);
}

// Run jobs 0 .. N-1 on the group: unit `rank` takes jobs rank, rank + G,
// ...; job(k, m) computes product k into m. Every unit runs the same number
// of steps (a unit past N repeats job N - 1 and keeps nothing), so the lanes
// of a limb group stay on one instruction stream. Returns with every
// product in buf.
template <typename F, typename Grp, int N, typename Job>
BLS_INLINE void group_products(uint32_t *buf, Job job) {
    constexpr int G = Grp::SIZE;
    Grp::sync();  // the previous exchange has been read
#pragma unroll 1
    for (int s = 0; s < (N + G - 1) / G; ++s) {
        const int k = Grp::rank() + s * G;
        F m;
        job(k < N ? k : N - 1, m);
        if (k < N) fp_store(buf + k * F::WORDS, m);
    }
    Grp::sync();
}

// --- the Fp12 product -----------------------------------------------------------
//
// Job k = 18·i + 3·j + l: Fp6 product i of f12_mul (x.a·y.a, x.b·y.b,
// (x.a + x.b)(y.a + y.b)), its Fp2 product j of f6_mul (c0c0, c1c1, c2c2,
// (c1 + c2)(..), (c0 + c1)(..), (c0 + c2)(..)), its Fp product l of f2_mul
// (ac, bd, (a + b)(c + d)).

// one side's operand of job k = 18·i + 3·j + l of Fp6 products whose i-th
// factor on this side is *X[i]; s0, s1, t: this unit's sums
template <typename F>
BLS_INLINE const F *f6_operand(const fp6_t<F> *const *X, int k, F &s0, F &s1, F &t) {
    const int i = k / 18, j = (k / 3) % 6, l = k % 3;
    const fp6_t<F> *Xi = X[i];
    const int p = j < 3 ? j : (j == 3 ? 1 : 0), q = j < 3 ? j : (j == 4 ? 1 : 2);
    fp_add(s0, Xi->c[p].c0, Xi->c[q].c0);
    fp_add(s1, Xi->c[p].c1, Xi->c[q].c1);
    const F *c0 = j < 3 ? &Xi->c[j].c0 : &s0;
    const F *c1 = j < 3 ? &Xi->c[j].c1 : &s1;
    fp_add(t, *c0, *c1);
    return l == 0 ? c0 : l == 1 ? c1 : &t;
}

// the group's N/18 Fp6 products X[i]·Y[i] (f6_mul's 18 Fp products each),
// into slots 0 .. N-1
template <typename F, typename Grp, int N>
BLS_INLINE void f6_products(const fp6_t<F> *const *X, const fp6_t<F> *const *Y,
                            uint32_t *buf) {
    group_products<F, Grp, N>(buf, [&](int k, F &m) {
        F s0, s1, t, u0, u1, v;
        const F *a = f6_operand(X, k, s0, s1, t);
        const F *b = f6_operand(Y, k, u0, u1, v);
        fp_mul(m, *a, *b);
    });
}

// Run outputs 0 .. N-1 on the group as group_products runs jobs: out(o, m)
// computes Fp output o into m, kept at slot `slot0 + o` of buf. Returns
// with every output in buf. The caller makes sure no unit still reads
// those slots.
template <typename F, typename Grp, int N, typename Out>
BLS_INLINE void group_outputs(uint32_t *buf, int slot0, Out out) {
    constexpr int G = Grp::SIZE;
#pragma unroll 1
    for (int s = 0; s < (N + G - 1) / G; ++s) {
        const int o = Grp::rank() + s * G;
        F m;
        out(o < N ? o : N - 1, m);
        if (o < N) fp_store(buf + (slot0 + o) * F::WORDS, m);
    }
    Grp::sync();
}

// Fp2 product j of the exchange: ac - bd, (a + b)(c + d) - ac - bd
template <typename F>
BLS_INLINE void f2_from_products(fp2_t<F> &r, const uint32_t *buf, int j) {
    F ac, bd, t;
    xget(ac, buf, 3 * j);
    xget(bd, buf, 3 * j + 1);
    xget(t, buf, 3 * j + 2);
    fp_sub(t, t, ac);
    fp_sub(r.c1, t, bd);
    fp_sub(r.c0, ac, bd);
}

// Component c of coefficient n of Fp6 product i, f6_mul's combine from the
// exchange's Fp2 products t0, t1, t2 and m = (c1 + c2)(..), (c0 + c1)(..),
// (c0 + c2)(..) for n = 0, 1, 2:
//   c0 = t0 + xi(m - (t1 + t2)), c1 = (m - (t0 + t1)) + xi t2,
//   c2 = (m - (t0 + t2)) + t1;
// every unit runs every sum (the same instruction stream) and keeps its own.
template <typename F>
BLS_INLINE void f6_coeff_from_products(F &out, const uint32_t *buf, int i, int n, int c) {
    fp2_t<F> t0, t1, t2, m, u, s, xs, xt;
    f2_from_products(t0, buf, 6 * i);
    f2_from_products(t1, buf, 6 * i + 1);
    f2_from_products(t2, buf, 6 * i + 2);
    f2_from_products(m, buf, 6 * i + 3 + n);
    g2_add(u, n == 0 ? t1 : t0, n == 2 ? t2 : (n == 0 ? t2 : t1));
    g2_sub(s, m, u);
    g2_mul_xi(xs, s);
    g2_mul_xi(xt, t2);
    const fp2_t<F> &p = n == 0 ? t0 : s;
    const fp2_t<F> &q = n == 0 ? xs : (n == 1 ? xt : t1);
    fp_add(out, c ? p.c1 : p.c0, c ? q.c1 : q.c0);
}

// r = x·y (tower.cuh f12_mul) on the group; r may alias x or y. The 54
// products (slots 0..53), then the 18 Fp of the three Fp6 products a unit
// each (slots 54..71), then the 12 Fp of the result a unit each (slots
// 0..11, the products read by then):
// a0 b0 + v a1 b1 + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) w
template <typename F, typename Grp>
BLS_NOINLINE void g_f12_mul(fp12_t<F> &r, const fp12_t<F> &x, const fp12_t<F> &y,
                            uint32_t *buf) {
    fp6_t<F> xs, ys;
    for (int k = 0; k < 3; ++k) {
        g2_add(xs.c[k], x.a.c[k], x.b.c[k]);
        g2_add(ys.c[k], y.a.c[k], y.b.c[k]);
    }
    const fp6_t<F> *X[3] = {&x.a, &x.b, &xs}, *Y[3] = {&y.a, &y.b, &ys};
    f6_products<F, Grp, 54>(X, Y, buf);
    // slot 54 + 6i + 2n + c: component c of coefficient n of Fp6 product i
    group_outputs<F, Grp, 18>(buf, 54, [&](int o, F &m) {
        f6_coeff_from_products(m, buf, o / 6, (o % 6) / 2, o % 2);
    });
    // output 6h + 2j + c: component c of coefficient j of r.a (h = 0), t0 +
    // v·t1, or of r.b (h = 1), s - (t0 + t1); t0, t1, s the Fp6 products
    group_outputs<F, Grp, 12>(buf, 0, [&](int o, F &m) {
        const int h = o / 6, j = (o % 6) / 2, c = o % 2;
        const uint32_t *t6 = buf + 54 * F::WORDS;
        fp2_t<F> t1v, xq;
        F t0c, t1c, sc, sum, u, diff;
        xget(t0c, t6, 2 * j + c);
        xget(t1c, t6, 6 + 2 * j + c);
        xget(sc, t6, 12 + 2 * j + c);
        xget(t1v.c0, t6, 6 + 2 * ((j + 2) % 3));  // v·t1 = (xi t1[2], t1[0], t1[1])
        xget(t1v.c1, t6, 6 + 2 * ((j + 2) % 3) + 1);
        g2_mul_xi(xq, t1v);
        const fp2_t<F> &q = j == 0 ? xq : t1v;
        fp_add(sum, t0c, c ? q.c1 : q.c0);
        fp_add(u, t0c, t1c);
        fp_sub(diff, sc, u);
        m = h ? diff : sum;
    });
    for (int j = 0; j < 3; ++j) {
        xget(r.a.c[j].c0, buf, 2 * j);
        xget(r.a.c[j].c1, buf, 2 * j + 1);
        xget(r.b.c[j].c0, buf, 6 + 2 * j);
        xget(r.b.c[j].c1, buf, 6 + 2 * j + 1);
    }
}

// r = x^2 (tower.cuh f12_sqr) on the group: (a + b w)^2 = (a + b)(a + v b)
// - ab - v ab + 2ab w, the Fp6 products t = ab and s·u = (a + b)(a + v b)
// (slots 0..35), their 12 Fp (slots 54..65), then the result's 12 (slots
// 0..11). r may alias x.
template <typename F, typename Grp>
BLS_NOINLINE void g_f12_sqr(fp12_t<F> &r, const fp12_t<F> &x, uint32_t *buf) {
    fp6_t<F> s, u;
    fp2_t<F> xb;
    g2_mul_xi(xb, x.b.c[2]);  // v·b = (xi b2, b0, b1)
    for (int k = 0; k < 3; ++k) {
        g2_add(s.c[k], x.a.c[k], x.b.c[k]);
        g2_add(u.c[k], x.a.c[k], k == 0 ? xb : x.b.c[k - 1]);
    }
    const fp6_t<F> *X[2] = {&x.a, &s}, *Y[2] = {&x.b, &u};
    f6_products<F, Grp, 36>(X, Y, buf);
    group_outputs<F, Grp, 12>(buf, 54, [&](int o, F &m) {
        f6_coeff_from_products(m, buf, o / 6, (o % 6) / 2, o % 2);
    });
    // output 6h + 2j + c: r.a = s·u - (t + v t) (h = 0), r.b = t + t (h = 1)
    group_outputs<F, Grp, 12>(buf, 0, [&](int o, F &m) {
        const int h = o / 6, j = (o % 6) / 2, c = o % 2;
        const uint32_t *t6 = buf + 54 * F::WORDS;
        fp2_t<F> tv, xq;
        F tc, sc, u2, diff, dbl;
        xget(tc, t6, 2 * j + c);
        xget(sc, t6, 6 + 2 * j + c);
        xget(tv.c0, t6, 2 * ((j + 2) % 3));  // v·t = (xi t[2], t[0], t[1])
        xget(tv.c1, t6, 2 * ((j + 2) % 3) + 1);
        g2_mul_xi(xq, tv);
        const fp2_t<F> &q = j == 0 ? xq : tv;
        fp_add(u2, tc, c ? q.c1 : q.c0);
        fp_sub(diff, sc, u2);
        fp_add(dbl, tc, tc);
        m = h ? dbl : diff;
    });
    for (int j = 0; j < 3; ++j) {
        xget(r.a.c[j].c0, buf, 2 * j);
        xget(r.a.c[j].c1, buf, 2 * j + 1);
        xget(r.b.c[j].c0, buf, 6 + 2 * j);
        xget(r.b.c[j].c1, buf, 6 + 2 * j + 1);
    }
}

// r = x^(p^e), e = 1 or 2 (tower.cuh f12_frobenius, f12_frobenius2) on the
// group: coefficient k times gamma_e^k, conjugated first for e = 1; the 18
// products of the six f2_mul (slots 0..17), then the 12 Fp (slots 18..29).
// r may alias x.
template <typename F, typename Grp>
BLS_NOINLINE void g_frobenius(fp12_t<F> &r, const fp12_t<F> &x, int e, uint32_t *buf) {
    group_products<F, Grp, 18>(buf, [&](int k, F &m) {
        const int c = k / 3, l = k % 3;
        const fp2_t<F> &xc = f12_coeff(x, c);
        fp2_t<F> g;
        f2_gamma(g, e, c);
        F n1, s, gs;
        fp_neg(n1, xc.c1);  // conj
        const F &a1 = e == 1 ? n1 : xc.c1;
        fp_add(s, xc.c0, a1);
        fp_add(gs, g.c0, g.c1);
        const F *a = l == 0 ? &xc.c0 : l == 1 ? &a1 : &s;
        const F *b = l == 0 ? &g.c0 : l == 1 ? &g.c1 : &gs;
        fp_mul(m, *a, *b);
    });
    group_outputs<F, Grp, 12>(buf, 18, [&](int o, F &m) {
        fp2_t<F> v;
        f2_from_products(v, buf, o / 2);
        m = (o % 2) ? v.c1 : v.c0;
    });
    for (int k = 0; k < 6; ++k) {
        xget(f12_coeff(r, k).c0, buf, 18 + 2 * k);
        xget(f12_coeff(r, k).c1, buf, 18 + 2 * k + 1);
    }
}

// --- the cyclotomic squaring ----------------------------------------------------
//
// Job k = 7·i + j for the Fp4 pair i (A = coefficient i, B = coefficient i +
// 3): j = 0, 1 f2_sqr(A) ((a0 + a1)(a0 - a1), (a0 + a0)·a1), j = 2, 3
// f2_sqr(B), j = 4, 5, 6 f2_mul(A, B) (a0 b0, a1 b1, (a0 + a1)(b0 + b1)).

template <typename F>
BLS_INLINE void cyc_product(const fp12_t<F> &x, int k, F &m) {
    const int i = k / 7, j = k % 7;
    const fp2_t<F> &A = f12_coeff(x, i);
    const fp2_t<F> &B = f12_coeff(x, i + 3);
    const fp2_t<F> *X = (j == 2 || j == 3) ? &B : &A;
    F s, d, t, s2;
    fp_add(s, X->c0, X->c1);
    fp_sub(d, X->c0, X->c1);
    fp_add(t, X->c0, X->c0);
    fp_add(s2, B.c0, B.c1);
    const bool sq0 = j == 0 || j == 2, sq1 = j == 1 || j == 3;
    const F *a = sq0 ? &s : sq1 ? &t : j == 4 ? &A.c0 : j == 5 ? &A.c1 : &s;
    const F *b = sq0 ? &d : sq1 ? &X->c1 : j == 4 ? &B.c0 : j == 5 ? &B.c1 : &s2;
    fp_mul(m, *a, *b);
}

// Component c of coefficient k of the squaring, from the exchange: with
// (a + b s)^2 = (a^2 + xi b^2) + 2ab s for the pair i, re = a^2 + xi b^2,
// im = 2ab, coefficient k is 3t - 2 conj(x_k) or 3t + 2 conj(x_k)
// (tower.cuh's BLS_CYC) with t = re_0, xi im_2, re_1, im_0, re_2, im_1 for
// k = 0..5.
template <typename F>
BLS_INLINE void cyc_output(const fp12_t<F> &x, const uint32_t *buf, int k, int c, F &m) {
    const int i = (k == 0 || k == 3) ? 0 : (k == 2 || k == 5) ? 1 : 2;
    const uint32_t *p = buf + 7 * i * F::WORDS;
    F a2c0, a2c1, b2c0, b2c1, ac, bd, st, im0, im1, t, bx0, bx1, re0, re1, xi0, xi1;
    xget(a2c0, p, 0);
    xget(a2c1, p, 1);
    xget(b2c0, p, 2);
    xget(b2c1, p, 3);
    xget(ac, p, 4);
    xget(bd, p, 5);
    xget(st, p, 6);
    fp_sub(im0, ac, bd);  // ab = (ac - bd, (st - ac) - bd), im = ab + ab
    fp_sub(t, st, ac);
    fp_sub(im1, t, bd);
    fp_add(im0, im0, im0);
    fp_add(im1, im1, im1);
    fp_sub(bx0, b2c0, b2c1);  // xi b^2
    fp_add(bx1, b2c0, b2c1);
    fp_add(re0, a2c0, bx0);
    fp_add(re1, a2c1, bx1);
    fp_sub(xi0, im0, im1);  // xi im (coefficient 1)
    fp_add(xi1, im0, im1);
    const bool re = k == 0 || k == 2 || k == 4;
    const F *tv = re ? (c ? &re1 : &re0) : k == 1 ? (c ? &xi1 : &xi0) : (c ? &im1 : &im0);
    const F &xc = c ? f12_coeff(x, k).c1 : f12_coeff(x, k).c0;
    F t3, u, sum, diff;
    fp_add(t3, *tv, *tv);
    fp_add(t3, t3, *tv);
    fp_add(u, xc, xc);
    fp_add(sum, t3, u);
    fp_sub(diff, t3, u);
    m = (k & 1) ? sum : diff;
}

// Granger-Scott squaring of a unitary f on the group (csrc/tower.cuh's
// formulas, f12_cyclotomic_sqr of the one-unit code): with s = w^3 and
// f = A + B w + C w^2 over Fp4 = Fp2[s], A = (c0, c3), B = (c1, c4),
// C = (c2, c5), f^2 = (3A^2 - 2 conj A) + (3 s C^2 + 2 conj B) w +
// (3B^2 - 2 conj C) w^2. The 21 products, then the 12 Fp of the result a
// unit each (slots 21..32). r may alias f.
template <typename F, typename Grp>
BLS_NOINLINE void g_cyclotomic_sqr(fp12_t<F> &r, const fp12_t<F> &f, uint32_t *buf) {
    group_products<F, Grp, 21>(buf, [&](int k, F &m) { cyc_product(f, k, m); });
    group_outputs<F, Grp, 12>(buf, 21, [&](int o, F &m) { cyc_output(f, buf, o / 2, o % 2, m); });
    for (int k = 0; k < 6; ++k) {
        xget(f12_coeff(r, k).c0, buf, 21 + 2 * k);
        xget(f12_coeff(r, k).c1, buf, 21 + 2 * k + 1);
    }
}

// --- the exponentiation ------------------------------------------------------------

// f^x for unitary f, x < 0: the conjugate of f^|x| (the 63 bits of |x|
// below its top one, rolled)
template <typename F, typename Grp>
BLS_NOINLINE void g_f12_pow_x(fp12_t<F> &r, const fp12_t<F> &f, uint32_t *buf) {
    fp12_t<F> acc = f;
#pragma unroll 1
    for (int i = 62; i >= 0; --i) {
        g_cyclotomic_sqr<F, Grp>(acc, acc, buf);
        if ((X_ABS >> i) & 1) g_f12_mul<F, Grp>(acc, acc, f, buf);
    }
    f12_conj(r, acc);
}

// The cube of the reduced pairing (consensus_specs_tpu/ops/bls12_jax.py:611)
// on the group: the easy part f^((p^6 - 1)(p^2 + 1)), then the hard part
// (x-1)^2 (x+p) (x^2+p^2-1) + 3 = 3 (p^4 - p^2 + 1)/r. Every unit of the
// group calls it and ends with the result.
template <typename F, typename Grp>
BLS_NOINLINE void g_final_exponentiation(fp12_t<F> &r, const fp12_t<F> &m, uint32_t *buf) {
    fp12_t<F> f, t, a, b, c, x;
    f12_conj(t, m);
    f12_inv(f, m);
    g_f12_mul<F, Grp>(f, t, f, buf);
    g_frobenius<F, Grp>(t, f, 2, buf);
    g_f12_mul<F, Grp>(f, t, f, buf);
    g_f12_pow_x<F, Grp>(x, f, buf);
    f12_conj(t, f);
    g_f12_mul<F, Grp>(a, x, t, buf);  // f^(x-1)
    g_f12_pow_x<F, Grp>(x, a, buf);
    f12_conj(t, a);
    g_f12_mul<F, Grp>(a, x, t, buf);  // ^(x-1)^2
    g_f12_pow_x<F, Grp>(x, a, buf);
    g_frobenius<F, Grp>(t, a, 1, buf);
    g_f12_mul<F, Grp>(b, x, t, buf);  // ^(x+p)
    g_f12_pow_x<F, Grp>(x, b, buf);
    g_f12_pow_x<F, Grp>(x, x, buf);
    g_frobenius<F, Grp>(t, b, 2, buf);
    g_f12_mul<F, Grp>(c, x, t, buf);
    f12_conj(t, b);
    g_f12_mul<F, Grp>(c, c, t, buf);  // ^(x^2+p^2-1)
    g_f12_sqr<F, Grp>(t, f, buf);
    g_f12_mul<F, Grp>(t, t, f, buf);
    g_f12_mul<F, Grp>(r, c, t, buf);
}
