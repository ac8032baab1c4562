// G1 (over Fp) and G2 (on the twist, over Fp2) in Jacobian coordinates, one
// template for both and for either base field (one thread a point over the
// limb field, one warp over RNS): BLS12-381 and its twist both have a = 0,
// and b never enters the add or double formulas.
//
// Replaces consensus_specs_tpu/ops/bls12_jax.py `g1_double` :641, `g1_add`
// :661, `g2_double`/`g2_add` :892-956, `g1_scalar_mul_batch` :782 and
// `g2_scalar_mul_batch` :957 (2-bit windows; also the r-ladder of
// `_g1_subgroup_program` :1347), `_g1_jacobian_to_affine_batch`
// :868, `g2_jacobian_to_affine` :1043. The formulas are JAX's. Its complete
// add selects among the cases with masks; here the thread branches on them
// exactly as the selects decide: Z1 = 0 gives p2, else Z2 = 0 gives p1;
// equal points (H = r = 0) give the double of p1; opposite points (H = 0,
// r != 0) keep the add's X and Y with Z = 0. The window gathers reach all of
// them (digit 0 is the point at infinity). Under the RNS field every such
// test is a warp-wide vote (fp_rns.cuh), so the branches stay uniform.
#pragma once
#include "tower.cuh"

template <typename F>
struct jac {
    F x, y, z;
};

// the field's operations under one name: a base field (fp, rns_w) or Fp2
// over it
template <typename F>
BLS_INLINE void fmul(F &r, const F &a, const F &b) { fp_mul(r, a, b); }
template <typename F>
BLS_INLINE void fmul(fp2_t<F> &r, const fp2_t<F> &a, const fp2_t<F> &b) { f2_mul(r, a, b); }
template <typename F>
BLS_INLINE void fsqr(F &r, const F &a) { fp_mul(r, a, a); }
template <typename F>
BLS_INLINE void fsqr(fp2_t<F> &r, const fp2_t<F> &a) { f2_sqr(r, a); }
template <typename F>
BLS_INLINE void fadd(F &r, const F &a, const F &b) { fp_add(r, a, b); }
template <typename F>
BLS_INLINE void fadd(fp2_t<F> &r, const fp2_t<F> &a, const fp2_t<F> &b) { f2_add(r, a, b); }
template <typename F>
BLS_INLINE void fsub(F &r, const F &a, const F &b) { fp_sub(r, a, b); }
template <typename F>
BLS_INLINE void fsub(fp2_t<F> &r, const fp2_t<F> &a, const fp2_t<F> &b) { f2_sub(r, a, b); }
template <typename F>
BLS_INLINE void finv(F &r, const F &a) { fp_inv(r, a); }
template <typename F>
BLS_INLINE void finv(fp2_t<F> &r, const fp2_t<F> &a) { f2_inv(r, a); }
template <typename F>
BLS_INLINE bool fis_zero(const F &a) { return fp_is_zero(a); }
template <typename F>
BLS_INLINE bool fis_zero(const fp2_t<F> &a) { return f2_is_zero(a); }
template <typename F>
BLS_INLINE void fset_zero(F &r) { fp_set_zero(r); }
template <typename F>
BLS_INLINE void fset_zero(fp2_t<F> &r) { f2_set_zero(r); }
template <typename F>
BLS_INLINE void fset_one(F &r) { fp_set_one(r); }
template <typename F>
BLS_INLINE void fset_one(fp2_t<F> &r) { f2_set_one(r); }
template <typename F>
BLS_INLINE void fload(F &r, const uint32_t *p) { fp_load(r, p); }
template <typename F>
BLS_INLINE void fload(fp2_t<F> &r, const uint32_t *p) {
    fp_load(r.c0, p);
    fp_load(r.c1, p + F::WORDS);
}
template <typename F>
BLS_INLINE void fstore(uint32_t *p, const F &x) { fp_store(p, x); }
template <typename F>
BLS_INLINE void fstore(uint32_t *p, const fp2_t<F> &x) {
    fp_store(p, x.c0);
    fp_store(p + F::WORDS, x.c1);
}

// threads a block of one-item units: 64 threads over the limb field, four
// warps over RNS (K9, K11, K12's batch mode)
template <typename B>
__host__ __device__ constexpr int item_threads() {
    return B::LANES == 1 ? 64 : 4 * B::LANES;
}

template <typename F>
BLS_INLINE void jac_set_inf(jac<F> &r) {
    fset_zero(r.x);
    fset_zero(r.y);
    fset_zero(r.z);
}

// A = X^2, B = Y^2, C = B^2, D = 4XB, E = 3A; X3 = E^2 - 2D,
// Y3 = E(D - X3) - 8C, Z3 = 2YZ (Z = 0 stays 0)
template <typename F>
BLS_NOINLINE void jac_double(jac<F> &r, const jac<F> &p) {
    F A, B, C, D, E, X3, Y3, Z3, t;
    fsqr(A, p.x);
    fsqr(B, p.y);
    fmul(D, p.x, B);
    fmul(Z3, p.y, p.z);
    fmul(C, B, B);
    fadd(D, D, D);
    fadd(D, D, D);
    fadd(E, A, A);
    fadd(E, E, A);
    fsqr(X3, E);
    fadd(t, D, D);
    fsub(X3, X3, t);
    fsub(t, D, X3);
    fmul(Y3, E, t);
    fadd(C, C, C);
    fadd(C, C, C);
    fadd(C, C, C);
    fsub(Y3, Y3, C);
    fadd(Z3, Z3, Z3);
    r.x = X3;
    r.y = Y3;
    r.z = Z3;
}

template <typename F>
BLS_NOINLINE void jac_add(jac<F> &r, const jac<F> &p1, const jac<F> &p2) {
    if (fis_zero(p1.z)) {
        r = p2;
        return;
    }
    if (fis_zero(p2.z)) {
        r = p1;
        return;
    }
    F Z1sq, Z2sq, U1, U2, Z1cu, Z2cu, S1, S2, H, R, Hsq, Rsq, Hcu, V, Z1Z2, X3, Y3, t;
    fsqr(Z1sq, p1.z);
    fsqr(Z2sq, p2.z);
    fmul(U1, p1.x, Z2sq);
    fmul(U2, p2.x, Z1sq);
    fmul(Z2cu, p2.z, Z2sq);
    fmul(Z1cu, p1.z, Z1sq);
    fmul(S1, p1.y, Z2cu);
    fmul(S2, p2.y, Z1cu);
    fsub(H, U2, U1);
    fsub(R, S2, S1);
    fsqr(Hsq, H);
    fsqr(Rsq, R);
    fmul(Hcu, H, Hsq);
    fmul(V, U1, Hsq);
    fmul(Z1Z2, p1.z, p2.z);
    fsub(X3, Rsq, Hcu);
    fadd(t, V, V);
    fsub(X3, X3, t);
    fsub(t, V, X3);
    fmul(Y3, R, t);
    fmul(t, S1, Hcu);
    fsub(Y3, Y3, t);
    fmul(Z1Z2, Z1Z2, H);
    if (fis_zero(H)) {
        if (fis_zero(R)) {  // equal points
            jac_double(r, p1);
            return;
        }
        fset_zero(Z1Z2);  // opposite points: infinity
    }
    r.x = X3;
    r.y = Y3;
    r.z = Z1Z2;
}

// One block's sum of n entries (K10's segments, K13's windows) by units: a
// unit is a thread over the limb field, a warp over RNS (L threads). Unit u
// adds the entries i = u, u + U, ... (U = blockDim.x / L, a power of two),
// where `entry(i, e)` loads entry i into e and says whether it is there at
// all; then the U shares meet in a tree in the shared `part` (U points, each
// L lanes wide): at each level unit u < half takes unit u + half. Every
// thread returns with the sum in part[0 .. L).
template <typename F, typename Entry>
BLS_INLINE void block_tree_sum(jac<F> *part, long long n, Entry entry) {
    constexpr int L = lanes_of<F>::value;
    const int u = threadIdx.x / L, lane = threadIdx.x % L, units = blockDim.x / L;
    jac<F> acc, e;
    jac_set_inf(acc);
    for (long long i = u; i < n; i += units)
        if (entry(i, e)) jac_add(acc, acc, e);
    part[u * L + lane] = acc;
    __syncthreads();
    for (int half = units / 2; half > 0; half >>= 1) {
        if (u < half) jac_add(part[u * L + lane], part[u * L + lane], part[(u + half) * L + lane]);
        __syncthreads();
    }
}

// (X/Z^2, Y/Z^3); Z = 0 gives (0, 0)
template <typename F>
BLS_NOINLINE void jac_to_affine(F &x, F &y, const jac<F> &p) {
    F zinv, zinv2, t;
    finv(zinv, p.z);
    fsqr(zinv2, zinv);
    fmul(t, zinv, zinv2);
    fmul(x, p.x, zinv2);
    fmul(y, p.y, t);
}

// [z]·p with 2-bit windows over `nwin` windows of the little-endian words z
// (digit w is bits 2w and 2w + 1): the table [0, p, 2p, 3p], the top window's
// entry, then nwin - 1 times two doublings and one add of the window's entry.
// K9 runs it over 64-bit z (32 windows), K14 over r (255 bits, padded to 256:
// 128 windows), as JAX's g1_scalar_mul_batch pads an odd width.
template <typename F>
BLS_NOINLINE void jac_scalar_mul(jac<F> &r, const jac<F> &p, const uint32_t *z, int nwin) {
    jac<F> tab[4], acc;
    jac_set_inf(tab[0]);
    tab[1] = p;
    jac_double(tab[2], p);
    jac_add(tab[3], tab[2], p);
    int top = nwin - 1;
    acc = tab[(z[top >> 4] >> (2 * (top & 15))) & 3u];
#pragma unroll 1
    for (int w = top - 1; w >= 0; --w) {
        uint32_t d = (z[w >> 4] >> (2 * (w & 15))) & 3u;
        jac_double(acc, acc);
        jac_double(acc, acc);
        jac_add(acc, acc, tab[d]);
    }
    r = acc;
}
