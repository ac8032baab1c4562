// The four-lane G1 group: one G1 point on four lanes of a warp, for K14's
// subgroup check chain (csrc/curve.cuh `jac_in_g1`, csrc/msm.cu), K13's
// tables, window sums and tail (csrc/msm.cu) and K10's limb G1 sums
// (csrc/rlc.cu: block_tree_sum's adds, then jac_to_affine).
//
// The chain is 136 point operations in one dependency line, so one thread a
// key runs at one thread's latency: 1,051 Fp products in sequence, each a
// CIOS of about 1,170 instructions whose carries chain too. A committee of
// 512 keys fills 16 warps of the card's 528 schedulers. The group shortens
// the line: every lane holds the whole point (the element `v` is the same on
// the group's four lanes), and the independent products of a double or an
// add run side by side, one on each lane, with the unchanged one-thread
// `fp_mul` (csrc/fp.cuh) given the lane's operands by pointer (no operand is
// copied to pick it), after which each lane reads the others' products by
// __shfl_sync (twelve words a product, lanes of the group only). A double
// (7 products) takes 3 products' time, a complete add (16) takes 5:
//   double  {X^2, Y^2, YZ} {XB, B^2, E^2} {E(D - X3)}
//   add     {Z1^2, Z2^2, Z1Z2} {X1Z2^2, X2Z1^2, Z2^3, Z1^3}
//           {Y1Z2^3, Y2Z1^3, H^2, Z1Z2H} {R^2, H^3, U1H^2} {R(V - X3), S1H^3}
// so the chain's 1,051 products take 437 products' time (126 x 3 + 10 x 5,
// and the compare's 9 on every lane alike), plus the shuffles: 12 a product
// read, a few dozen cycles a step against a product's few thousand. The
// formulas and their case selects are the one-thread functions' (curve.cuh),
// so the group computes their words.
//
// Branches: every lane of a group holds the same values, so a test on them
// (Z = 0, H = 0, R = 0) goes the same way on the group's four lanes; groups
// of one warp may part, so each shuffle names its group's mask alone.
// A kernel over fp_g4 runs blockDim.x / 4 keys a block, a key on lanes
// 4k .. 4k + 3.
#pragma once
#include "curve.cuh"

struct fp_g4 {
    fp v;  // the element, the same on the group's four lanes
    static constexpr int LANES = 4;   // threads an element
    static constexpr int WORDS = 12;  // words an element in memory
};

BLS_INLINE int g4_lane() { return threadIdx.x & 3; }

BLS_INLINE unsigned g4_mask() { return 0xfu << (threadIdx.x & 28); }

// the field on the group's shared value: every lane computes it alike
BLS_INLINE void fp_set_zero(fp_g4 &r) { fp_set_zero(r.v); }
BLS_INLINE void fp_set_one(fp_g4 &r) { fp_set_one(r.v); }
BLS_INLINE bool fp_is_zero(const fp_g4 &a) { return fp_is_zero(a.v); }
BLS_INLINE void fp_add(fp_g4 &r, const fp_g4 &a, const fp_g4 &b) { fp_add(r.v, a.v, b.v); }
BLS_INLINE void fp_sub(fp_g4 &r, const fp_g4 &a, const fp_g4 &b) { fp_sub(r.v, a.v, b.v); }
BLS_INLINE void fp_mul(fp_g4 &r, const fp_g4 &a, const fp_g4 &b) { fp_mul(r.v, a.v, b.v); }
BLS_INLINE void fp_load(fp_g4 &x, const uint32_t *p) { fp_load(x.v, p); }
BLS_INLINE void fp_store(uint32_t *p, const fp_g4 &x) { fp_store(p, x.v); }
BLS_INLINE void field_prologue(fp_g4 *) {}
// every lane inverts the shared value alike (branch-free, csrc/fp.cuh)
BLS_INLINE void fp_inv(fp_g4 &r, const fp_g4 &a) { fp_inv(r.v, a.v); }

// the value x of lane `src` of this lane's group
BLS_INLINE void g4_read(fp &r, const fp &x, int src) {
    const unsigned mask = g4_mask();
#pragma unroll
    for (int j = 0; j < 12; ++j) r.w[j] = __shfl_sync(mask, x.w[j], src, 4);
}

// N products side by side: lane k computes *a[k]·*b[k] (lanes k >= N repeat
// lane 0's), its operands picked by pointer, then every lane reads product
// j into *out[j]
template <int N>
BLS_INLINE void g4_products(fp *const (&out)[N], const fp *const (&a)[N],
                            const fp *const (&b)[N]) {
    const int k = g4_lane() < N ? g4_lane() : 0;
    fp m;
    fp_mul(m, *a[k], *b[k]);
#pragma unroll
    for (int j = 0; j < N; ++j) g4_read(*out[j], m, j);
}

// curve.cuh's jac_double, its 7 products in 3 steps
BLS_NOINLINE void jac_double(jac<fp_g4> &r, const jac<fp_g4> &p) {
    const fp &X = p.x.v, &Y = p.y.v, &Z = p.z.v;
    fp A, B, YZ, XB, C, EE, E, D, X3, Y3, Z3, t;
    g4_products<3>({&A, &B, &YZ}, {&X, &Y, &Y}, {&X, &Y, &Z});
    fp_add(E, A, A);
    fp_add(E, E, A);
    fp_add(Z3, YZ, YZ);
    g4_products<3>({&XB, &C, &EE}, {&X, &B, &E}, {&B, &B, &E});
    fp_add(D, XB, XB);
    fp_add(D, D, D);
    fp_add(t, D, D);
    fp_sub(X3, EE, t);
    fp_sub(t, D, X3);
    fp_mul(Y3, E, t);
    fp_add(C, C, C);
    fp_add(C, C, C);
    fp_add(C, C, C);
    fp_sub(Y3, Y3, C);
    r.x.v = X3;
    r.y.v = Y3;
    r.z.v = Z3;
}

// curve.cuh's complete jac_add, its 16 products in 5 steps, the same case
// selects: Z1 = 0 gives p2, else Z2 = 0 gives p1; equal points double p1;
// opposite points keep X3, Y3 with Z = 0
BLS_NOINLINE void jac_add(jac<fp_g4> &r, const jac<fp_g4> &p1, const jac<fp_g4> &p2) {
    if (fp_is_zero(p1.z.v)) {
        r = p2;
        return;
    }
    if (fp_is_zero(p2.z.v)) {
        r = p1;
        return;
    }
    const fp &X1 = p1.x.v, &Y1 = p1.y.v, &Z1 = p1.z.v;
    const fp &X2 = p2.x.v, &Y2 = p2.y.v, &Z2 = p2.z.v;
    fp Z1sq, Z2sq, Z1Z2, U1, U2, Z2cu, Z1cu, S1, S2, H, R, Hsq, Z3, Rsq, Hcu, V, X3, Y3, S1Hcu,
        t;
    g4_products<3>({&Z1sq, &Z2sq, &Z1Z2}, {&Z1, &Z2, &Z1}, {&Z1, &Z2, &Z2});
    g4_products<4>({&U1, &U2, &Z2cu, &Z1cu}, {&X1, &X2, &Z2, &Z1}, {&Z2sq, &Z1sq, &Z2sq, &Z1sq});
    fp_sub(H, U2, U1);
    g4_products<4>({&S1, &S2, &Hsq, &Z3}, {&Y1, &Y2, &H, &Z1Z2}, {&Z2cu, &Z1cu, &H, &H});
    fp_sub(R, S2, S1);
    g4_products<3>({&Rsq, &Hcu, &V}, {&R, &H, &U1}, {&R, &Hsq, &Hsq});
    fp_sub(X3, Rsq, Hcu);
    fp_add(t, V, V);
    fp_sub(X3, X3, t);
    fp_sub(t, V, X3);
    g4_products<2>({&Y3, &S1Hcu}, {&R, &S1}, {&t, &Hcu});
    fp_sub(Y3, Y3, S1Hcu);
    if (fp_is_zero(H)) {
        if (fp_is_zero(R)) {  // equal points
            jac_double(r, p1);
            return;
        }
        fp_set_zero(Z3);  // opposite points: infinity
    }
    r.x.v = X3;
    r.y.v = Y3;
    r.z.v = Z3;
}
