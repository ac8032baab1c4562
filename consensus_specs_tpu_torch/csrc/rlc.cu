// The point work of the randomized batch check, templates over the base
// field: the limb field (csrc/fp.cuh) and the RNS field (csrc/fp_rns.cuh,
// `_rns` entry points).
//
// K9 rlc_ladders: per item [z]·pk over G1 and [z]·sig over G2 with 2-bit
// windows (64-bit z, 32 windows: curve.cuh's jac_scalar_mul), G1 and G2
// items of one launch in blocks of their own; the G1 result is made affine
// (ungrouped path) or kept Jacobian for K10 (grouped path). Replaces
// consensus_specs_tpu/ops/bls12_jax.py:782 `g1_scalar_mul_batch`, :957
// `g2_scalar_mul_batch`, :868 `_g1_jacobian_to_affine_batch`, and the
// ladders of :1157 `rlc_randomize_g1` and :1164 `rlc_collapse_g2`. A ladder
// runs on a group: limb G1 on four lanes (csrc/g1_lanes.cuh: a double in 3
// products' time, a complete add in 5, the affine step's divstep inverse on
// every lane alike), limb G2 on G2_LIMB_G lanes, RNS G1 on 4 warps and RNS
// G2 on 8 (csrc/bls_group.cuh: the double's and the add's Fp products go
// out a unit each, ops/bls12_programs.py `jac_dbl`, `jac_add`; the complete
// add's case selects are curve.cuh's, on tests every unit reads alike). One
// unit a ladder ran about 2,800 Fp products in one line (5.1 ms at N = 256
// on an H100, limb; 4.1 under RNS). The limb G2 group was timed on the card
// (PERF.md): 16 lanes ran the 256 G2 ladders in 1.23 ms, 8 lanes in 1.40,
// so it is 16. The RNS G1 ladder ends in a Fermat inverse on one warp (the
// residues follow that chain), about 0.8 of its 2.1 ms at N = 256.
//
// K10 point_sums: the affine sum of each segment [off[d], off[d+1]) of
// Jacobian points (segments in order, sorted by the caller). An empty
// segment sums to infinity and comes out (0, 0) (inv(0) = 0);
// `pairing_check_rlc` fails such a batch from the segment counts. G2 with
// one segment is the bilinearity collapse (:1014 + :1043), G1 with D
// segments the grouped path's sum by message (:1172, :1195) and, over one
// segment, the committee-key sum (`_g1_aggregate_program` :1339).
// - G1: one block a segment; each of its 64 units (16 warps under RNS)
//   adds a strided share, the shares meet in a tree in shared memory
//   (curve.cuh's block_tree_sum, which K13's window sums share), and the
//   sum is made affine. The limb unit is four lanes (F = fp_g4,
//   csrc/g1_lanes.cuh: a complete add's 16 products in 5 steps), 256
//   threads a block: a committee of 512 keys is 64 groups x 8 points, then a
//   6-level tree, and the divstep inverse (csrc/fp.cuh). The limb result
//   does not depend on the order of the adds (an affine sum has one
//   canonical encoding); the RNS order is the plain version's
//   (ops/bls12.py `segment_sums_limbs`), which its residues need.
// - G2 (`g2_sums_kernel`, both fields): `g2_sum_units(N)` units a segment,
//   each one of K9's G2 groups (its programs and case selects), over as
//   many blocks as they fill; the partials meet in shared memory, then
//   across blocks by tickets, and the last block makes the sum affine with
//   the affine step's products spread over its group. One block of 64
//   one-thread units (16 one-warp units under RNS) took 0.88 ms limb and
//   2.63 ms RNS at N = 256 on an H100 (PERF.md): one SM worked.
//
// Bound: operations (Fp products). A ladder is about 95 point operations of
// 7-45 products each; the card holds 16,896 lanes and the batches here are
// 256-2048 items, so both kernels are latency-bound far from the card's
// operation rate (chip_smoke.py reports the ratio); the groups shorten the
// lines.
#include <cuda_runtime.h>

#include <type_traits>

#include "bls_group.cuh"
#include "g1_lanes.cuh"
#include "stack.cuh"

// K9's geometry by field: limb blocks of 128 threads, a G1 ladder on four
// lanes (32 a block) or a G2 ladder on a G2_LIMB_G-lane group; RNS blocks of
// 256 threads (8 warps), two G1 ladders on 4 warps each or one G2 ladder on
// all 8. A block holds one kind, so no warp holds both.
template <typename B>
struct ladder_geom;
template <>
struct ladder_geom<fp> {
    static constexpr int THREADS = 128, G1_PER_BLOCK = THREADS / fp_g4::LANES,
                         G2_PER_BLOCK = THREADS / G2_LIMB_G;
    static constexpr int WORDS = G2_PER_BLOCK * G2_LIMB_SLOTS * 12;
    using G2 = lanes<G2_LIMB_G>;
};
template <>
struct ladder_geom<rns_w> {
    static constexpr int THREADS = 256, G1_PER_BLOCK = 8 / G1_RNS_G, G2_PER_BLOCK = 1;
    static constexpr int G1_WORDS = G1_PER_BLOCK * G1_RNS_SLOTS * RNS_N,
                         G2_WORDS = G2_RNS_SLOTS * RNS_N;
    static constexpr int WORDS = G1_WORDS > G2_WORDS ? G1_WORDS : G2_WORDS;
    using G1 = warps<G1_RNS_G, G1_PER_BLOCK>;
    using G2 = warps<G2_RNS_G, 1>;
    static_assert(G2_RNS_G == 8, "an RNS G2 ladder takes the block's 8 warps");
};

// the slots of a ladder (csrc/bls_programs.cuh): the accumulator A, the add's
// operand B and result C, H and R, the table's [1]P, [2]P, [3]P from T; NC
// Fp a coordinate, NP a point
template <bool G2>
struct curve_slots {
    static constexpr int NC = G2 ? 2 : 1, NP = 3 * NC;
    static constexpr int A = G2 ? CURVE2_A : CURVE1_A, B = G2 ? CURVE2_B : CURVE1_B,
                         C = G2 ? CURVE2_C : CURVE1_C, H = G2 ? CURVE2_H : CURVE1_H,
                         T = G2 ? CURVE2_T : CURVE1_T;
};

// the double (A = 2A) and the add's products (C, H, R from A and B) of a
// field and curve, on its group
template <typename B, bool G2>
struct curve_progs;
// (G2 also the affine step's two programs, K10's)
template <>
struct curve_progs<fp, true> {
    using Grp = ladder_geom<fp>::G2;
    static BLS_INLINE void dbl(uint32_t *v) { slp_run<fp, Grp>(PROG_G2_DBL_LIMB, v); }
    static BLS_INLINE void add(uint32_t *v) { slp_run<fp, Grp>(PROG_G2_ADD_LIMB, v); }
    static BLS_INLINE void aff_norm(uint32_t *v) { slp_run<fp, Grp>(PROG_G2_AFF_NORM_LIMB, v); }
    static BLS_INLINE void aff_out(uint32_t *v) { slp_run<fp, Grp>(PROG_G2_AFF_OUT_LIMB, v); }
};
template <>
struct curve_progs<rns_w, true> {
    using Grp = ladder_geom<rns_w>::G2;
    static BLS_INLINE void dbl(uint32_t *v) { slp_run<rns_w, Grp>(PROG_G2_DBL_RNS, v); }
    static BLS_INLINE void add(uint32_t *v) { slp_run<rns_w, Grp>(PROG_G2_ADD_RNS, v); }
    static BLS_INLINE void aff_norm(uint32_t *v) { slp_run<rns_w, Grp>(PROG_G2_AFF_NORM_RNS, v); }
    static BLS_INLINE void aff_out(uint32_t *v) { slp_run<rns_w, Grp>(PROG_G2_AFF_OUT_RNS, v); }
};
template <>
struct curve_progs<rns_w, false> {
    using Grp = ladder_geom<rns_w>::G1;
    static BLS_INLINE void dbl(uint32_t *v) { slp_run<rns_w, Grp>(PROG_G1_DBL_RNS, v); }
    static BLS_INLINE void add(uint32_t *v) { slp_run<rns_w, Grp>(PROG_G1_ADD_RNS, v); }
};

// A = A + B by the add's products where neither is infinity, then
// curve.cuh's jac_add's case selects on H and R: H = 0 doubles A where R = 0
// and gives (X3, Y3, 0) where not
template <typename B, bool G2>
BLS_INLINE void grp_add_core(uint32_t *vals, int *flags) {
    using S = curve_slots<G2>;
    using Pr = curve_progs<B, G2>;
    using Grp = typename Pr::Grp;
    const unsigned all = (1u << S::NC) - 1u;
    Pr::add(vals);
    const unsigned hr = grp_zero_mask<Grp>((B *)nullptr, vals, S::H, 2 * S::NC, flags);
    if ((hr & all) != all) {
        grp_copy<B, Grp>(vals, S::A, S::C, S::NP);
    } else if ((hr >> S::NC) == all) {
        Pr::dbl(vals);  // equal points
    } else {
        grp_copy<B, Grp>(vals, S::A, S::C, 2 * S::NC);  // opposite points: infinity
        grp_copy<B, Grp>(vals, S::A + 2 * S::NC, -1, S::NC);
    }
}

// A = A + [d]P (d = 0: infinity), curve.cuh's complete jac_add on the group
// with its case selects, every unit reading the same tests: A at infinity
// gives [d]P, [d]P at infinity (z2) gives A; else grp_add_core
template <typename B, bool G2>
BLS_INLINE void grp_add_table(uint32_t *vals, int *flags, int d, bool z2) {
    using S = curve_slots<G2>;
    using Grp = typename curve_progs<B, G2>::Grp;
    const unsigned all = (1u << S::NC) - 1u;
    const bool z1 = grp_zero_mask<Grp>((B *)nullptr, vals, S::A + 2 * S::NC, S::NC, flags) == all;
    if (d == 0) {
        if (z1) grp_copy<B, Grp>(vals, S::A, -1, S::NP);
        return;
    }
    const int t = S::T + (d - 1) * S::NP;
    if (z1) {
        grp_copy<B, Grp>(vals, S::A, t, S::NP);
        return;
    }
    if (z2) return;
    grp_copy<B, Grp>(vals, S::B, t, S::NP);
    grp_add_core<B, G2>(vals, flags);
}

// A = [z]P, P in the table's slots [1]P with Z = 1 (the caller's): curve.cuh's
// jac_scalar_mul over 32 two-bit windows of the 64-bit z on the group
template <typename B, bool G2>
BLS_NOINLINE void grp_scalar_mul(uint32_t *vals, int *flags, const uint32_t *z) {
    using S = curve_slots<G2>;
    using Pr = curve_progs<B, G2>;
    using Grp = typename Pr::Grp;
    grp_copy<B, Grp>(vals, S::A, S::T, S::NP);  // [2]P
    Pr::dbl(vals);
    grp_copy<B, Grp>(vals, S::T + S::NP, S::A, S::NP);
    grp_add_table<B, G2>(vals, flags, 1, false);  // [3]P = [2]P + P (P's Z = 1)
    grp_copy<B, Grp>(vals, S::T + 2 * S::NP, S::A, S::NP);
    // bit d: [d]P is infinity ([0]P is, [1]P is not: its Z is 1)
    const unsigned all = (1u << S::NC) - 1u;
    unsigned zt = 1u;
    for (int d = 2; d <= 3; ++d) {
        const int z_slot = S::T + (d - 1) * S::NP + 2 * S::NC;
        zt |= (unsigned)(grp_zero_mask<Grp>((B *)nullptr, vals, z_slot, S::NC, flags) == all) << d;
    }
    const int top = (z[1] >> 30) & 3;
    grp_copy<B, Grp>(vals, S::A, top ? S::T + (top - 1) * S::NP : -1, S::NP);
#pragma unroll 1
    for (int w = 30; w >= 0; --w) {
        const int d = (z[w >> 4] >> (2 * (w & 15))) & 3;
        Pr::dbl(vals);
        Pr::dbl(vals);
        grp_add_table<B, G2>(vals, flags, d, (zt >> d) & 1);
    }
}

// slot 0 and the table's [1]P = (x, y, 1), x and y from src (affine);
// syncs
template <typename B, typename Grp, bool G2>
BLS_INLINE void ladder_init(uint32_t *vals, const uint32_t *src) {
    using S = curve_slots<G2>;
    constexpr int W = B::WORDS;
    for (int s = Grp::rank(); s <= S::NP; s += Grp::SIZE) {
        B v;
        if (s < 2 * S::NC)
            fp_load(v, src + s * W);
        else if (s == 2 * S::NC)
            fp_set_one(v);
        else
            fp_set_zero(v);
        fp_store(vals + (s == S::NP ? 0 : S::T + s) * W, v);
    }
    Grp::sync();
}

// item t's G1 ladder: limb on four lanes (csrc/g1_lanes.cuh)
BLS_INLINE void g1_ladder(fp *, const uint32_t *p, const uint32_t *z, uint32_t *g1, long long n,
                          int affine, long long block, uint32_t *, int *) {
    constexpr int W = 12;
    const long long t = block * ladder_geom<fp>::G1_PER_BLOCK + threadIdx.x / fp_g4::LANES;
    if (t >= n) return;
    jac<fp_g4> pt, r;
    fload(pt.x, p + (2 * t) * W);
    fload(pt.y, p + (2 * t + 1) * W);
    fset_one(pt.z);
    jac_scalar_mul(r, pt, z + 2 * t, 32);
    if (affine) {
        fp_g4 x, y;
        jac_to_affine(x, y, r);
        fstore(g1 + (2 * t) * W, x);
        fstore(g1 + (2 * t + 1) * W, y);
    } else {
        fstore(g1 + (3 * t) * W, r.x);
        fstore(g1 + (3 * t + 1) * W, r.y);
        fstore(g1 + (3 * t + 2) * W, r.z);
    }
}

// item t's G1 ladder under RNS: a group of 4 warps; the affine step on its
// first warp (one Fermat inverse)
BLS_INLINE void g1_ladder(rns_w *, const uint32_t *p, const uint32_t *z, uint32_t *g1,
                          long long n, int affine, long long block, uint32_t *slots,
                          int *flags) {
    using L = ladder_geom<rns_w>;
    using Grp = L::G1;
    using S = curve_slots<false>;
    constexpr int W = RNS_N;
    const long long t = block * L::G1_PER_BLOCK + Grp::index();
    if (t >= n) return;  // a whole group
    uint32_t *vals = slots + Grp::index() * G1_RNS_SLOTS * W;
    flags += 8 * Grp::index();
    ladder_init<rns_w, Grp, false>(vals, p + 2 * t * W);
    grp_scalar_mul<rns_w, false>(vals, flags, z + 2 * t);
    if (affine) {
        if (Grp::rank() == 0) {
            jac<rns_w> r;
            rns_w x, y;
            for (int k = 0; k < 3; ++k) fp_load(k == 0 ? r.x : k == 1 ? r.y : r.z,
                                                vals + (S::A + k) * W);
            jac_to_affine(x, y, r);
            fp_store(g1 + (2 * t) * W, x);
            fp_store(g1 + (2 * t + 1) * W, y);
        }
    } else {
        for (int k = Grp::rank(); k < 3; k += Grp::SIZE) {
            rns_w v;
            fp_load(v, vals + (S::A + k) * W);
            fp_store(g1 + (3 * t + k) * W, v);
        }
    }
}

// item t's G2 ladder on its group (Jacobian out)
template <typename B>
BLS_INLINE void g2_ladder(const uint32_t *q, const uint32_t *z, uint32_t *g2, long long n,
                          long long block, uint32_t *slots, int *flags) {
    using L = ladder_geom<B>;
    using Grp = typename L::G2;
    using S = curve_slots<true>;
    constexpr int W = B::WORDS;
    const long long t = block * L::G2_PER_BLOCK + Grp::index();
    if (t >= n) return;  // a whole group
    uint32_t *vals = slots + Grp::index() * (L::WORDS / L::G2_PER_BLOCK);
    flags += 8 * Grp::index();
    ladder_init<B, Grp, true>(vals, q + 4 * t * W);
    grp_scalar_mul<B, true>(vals, flags, z + 2 * t);
    for (int k = Grp::rank(); k < S::NP; k += Grp::SIZE) {
        B v;
        fp_load(v, vals + (S::A + k) * W);
        fp_store(g2 + (6 * t + k) * W, v);
    }
}

// K9: blocks [0, g1_blocks) run G1 ladders, the rest G2 ladders
template <typename B>
__global__ void __launch_bounds__(ladder_geom<B>::THREADS)
    rlc_ladders_kernel(const uint32_t *__restrict__ p, const uint32_t *__restrict__ q,
                       const uint32_t *__restrict__ z, uint32_t *g1, uint32_t *g2, long long n,
                       int affine, long long g1_blocks) {
    __shared__ __align__(16) uint32_t slots[ladder_geom<B>::WORDS];
    __shared__ int flags[8 * 8];  // the RNS zero tests', 8 a group
    field_prologue((B *)nullptr);
    if (blockIdx.x < g1_blocks)
        g1_ladder((B *)nullptr, p, z, g1, n, affine, blockIdx.x, slots, flags);
    else
        g2_ladder<B>(q, z, g2, n, blockIdx.x - g1_blocks, slots, flags);
}

constexpr int SUM_UNITS = 64;  // K10's G1 units over the limb field
constexpr int SUM_WARPS = 16;  // over RNS

template <typename B>
__host__ __device__ constexpr int sum_threads() {
    return B::LANES == 32 ? SUM_WARPS * B::LANES : SUM_UNITS * B::LANES;
}

// K10's G1 sums: one block a segment
template <typename B>
__global__ void __launch_bounds__(sum_threads<B>())
    point_sums_kernel(const uint32_t *__restrict__ pts, const long long *__restrict__ off,
                      uint32_t *out) {
    constexpr int L = B::LANES, W = B::WORDS;
    __shared__ jac<B> part[sum_threads<B>()];
    field_prologue((B *)nullptr);
    int d = blockIdx.x;
    const uint32_t *seg = pts + off[d] * 3 * W;
    block_tree_sum(part, off[d + 1] - off[d], [&](long long i, jac<B> &e) {
        fload(e.x, seg + (3 * i) * W);
        fload(e.y, seg + (3 * i + 1) * W);
        fload(e.z, seg + (3 * i + 2) * W);
        return true;
    });
    if (threadIdx.x < L) {
        B x, y;
        jac_to_affine(x, y, part[threadIdx.x]);
        fstore(out + (2 * d) * W, x);
        fstore(out + (2 * d + 1) * W, y);
    }
}

// --- K10's G2 collapse on K9's G2 groups, across blocks --------------------------
//
// U units a segment (a power of two the caller picks from N alone,
// ops/bls12.py `g2_sum_units`), each a K9 G2 group: 16 lanes under the
// limb field (8 a block), the 8 warps of a block under RNS. Block b of nb
// holds units b, b + nb, ... (strided), so its in-block tree (local l takes
// l + k/2) is the global tree's "unit u takes u + U/2" and the kernel adds
// in the plain version's order (`segment_sums_limbs(F, pts, off, U)`):
// unit u folds the entries u, u + U, ... into infinity, the units meet in
// a tree, and the sum is made affine. The blocks' partials meet across
// blocks by tickets: a block stores its partial, fences, and takes its
// pair's ticket; the second of a pair to arrive adds the two (the lower
// unit first) and goes on to the next level, so the tree keeps its depth
// and the last block makes the sum affine (`aff_norm`, one unit's inverse,
// `aff_out`: the products of f2_inv and jac_to_affine spread over the group).
// A launch a cross-block level in place of the tickets was slower on an
// H100: RNS 1.37-1.49 ms against 0.95-1.11 at N = 256 and 1,024, limb
// 0.31-0.34 against 0.30-0.32 (PERF.md).

// the group's THREADS copy n words; `grp_words_cg` reads global memory
// past L1 (another block may have written it). The caller syncs.
template <typename Grp>
BLS_INLINE void grp_words(uint32_t *dst, const uint32_t *src, int n) {
    for (int i = Grp::thread(); i < n; i += Grp::THREADS) dst[i] = src[i];
}
template <typename Grp>
BLS_INLINE void grp_words_cg(uint32_t *dst, const uint32_t *src, int n) {
    for (int i = Grp::thread(); i < n; i += Grp::THREADS) dst[i] = __ldcg(src + i);
}

// A = A + B (B in its slots): curve.cuh's complete jac_add on the group
template <typename B>
BLS_INLINE void grp_add_loaded(uint32_t *vals, int *flags) {
    using S = curve_slots<true>;
    using Grp = typename curve_progs<B, true>::Grp;
    const bool z1 = grp_zero_mask<Grp>((B *)nullptr, vals, S::A + 4, 2, flags) == 3u;
    const bool z2 = grp_zero_mask<Grp>((B *)nullptr, vals, S::B + 4, 2, flags) == 3u;
    if (z1)
        grp_copy<B, Grp>(vals, S::A, S::B, S::NP);
    else if (!z2)
        grp_add_core<B, true>(vals, flags);
}

// A's affine image into out (2, 2, W): (0, 0) for infinity (inv(0) = 0)
template <typename B>
BLS_INLINE void grp_g2_affine(uint32_t *vals, uint32_t *out) {
    using S = curve_slots<true>;
    using Pr = curve_progs<B, true>;
    using Grp = typename Pr::Grp;
    constexpr int W = B::WORDS;
    Pr::aff_norm(vals);
    if (Grp::rank() == 0) {
        B n;
        fp_load(n, vals + CURVE2_H * W);
        fp_inv(n, n);
        fp_store(vals + CURVE2_R * W, n);
    }
    Grp::sync();
    Pr::aff_out(vals);
    grp_words<Grp>(out, vals + S::C * W, 4 * W);
}

template <typename B>
__global__ void __launch_bounds__(ladder_geom<B>::THREADS)
    g2_sums_kernel(const uint32_t *__restrict__ pts, const long long *__restrict__ off,
                   uint32_t *out, uint32_t *part, int *tickets, int units, int nb) {
    using L = ladder_geom<B>;
    using Grp = typename L::G2;
    using S = curve_slots<true>;
    constexpr int W = B::WORDS, PW = S::NP * W, K = L::G2_PER_BLOCK;
    __shared__ __align__(16) uint32_t slots[L::WORDS];
    __shared__ int flags[8 * K];
    __shared__ int ticket;
    field_prologue((B *)nullptr);
    const long long d = blockIdx.x / nb;
    const int b = blockIdx.x % nb, k = units / nb, l = Grp::index();
    uint32_t *vals = slots + l * (L::WORDS / K);
    int *fl = flags + 8 * l;
    const long long start = off[d], count = off[d + 1] - start;
    if (l < k) {
        for (int s = Grp::rank(); s <= S::NP; s += Grp::SIZE) {  // slot 0 and A: zero
            B z;
            fp_set_zero(z);
            fp_store(vals + (s == 0 ? 0 : S::A + s - 1) * W, z);
        }
        Grp::sync();
        for (long long i = b + (long long)l * nb; i < count; i += units) {
            grp_words<Grp>(vals + S::B * W, pts + (start + i) * PW, PW);
            Grp::sync();
            grp_add_loaded<B>(vals, fl);
        }
    }
    for (int h = k / 2; h > 0; h >>= 1) {
        __syncthreads();
        if (l < h) {
            grp_words<Grp>(vals + S::B * W, slots + (l + h) * (L::WORDS / K) + S::A * W, PW);
            Grp::sync();
            grp_add_loaded<B>(vals, fl);
        }
    }
    __syncthreads();
    uint32_t *seg_part = part + d * nb * PW;
    for (int j = b, h = nb / 2; h > 0; j &= h - 1, h >>= 1) {
        // this block holds unit j of the level's 2h; its pair is (j mod h, j mod h + h)
        if (l == 0) grp_words<Grp>(seg_part + j * PW, vals + S::A * W, PW);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) ticket = atomicAdd(tickets + d * nb + h + (j & (h - 1)), 1);
        __syncthreads();
        if (ticket == 0) return;  // the pair's other block goes on
        __threadfence();
        if (l == 0) {
            if (j >= h) grp_words<Grp>(vals + S::B * W, vals + S::A * W, PW);
            Grp::sync();
            grp_words_cg<Grp>(vals + (j < h ? S::B : S::A) * W, seg_part + (j ^ h) * PW, PW);
            Grp::sync();
            grp_add_loaded<B>(vals, fl);
        }
    }
    if (l == 0) grp_g2_affine<B>(vals, out + d * 4 * W);
}

template <typename B>
static int ladders(const void *p, const void *q, const void *z, void *g1, void *g2, long long n,
                   long long has_g1, long long has_g2, long long affine, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    using L = ladder_geom<B>;
    const long long b1 = has_g1 ? (n + L::G1_PER_BLOCK - 1) / L::G1_PER_BLOCK : 0;
    const long long b2 = has_g2 ? (n + L::G2_PER_BLOCK - 1) / L::G2_PER_BLOCK : 0;
    if (n > 0 && b1 + b2 > 0)
        rlc_ladders_kernel<B><<<(unsigned)(b1 + b2), L::THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t *)p, (const uint32_t *)q, (const uint32_t *)z, (uint32_t *)g1,
            (uint32_t *)g2, n, (int)affine, b1);
    return (int)cudaGetLastError();
}

template <typename B>
static int sums(const void *pts, const void *off, void *out, void *scratch, long long d,
                long long is_g2, long long units, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (d > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (is_g2) {
            constexpr int K = ladder_geom<B>::G2_PER_BLOCK;
            if (units < 1 || (units & (units - 1)) || units > (1 << 20))
                return (int)cudaErrorInvalidValue;
            const long long nb = units > K ? units / K : 1;
            // scratch: D·U partials of 6·WORDS words, then D·U tickets
            int *tickets = (int *)scratch + d * units * 6 * B::WORDS;
            e = (int)cudaMemsetAsync(tickets, 0, d * nb * sizeof(int), s);
            if (e) return e;
            g2_sums_kernel<B><<<(unsigned)(d * nb), ladder_geom<B>::THREADS, 0, s>>>(
                (const uint32_t *)pts, (const long long *)off, (uint32_t *)out,
                (uint32_t *)scratch, tickets, (int)units, (int)nb);
        } else {
            // the limb G1 instance on four-lane groups (fp_g4), the RNS one as B
            using G1 = typename std::conditional<std::is_same<B, fp>::value, fp_g4, B>::type;
            point_sums_kernel<G1><<<(unsigned)d, sum_threads<G1>(), 0, s>>>(
                (const uint32_t *)pts, (const long long *)off, (uint32_t *)out);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int rlc_ladders(const void *p, const void *q, const void *z, void *g1, void *g2,
                           long long n, long long has_g1, long long has_g2, long long affine,
                           void *stream) {
    return ladders<fp>(p, q, z, g1, g2, n, has_g1, has_g2, affine, stream);
}

extern "C" int rlc_ladders_rns(const void *p, const void *q, const void *z, void *g1, void *g2,
                               long long n, long long has_g1, long long has_g2, long long affine,
                               void *stream) {
    return ladders<rns_w>(p, q, z, g1, g2, n, has_g1, has_g2, affine, stream);
}

// pts (N, 3, [2,] W) Jacobian, off (D + 1,), out (D, 2, [2,] W); G2: scratch
// of D·units·(6·W + 1) words, units a power of two
extern "C" int point_sums(const void *pts, const void *off, void *out, void *scratch,
                          long long d, long long is_g2, long long units, void *stream) {
    return sums<fp>(pts, off, out, scratch, d, is_g2, units, stream);
}

extern "C" int point_sums_rns(const void *pts, const void *off, void *out, void *scratch,
                              long long d, long long is_g2, long long units, void *stream) {
    return sums<rns_w>(pts, off, out, scratch, d, is_g2, units, stream);
}
