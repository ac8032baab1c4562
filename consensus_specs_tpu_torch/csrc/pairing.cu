// The optimal-ate pairing on the card, templates over the base field: the
// limb field (csrc/fp.cuh, `fp`) and the RNS field (csrc/fp_rns.cuh,
// `rns_w`, `_rns` entry points). A unit below is a thread (limb) or a warp
// (RNS); each kernel runs an item on a group of units.
//
// K11 miller_loop: f_{|x|,Q}(P), conjugated (x < 0), per (Q, P) pair: Q
// affine on the twist (B, 2, 2, 12), P affine (B, 2, 12) -> (B, 12, 12).
// Replaces consensus_specs_tpu/ops/bls12_jax.py:514 `miller_loop_batch` with
// `_dbl_step` :442 and `_add_step` :478: T in Jacobian coordinates on the
// twist, JAX's formulas and line scaling (2YZ^3·xi for a double, HZ·xi for
// an add, :22-27), so the output is JAX's, bit for bit. A pairing runs on a
// group (csrc/bls_group.cuh): the 32 lanes of a warp under limb (four
// pairings a block), the 8 warps of a block under RNS. Its state (f, T, Q,
// P) lives in the group's slots; each of the 63 iterations runs the program
// `miller_dbl` (the doubling step with its line, f squared and times the
// line: 114 distinct Fp products, whose independent ones go out a unit
// each) and, where the bit of |x| is set, `miller_add` (83), as
// ops/bls12_programs.py schedules them from the one-unit formulas. One unit
// ran the loop's 7,700 products in one line (17.1 ms at B = 257 on an H100,
// limb; 11.2 under RNS); the groups run a doubling iteration in 7 product
// rounds (limb) or 15 (RNS) and about as many rounds of sums. The group
// sizes were timed on the card (PERF.md): 32 lanes ran B = 257 in 1.92 ms
// and B = 1,025 in 2.59, 16 lanes (eight pairings a block) 2.76 and 2.76,
// so the limb group is a warp; under RNS 8 warps ran 3.68 and 12.57 ms, 4
// warps 4.54 and 12.91, so it is 8. At B = 1,025 the RNS instance is bound
// by its products' instruction count, as one warp a pairing was.
//
// K12 final_exp, the final exponentiation (:611, JAX's hard-part chain, so
// the output is the cube of the reduced pairing) and `f12_is_one` (:628),
// each on a group of units (csrc/f12_group.cuh: 32 lanes of a warp under
// limb, the 8 warps of a block under RNS):
// - mode 1 (batch): per item (a group each), f = m1 (times m2 where given),
//   its final exponentiation and is_one (`pairing_cube_batch` :762,
//   `pairing_check_batch` :768);
// - mode 0 (tail): the tree product of the n values in place
//   (`f12_tree_product`), then one group exponentiates the product
//   (`f12_prod_reduce` :1061, `rlc_tail` :1219).
//
// K25 f12_product (limb field only): the same tree product of B Fp12 values
// (B, 12, 12), in place, and no exponentiation: the Fp12 partial of a mesh
// rank's shard and the fold of the gathered partials (`f12_prod_reduce` as
// parallel/collectives.py:147, :153, :236 use it). K12's tail and K25 call
// one function, `f12_tree_product`, so the two products cannot drift
// apart: a launch a level, a group a product, the levels' products side by
// side on as many SMs as they need. The order (i with i + ceil(k/2)) is the
// plain versions' (ops/bls12.py `f12_tree_product_limbs`); any order gives
// the same canonical value, and RNS residues follow the order. An entry
// call of K12 or K25 counts one launch whatever its grids.
//
// Bound: operations. A Miller loop is about 7,700 Fp products (7,597
// distinct: a product by the line's zero coefficient is one product) and a
// final exponentiation about 9,300; a block flush runs 257 Miller loops and
// one exponentiation, so both are latency-bound far from the operation rate.
// The groups shorten the lines: the exponentiation's about 8x (limb) and 5x
// (RNS), and the tail's tree is 9 levels of one group's Fp12 product
// (PERF.md). The bit loops stay rolled; the tower functions are called, not
// inlined.
#include <cuda_runtime.h>

#include "bls_group.cuh"
#include "f12_group.cuh"
#include "stack.cuh"

// K11's group by field: a warp (limb, four groups a block) or the block's
// warps (RNS)
template <typename B>
struct miller_group;
template <>
struct miller_group<fp> {
    using type = lanes<MILLER_LIMB_G>;
    static constexpr int PER_BLOCK = 128 / MILLER_LIMB_G, SLOTS = MILLER_LIMB_SLOTS;
};
template <>
struct miller_group<rns_w> {
    using type = warps<MILLER_RNS_G, 1>;
    static constexpr int PER_BLOCK = 1, SLOTS = MILLER_RNS_SLOTS;
};

template <typename B>
__host__ __device__ constexpr int miller_threads() {
    return miller_group<B>::PER_BLOCK * miller_group<B>::type::SIZE * B::LANES;
}

template <typename B>
BLS_INLINE void miller_dbl(uint32_t *vals);
template <>
BLS_INLINE void miller_dbl<fp>(uint32_t *vals) {
    slp_run<fp, miller_group<fp>::type>(PROG_MILLER_DBL_LIMB, vals);
}
template <>
BLS_INLINE void miller_dbl<rns_w>(uint32_t *vals) {
    slp_run<rns_w, miller_group<rns_w>::type>(PROG_MILLER_DBL_RNS, vals);
}
template <typename B>
BLS_INLINE void miller_add(uint32_t *vals);
template <>
BLS_INLINE void miller_add<fp>(uint32_t *vals) {
    slp_run<fp, miller_group<fp>::type>(PROG_MILLER_ADD_LIMB, vals);
}
template <>
BLS_INLINE void miller_add<rns_w>(uint32_t *vals) {
    slp_run<rns_w, miller_group<rns_w>::type>(PROG_MILLER_ADD_RNS, vals);
}

// Pair i on group i: the slots start as f = 1, T = (xq, yq, 1), Q, P (the
// one-unit loop's start), then the 63 bits of |x| below its top one, then
// the conjugate of f goes out (row 2k + c of coefficient k's component c).
template <typename B>
__global__ void __launch_bounds__(miller_threads<B>())
    miller_loop_kernel(const uint32_t *__restrict__ q, const uint32_t *__restrict__ p,
                       uint32_t *out, long long n) {
    using MG = miller_group<B>;
    using Grp = typename MG::type;
    constexpr int W = B::WORDS, S = MG::SLOTS;
    __shared__ __align__(16) uint32_t slots[MG::PER_BLOCK * S * W];
    field_prologue((B *)nullptr);
    const long long i = (long long)blockIdx.x * MG::PER_BLOCK + Grp::index();
    if (i >= n) return;  // a whole group (under RNS the block)
    uint32_t *vals = slots + Grp::index() * S * W;
    for (int s = Grp::rank(); s < MILLER_FIXED; s += Grp::SIZE) {
        B v;
        if (s >= MILLER_Q && s < MILLER_Q + 4)
            fp_load(v, q + (4 * i + s - MILLER_Q) * W);
        else if (s >= MILLER_P)
            fp_load(v, p + (2 * i + s - MILLER_P) * W);
        else if (s >= MILLER_T && s < MILLER_T + 4)
            fp_load(v, q + (4 * i + s - MILLER_T) * W);
        else if (s == MILLER_F || s == MILLER_T + 4)
            fp_set_one(v);
        else
            fp_set_zero(v);
        fp_store(vals + s * W, v);
    }
    Grp::sync();
#pragma unroll 1
    for (int b = 62; b >= 0; --b) {
        miller_dbl<B>(vals);
        if ((X_ABS >> b) & 1) miller_add<B>(vals);
    }
    for (int s = Grp::rank(); s < 12; s += Grp::SIZE) {
        B v;
        fp_load(v, vals + (MILLER_F + s) * W);
        if ((s >> 1) & 1) fp_neg(v, v);
        fp_store(out + (12 * i + s) * W, v);
    }
}

// threads a block of K12 and K25: four 32-lane groups (limb), one group of
// eight warps (RNS); the exchanges of a block
template <typename B>
__host__ __device__ constexpr int group_block() {
    return B::LANES == 1 ? 4 * group_threads<B>() : group_threads<B>();
}
template <typename B>
__host__ __device__ constexpr int xbuf_words() {
    return group_block<B>() / group_threads<B>() * group_words<B>();
}

// One level of the tree product of K12's tail and K25: group i of the grid
// multiplies m[i] by m[i + half] in place, i < n (g_f12_mul). The levels are
// launches of their own, so a level's products all run side by side, one a
// group, on as many SMs as they need.
template <typename B>
__global__ void __launch_bounds__(group_block<B>())
    f12_level_kernel(uint32_t *m, long long n, long long half) {
    using Grp = typename fe_group<B>::type;
    __shared__ __align__(16) uint32_t xbuf[xbuf_words<B>()];
    field_prologue((B *)nullptr);
    constexpr int W = 12 * B::WORDS;
    const long long i = (long long)blockIdx.x * (blockDim.x / group_threads<B>()) + Grp::index();
    if (i >= n) return;  // a whole group (under RNS the block)
    uint32_t *buf = xbuf + Grp::index() * group_words<B>();
    fp12_t<B> a, b;
    f12_load(a, m + W * i);
    f12_load(b, m + W * (i + half));
    g_f12_mul<B, Grp>(a, a, b, buf);
    if (Grp::rank() == 0) f12_store(m + W * i, a);
}

// The tree product of the k values of m into m[0]: at each level value i
// takes value i + ceil(k/2) (the plain versions' order, ops/bls12.py
// `f12_tree_product_limbs`; any order gives the same canonical limb value,
// and RNS residues follow the order), a launch a level.
template <typename B>
static void f12_tree_product(uint32_t *m, long long k, cudaStream_t s) {
    const int per_block = group_block<B>() / group_threads<B>();
    while (k > 1) {
        const long long half = (k + 1) / 2, n = k - half;
        f12_level_kernel<B><<<(unsigned)((n + per_block - 1) / per_block), group_block<B>(), 0,
                              s>>>(m, n, half);
        k = half;
    }
}

// K12: item i's final exponentiation (of m[i], times m2[i] where given) and
// is_one, a group an item (f12_group.cuh)
template <typename B>
__global__ void __launch_bounds__(group_block<B>())
    final_exp_kernel(const uint32_t *m, const uint32_t *m2, uint32_t *out, int *ok, long long n) {
    using Grp = typename fe_group<B>::type;
    __shared__ __align__(16) uint32_t xbuf[xbuf_words<B>()];
    field_prologue((B *)nullptr);
    constexpr int W = 12 * B::WORDS;
    const long long i = (long long)blockIdx.x * (blockDim.x / group_threads<B>()) + Grp::index();
    if (i >= n) return;  // a whole group (under RNS the block)
    uint32_t *buf = xbuf + Grp::index() * group_words<B>();
    fp12_t<B> f, g;
    f12_load(f, m + W * i);
    if (m2) {
        f12_load(g, m2 + W * i);
        g_f12_mul<B, Grp>(f, f, g, buf);
    }
    g_final_exponentiation<B, Grp>(f, f, buf);
    bool one = f12_is_one(f);
    if (Grp::rank() == 0) {
        f12_store(out + W * i, f);
        if (threadIdx.x % B::LANES == 0) ok[i] = one ? 1 : 0;
    }
}

// The device's stack limit after raising it, written to *out (a host long
// long); launches nothing.
extern "C" int bls_stack_limit(void *out, long long n, void *stream) {
    int e = ensure_stack();
    size_t cur = 0;
    if (!e) e = (int)cudaDeviceGetLimit(&cur, cudaLimitStackSize);
    *(long long *)out = (long long)cur;
    return e;
}

template <typename B>
static int miller_entry(const void *q, const void *p, void *out, long long n, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0) {
        const int per_block = miller_group<B>::PER_BLOCK;
        miller_loop_kernel<B><<<(unsigned)((n + per_block - 1) / per_block), miller_threads<B>(),
                                0, (cudaStream_t)stream>>>((const uint32_t *)q, (const uint32_t *)p,
                                                           (uint32_t *)out, n);
    }
    return (int)cudaGetLastError();
}

// mode 1 (batch): items 0 .. n-1; mode 0 (tail): the tree product of the
// n values of m (in place), then its exponentiation as one item
template <typename B>
static int final_exp_entry(void *m, const void *m2, void *out, void *ok, long long n,
                           long long mode, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        long long items = n;
        if (mode == 0) {
            f12_tree_product<B>((uint32_t *)m, n, s);
            items = 1;
            m2 = nullptr;
        }
        const int per_block = group_block<B>() / group_threads<B>();
        final_exp_kernel<B><<<(unsigned)((items + per_block - 1) / per_block), group_block<B>(), 0,
                              s>>>((const uint32_t *)m, (const uint32_t *)m2, (uint32_t *)out,
                                   (int *)ok, items);
    }
    return (int)cudaGetLastError();
}

extern "C" int miller_loop(const void *q, const void *p, void *out, long long n, void *stream) {
    return miller_entry<fp>(q, p, out, n, stream);
}

extern "C" int miller_loop_rns(const void *q, const void *p, void *out, long long n,
                               void *stream) {
    return miller_entry<rns_w>(q, p, out, n, stream);
}

extern "C" int final_exp(void *m, const void *m2, void *out, void *ok, long long n,
                         long long mode, void *stream) {
    return final_exp_entry<fp>(m, m2, out, ok, n, mode, stream);
}

extern "C" int final_exp_rns(void *m, const void *m2, void *out, void *ok, long long n,
                             long long mode, void *stream) {
    return final_exp_entry<rns_w>(m, m2, out, ok, n, mode, stream);
}

// K25: the product of the n Fp12 values of m (n, 12, 12), in place into
// m[0]; no exponentiation. A launch a level of the tree.
extern "C" int f12_product(void *m, long long n, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0) f12_tree_product<fp>((uint32_t *)m, n, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
