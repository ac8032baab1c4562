// The G1 multi-scalar multiplication and the batched subgroup check.
//
// K13 g1_msm: sum_i [s_i]·P_i over N Jacobian points and scalars of `nbits`
// bits, windowed bucket MSM in JAX's gather form (replaces
// consensus_specs_tpu/ops/bls12_jax.py:1291 `g1_msm_pippenger` with
// `msm_window_digits` :1257 and `_g1_bucket_tables` :1277, via `_g1_msm_program`
// :1331). Three kernels on the stream, one entry, every point operation on
// a group of four lanes (csrc/g1_lanes.cuh: a double's 7 products in 3
// steps, an add's 16 in 5):
//   (a) four groups an item build its table tab[k] = [k]·P_i, k < 2^w, into
//       a global scratch (layout [k][i]; even entries double tab[k/2], odd
//       ones add P once, JAX's formulas), since 2^w Jacobian points do not
//       fit in a thread's registers, level by level of the entries' chains;
//   (b) one block of 64 groups a window: each group gathers tab[d_ij][i] over
//       a strided share of the items (d_ij the item's digit of window j;
//       digit 0 is the point at infinity and is skipped), the shares meet in
//       a tree in shared memory (curve.cuh's block_tree_sum, which K10's G1
//       segments use);
//   (c) one warp: the combine sum_j [2^(w·j)]·S_j as m interleaved Horner
//       chains on m groups (m = 8 at 64 windows) and their combine, then
//       the affine image ((0, 0) for the identity), so the output is
//       canonical whatever order the sums took. The doublings on the line
//       are (W - 1)·w whatever the order; the adds on it fall from W - 1 to
//       about W/m + m. One thread's Horner took 4.84 of 5.46 ms at (512,
//       255) on an H100 (PERF.md).
// Scalars cross as int32 words, LSB first, nwords = ceil(nbits / 32); bits at
// or above nbits are ignored, as JAX reads only nbits of them.
//
// K14 g1_subgroup: r-subgroup membership per item, the same boolean as
// JAX's [r]·P == infinity (`_g1_subgroup_program` :1347, the ladder of
// g1_scalar_mul_batch :782 over `_r_order_bits`), by curve.cuh's
// `jac_in_g1`: phi(P) = -[x^2]·P, 126 doubles and 10 adds where the ladder
// took 255 and 128. Domain: points on E(Fp) (ops/bls12.py builds them from
// decompressed keys); a Z = 0 input (a pad) reports 1. Four lanes a key
// (F = fp_g4, g1_lanes.cuh: a double's and an add's independent products side
// by side); one thread a key (F = fp) took 1.86 ms at 512 keys on an H100
// against the group's 0.96, and is not launched.
//
// Bound: operations (Fp products, about 1,200 SASS instructions each). K13's
// tables and window sums spread over 4N and W groups, but its tail is about
// (W - 1)·w doublings in one line, latency-bound like K12's tail: the groups
// shorten each step (a double takes 3 products' time whatever the formula:
// Y3 has degree 6), the chains cut the adds. K14's chain is 1,051 products
// in one line a key, and a committee is 512 keys: a key is latency-bound on
// the line; the lane group cuts the line to 437 products' time.
#include <cuda_runtime.h>

#include "curve.cuh"
#include "g1_lanes.cuh"
#include "stack.cuh"

constexpr int MSM_THREADS = 128;      // tables: 8 items a block, four groups each
constexpr int MSM_SUM_THREADS = 256;  // window sums: 64 groups a window
constexpr int MSM_CHAINS = 8;         // the tail's chains at most: a warp of groups

// digit j of a scalar: bits [j·w, j·w + w) of its words, cut at nbits
BLS_INLINE uint32_t window_digit(const uint32_t *s, int nwords, int nbits, int j, int w) {
    int b = j * w, i = b >> 5, sh = b & 31;
    uint32_t v = s[i] >> sh;
    if (sh + w > 32 && i + 1 < nwords) v |= s[i + 1] << (32 - sh);
    int valid = nbits - b;
    if (valid < w) v &= (1u << valid) - 1u;
    return v & ((1u << w) - 1u);
}

// a Jacobian point of 36 words; every lane of a group loads and stores the
// group's value alike (the same words to the same address)
BLS_INLINE void jload(jac<fp_g4> &p, const uint32_t *src) {
    fload(p.x, src);
    fload(p.y, src + 12);
    fload(p.z, src + 24);
}
BLS_INLINE void jstore(uint32_t *dst, const jac<fp_g4> &p) {
    fstore(dst, p.x);
    fstore(dst + 12, p.y);
    fstore(dst + 24, p.z);
}

// depth of table entry k: its chain from [1]P has a double for each bit
// below the top one and an add for each set bit below it
BLS_INLINE int table_depth(int k) { return 31 - __clz(k) + __popc(k) - 1; }

// (a) the tables of 8 items a block, an item on four groups in the block's
// four warps (group g of item i: warp g, lanes 4·(i mod 8) ..): the entries
// go out level by level (entry k's depth), round-robin over the item's
// groups, and the block syncs between levels; so a warp's groups run one
// entry of 8 items alike, and w = 4's 14 entries take 6 steps (28 product
// steps on the line, 56 in one group)
__global__ void __launch_bounds__(MSM_THREADS)
    msm_tables_kernel(const uint32_t *__restrict__ pts, uint32_t *tab, long long n, int window) {
    const long long i = (long long)blockIdx.x * 8 + (threadIdx.x & 31) / fp_g4::LANES;
    const int g = threadIdx.x / 32;
    const bool live = i < n;
    jac<fp_g4> p;
    if (live) {
        jload(p, pts + i * 36);
        if (g == 0) {
            jac<fp_g4> t;
            jac_set_inf(t);
            jstore(tab + i * 36, t);
            jstore(tab + (n + i) * 36, p);
        }
    }
    __syncthreads();
    for (int level = 1; level <= 2 * (window - 1); ++level) {
        int at = 0;
        for (int k = 2; k < (1 << window); ++k) {
            if (table_depth(k) != level || at++ % 4 != g || !live) continue;
            jac<fp_g4> h, t;
            if (k % 2 == 0) {
                jload(h, tab + ((long long)(k / 2) * n + i) * 36);
                jac_double(t, h);
            } else {
                jload(h, tab + ((long long)(k - 1) * n + i) * 36);
                jac_add(t, h, p);
            }
            jstore(tab + ((long long)k * n + i) * 36, t);
        }
        __syncthreads();
    }
}

// (b) window j's sum on one block of four-lane groups
__global__ void __launch_bounds__(MSM_SUM_THREADS)
    msm_window_sums_kernel(const uint32_t *__restrict__ tab, const uint32_t *__restrict__ sc,
                           uint32_t *sums, long long n, int nwords, int nbits, int window) {
    __shared__ jac<fp_g4> part[MSM_SUM_THREADS];
    const int j = blockIdx.x;
    block_tree_sum(part, n, [&](long long i, jac<fp_g4> &e) {
        const uint32_t d = window_digit(sc + i * nwords, nwords, nbits, j, window);
        if (d) jload(e, tab + ((long long)d * n + i) * 36);
        return d != 0;
    });
    if (threadIdx.x < fp_g4::LANES) jstore(sums + j * 36, part[threadIdx.x]);
}

// (c) sum_j [2^(w·j)]·S_j on one warp: group c (c < m) runs Horner over the
// windows j = c (mod m) with steps of m·w doublings, T_c = sum_k
// [2^(m·w·k)]·S_(c+m·k); group 0 then combines ((T_(m-1)·2^w + T_(m-2))·2^w
// + ...)·2^w + T_0 and makes it affine. The doublings on the line stay
// (W - 1)·w; the adds fall from W - 1 to about W/m + m.
__global__ void __launch_bounds__(32)
    msm_tail_kernel(const uint32_t *__restrict__ sums, uint32_t *out, int nwin, int window,
                    int m) {
    __shared__ jac<fp_g4> part[MSM_CHAINS];
    const int c = threadIdx.x / fp_g4::LANES;
    if (c < m) {
        jac<fp_g4> acc;
        if (c >= nwin) {
            jac_set_inf(acc);
        } else {
            int j = c + m * ((nwin - 1 - c) / m);
            jload(acc, sums + j * 36);
#pragma unroll 1
            for (j -= m; j >= 0; j -= m) {
#pragma unroll 1
                for (int k = 0; k < m * window; ++k) jac_double(acc, acc);
                jac<fp_g4> s;
                jload(s, sums + j * 36);
                jac_add(acc, acc, s);
            }
        }
        if (g4_lane() == 0) part[c] = acc;
    }
    __syncwarp();
    if (c != 0) return;
    jac<fp_g4> acc = part[m - 1];
#pragma unroll 1
    for (int t = m - 2; t >= 0; --t) {
#pragma unroll 1
        for (int k = 0; k < window; ++k) jac_double(acc, acc);
        jac<fp_g4> s = part[t];
        jac_add(acc, acc, s);
    }
    fp_g4 x, y;
    jac_to_affine(x, y, acc);
    fstore(out, x);
    fstore(out + 12, y);
}

// the tail's chains m (1, 2, 4 or 8) for W windows of w bits: the fewest
// product steps on the line, 3 a double and 5 an add (g1_lanes.cuh)
static int msm_chains(int nwin, int window) {
    int best = 1;
    long long best_steps = -1;
    for (int m = 1; m <= MSM_CHAINS; m *= 2) {
        const long long adds = (nwin + m - 1) / m - 1;  // chain 0's
        const long long dbls = (long long)window * (adds * m + m - 1);
        const long long steps = 3 * dbls + 5 * (adds + m - 1);
        if (best_steps < 0 || steps < best_steps) {
            best = m;
            best_steps = steps;
        }
    }
    return best;
}

// F::LANES threads a key; the group's first lane writes the verdict
template <typename F>
__global__ void g1_subgroup_kernel(const uint32_t *__restrict__ pts, int *ok, long long n) {
    const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / F::LANES;
    if (i >= n) return;  // a whole group: n keys fill whole groups
    jac<F> p;
    F beta;
    fload(p.x, pts + i * 36);
    fload(p.y, pts + i * 36 + 12);
    fload(p.z, pts + i * 36 + 24);
    fload(beta, FP_BETA);
    const bool in = jac_in_g1(p, beta);
    if (threadIdx.x % F::LANES == 0) ok[i] = in ? 1 : 0;
}

// pts (n, 3, 12) Jacobian, sc (n, nwords) scalar words; tab (2^w, n, 3, 12)
// and sums (ceil(nbits / w), 3, 12) scratch; out (2, 12) affine
extern "C" int g1_msm(const void *pts, const void *sc, void *tab, void *sums, void *out,
                      long long n, long long nwords, long long nbits, long long window,
                      void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (window < 2 || window > 8 || nbits < 1 || nwords != (nbits + 31) / 32 || n < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int nwin = (int)((nbits + window - 1) / window);
    msm_tables_kernel<<<(unsigned)((n + 7) / 8), MSM_THREADS, 0, s>>>(
        (const uint32_t *)pts, (uint32_t *)tab, n, (int)window);
    msm_window_sums_kernel<<<(unsigned)nwin, MSM_SUM_THREADS, 0, s>>>(
        (const uint32_t *)tab, (const uint32_t *)sc, (uint32_t *)sums, n, (int)nwords,
        (int)nbits, (int)window);
    msm_tail_kernel<<<1, 32, 0, s>>>((const uint32_t *)sums, (uint32_t *)out, nwin, (int)window,
                                     msm_chains(nwin, (int)window));
    return (int)cudaGetLastError();
}

// pts (n, 3, 12) Jacobian -> ok (n,) int32
extern "C" int g1_subgroup(const void *pts, void *ok, long long n, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0) {
        const int threads = 64;
        const long long blocks = (n * fp_g4::LANES + threads - 1) / threads;
        g1_subgroup_kernel<fp_g4><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint32_t *)pts, (int *)ok, n);
    }
    return (int)cudaGetLastError();
}
