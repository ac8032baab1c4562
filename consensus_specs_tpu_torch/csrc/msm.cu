// The G1 multi-scalar multiplication and the batched subgroup check.
//
// K13 g1_msm: sum_i [s_i]·P_i over N Jacobian points and scalars of `nbits`
// bits, windowed bucket MSM in JAX's gather form (replaces
// consensus_specs_tpu/ops/bls12_jax.py:1291 `g1_msm_pippenger` with
// `msm_window_digits` :1257 and `_g1_bucket_tables` :1277, via `_g1_msm_program`
// :1331). Three kernels on the stream, one entry:
//   (a) one thread an item builds its table tab[k] = [k]·P_i, k < 2^w, into a
//       global scratch (layout [k][i]; even entries double tab[k/2], odd ones
//       add P once, JAX's formulas), since 2^w Jacobian points do not fit in
//       a thread's registers;
//   (b) one block a window: each thread gathers tab[d_ij][i] over a strided
//       share of the items (d_ij the item's digit of window j; digit 0 is the
//       point at infinity and is skipped), the shares meet in a tree in
//       shared memory (curve.cuh's block_tree_sum, which K10's segments use);
//   (c) one thread: the Horner combine, MSB window first (w doublings and one
//       add a step, W - 1 steps), then the affine image ((0, 0) for the
//       identity), so the output is canonical whatever order the sums took.
// Scalars cross as int32 words, LSB first, nwords = ceil(nbits / 32); bits at
// or above nbits are ignored, as JAX reads only nbits of them.
//
// K14 g1_subgroup: per item [r]·P == infinity, one thread an item, the 2-bit
// ladder of curve.cuh over r's 255 bits padded to 256 (JAX's
// g1_scalar_mul_batch at :782 over `_r_order_bits`, `_g1_subgroup_program`
// :1347). A Z = 0 input (a pad) reports 1.
//
// Bound: operations (Fp products, about 1,200 SASS instructions each). K13's
// tables and window sums spread over N and W threads, but its Horner tail is
// (W - 1)(w + 1) point operations in one thread, latency-bound like K12's
// tail; K14 runs one 128-window ladder a thread, 512 threads a committee.
#include <cuda_runtime.h>

#include "curve.cuh"
#include "stack.cuh"

constexpr int MSM_THREADS = 64;

// digit j of a scalar: bits [j·w, j·w + w) of its words, cut at nbits
BLS_INLINE uint32_t window_digit(const uint32_t *s, int nwords, int nbits, int j, int w) {
    int b = j * w, i = b >> 5, sh = b & 31;
    uint32_t v = s[i] >> sh;
    if (sh + w > 32 && i + 1 < nwords) v |= s[i + 1] << (32 - sh);
    int valid = nbits - b;
    if (valid < w) v &= (1u << valid) - 1u;
    return v & ((1u << w) - 1u);
}

__global__ void msm_tables_kernel(const jac<fp> *__restrict__ pts, jac<fp> *tab, long long n,
                                  int window) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    jac<fp> p = pts[i], t;
    jac_set_inf(t);
    tab[i] = t;
    tab[n + i] = p;
    for (int k = 2; k < (1 << window); ++k) {
        if (k % 2 == 0) {
            jac<fp> h = tab[(long long)(k / 2) * n + i];
            jac_double(t, h);
        } else {
            jac<fp> prev = tab[(long long)(k - 1) * n + i];
            jac_add(t, prev, p);
        }
        tab[(long long)k * n + i] = t;
    }
}

__global__ void msm_window_sums_kernel(const jac<fp> *__restrict__ tab,
                                       const uint32_t *__restrict__ sc, jac<fp> *sums,
                                       long long n, int nwords, int nbits, int window) {
    __shared__ jac<fp> part[MSM_THREADS];
    int j = blockIdx.x;
    block_tree_sum(part, n, [&](long long i, jac<fp> &e) {
        uint32_t d = window_digit(sc + i * nwords, nwords, nbits, j, window);
        if (d) e = tab[(long long)d * n + i];
        return d != 0;
    });
    if (threadIdx.x == 0) sums[j] = part[0];
}

__global__ void msm_horner_kernel(const jac<fp> *__restrict__ sums, fp *out, int nwin,
                                  int window) {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    jac<fp> acc = sums[nwin - 1];
#pragma unroll 1
    for (int j = nwin - 2; j >= 0; --j) {
#pragma unroll 1
        for (int k = 0; k < window; ++k) jac_double(acc, acc);
        jac<fp> s = sums[j];
        jac_add(acc, acc, s);
    }
    jac_to_affine(out[0], out[1], acc);
}

__global__ void g1_subgroup_kernel(const jac<fp> *__restrict__ pts, int *ok, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = R_ORDER[k];
    jac<fp> p = pts[i], q;
    jac_scalar_mul(q, p, r, 128);
    ok[i] = fp_is_zero(q.z) ? 1 : 0;
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
    int nwin = (int)((nbits + window - 1) / window);
    const int threads = 64;
    msm_tables_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
        (const jac<fp> *)pts, (jac<fp> *)tab, n, (int)window);
    msm_window_sums_kernel<<<(unsigned)nwin, MSM_THREADS, 0, s>>>(
        (const jac<fp> *)tab, (const uint32_t *)sc, (jac<fp> *)sums, n, (int)nwords, (int)nbits,
        (int)window);
    msm_horner_kernel<<<1, 1, 0, s>>>((const jac<fp> *)sums, (fp *)out, nwin, (int)window);
    return (int)cudaGetLastError();
}

// pts (n, 3, 12) Jacobian -> ok (n,) int32
extern "C" int g1_subgroup(const void *pts, void *ok, long long n, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0) {
        const int threads = 64;
        g1_subgroup_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                             (cudaStream_t)stream>>>((const jac<fp> *)pts, (int *)ok, n);
    }
    return (int)cudaGetLastError();
}
