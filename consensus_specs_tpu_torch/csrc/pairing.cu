// The optimal-ate pairing on the card, templates over the base field: one
// thread a pairing over the limb field (csrc/fp.cuh), one warp a pairing
// over RNS (csrc/fp_rns.cuh, `_rns` entry points). Each launch takes its
// geometry from the field's lanes an element; a unit below is a thread
// (limb) or a warp (RNS).
//
// K11 miller_loop: f_{|x|,Q}(P), conjugated (x < 0), per (Q, P) pair: Q
// affine on the twist (B, 2, 2, 12), P affine (B, 2, 12) -> (B, 12, 12).
// Replaces consensus_specs_tpu/ops/bls12_jax.py:514 `miller_loop_batch` with
// `_dbl_step` :442 and `_add_step` :478: T in Jacobian coordinates on the
// twist, JAX's formulas and line scaling (2YZ^3·xi for a double, HZ·xi for
// an add, :22-27), so the output is JAX's, bit for bit.
//
// K12 final_exp, the final exponentiation (:611, JAX's hard-part chain, so
// the output is the cube of the reduced pairing) and `f12_is_one` (:628):
// - mode 1 (batch): per item (a unit each), f = m1 (times m2 where given),
//   its final exponentiation and is_one (`pairing_cube_batch` :762,
//   `pairing_check_batch` :768);
// - mode 0 (tail): one block's units tree-multiply the n values in place
//   (`f12_tree_product`), then unit 0 exponentiates the product
//   (`f12_prod_reduce` :1061, `rlc_tail` :1219).
//
// K25 f12_product (limb field only): the same one-block tree product of B
// Fp12 values (B, 12, 12), in place, and no exponentiation: the Fp12
// partial of a mesh rank's shard and the fold of the gathered partials
// (`f12_prod_reduce` as parallel/collectives.py:147, :153, :236 use it).
// K12's tail and K25 call one device function, `f12_tree_product`, so the
// two products cannot drift apart. The order (i with i + ceil(k/2)) is the
// plain versions' (ops/bls12.py `f12_tree_product_limbs`); any order gives
// the same canonical value.
//
// Bound: operations. A Miller loop is about 7,700 Fp products and a final
// exponentiation about 9,300 in one unit; a block flush runs 257 Miller
// loops (257 of the card's 16,896 lanes under the limb field) and one
// exponentiation in one unit, so both are latency-bound far from the
// operation rate. The bit loops stay rolled; the tower functions are
// called, not inlined. Under RNS an Fp12 is 24 registers a lane.
#include <cuda_runtime.h>

#include "curve.cuh"
#include "stack.cuh"

// One Miller doubling of T with its line (l0, l3, l5) at P = (xp, yp):
// l0 = 2YZ^3·xi·yp, l3 = 3X^3 - 2Y^2, l5 = -3X^2 Z^2·xp
template <typename F>
__device__ __noinline__ void dbl_step(jac<fp2_t<F>> &T, fp2_t<F> &l0, fp2_t<F> &l3, fp2_t<F> &l5,
                                      const F &xp, const F &yp) {
    fp2_t<F> A, B, Zsq, E, D, YZ, Zcu, EX, EZsq, Fq, C, X3, Y3, t;
    f2_sqr(A, T.x);
    f2_sqr(B, T.y);
    f2_sqr(Zsq, T.z);
    f2_add(E, A, A);
    f2_add(E, E, A);
    f2_mul(D, T.x, B);
    f2_mul(YZ, T.y, T.z);
    f2_mul(Zcu, T.z, Zsq);
    f2_mul(EX, E, T.x);
    f2_mul(EZsq, E, Zsq);
    f2_add(D, D, D);
    f2_add(D, D, D);
    f2_sqr(Fq, E);
    f2_sqr(C, B);
    f2_add(t, D, D);
    f2_sub(X3, Fq, t);
    f2_add(C, C, C);
    f2_add(C, C, C);
    f2_add(C, C, C);
    f2_sub(t, D, X3);
    f2_mul(Y3, E, t);
    f2_sub(Y3, Y3, C);
    f2_mul(t, T.y, Zcu);  // YZ^3
    f2_add(t, t, t);
    f2_mul_xi(t, t);
    f2_mul_fp(l0, t, yp);
    f2_mul_fp(t, EZsq, xp);
    f2_neg(l5, t);
    f2_add(t, B, B);
    f2_sub(l3, EX, t);
    f2_add(T.z, YZ, YZ);
    T.x = X3;
    T.y = Y3;
}

// Mixed addition T + Q with its line: H = xq Z^2 - X, r = yq Z^3 - Y,
// l0 = HZ·xi·yp, l3 = r·xq - HZ·yq, l5 = -r·xp
template <typename F>
__device__ __noinline__ void add_step(jac<fp2_t<F>> &T, fp2_t<F> &l0, fp2_t<F> &l3, fp2_t<F> &l5,
                                      const fp2_t<F> &xq, const fp2_t<F> &yq, const F &xp,
                                      const F &yp) {
    fp2_t<F> Zsq, U, Zcu, S, H, R, Hsq, Rsq, Hcu, V, HZ, X3, Y3, t, u;
    f2_sqr(Zsq, T.z);
    f2_mul(U, xq, Zsq);
    f2_mul(Zcu, T.z, Zsq);
    f2_mul(S, yq, Zcu);
    f2_sub(H, U, T.x);
    f2_sub(R, S, T.y);
    f2_sqr(Hsq, H);
    f2_sqr(Rsq, R);
    f2_mul(Hcu, H, Hsq);
    f2_mul(V, T.x, Hsq);
    f2_mul(HZ, H, T.z);
    f2_sub(X3, Rsq, Hcu);
    f2_add(t, V, V);
    f2_sub(X3, X3, t);
    f2_sub(t, V, X3);
    f2_mul(Y3, R, t);
    f2_mul(t, T.y, Hcu);
    f2_sub(Y3, Y3, t);
    f2_mul(t, R, xq);
    f2_mul(u, HZ, yq);
    f2_sub(l3, t, u);
    f2_mul_xi(t, HZ);
    f2_mul_fp(l0, t, yp);
    f2_mul_fp(t, R, xp);
    f2_neg(l5, t);
    T.x = X3;
    T.y = Y3;
    T.z = HZ;
}

template <typename F>
__device__ __noinline__ void miller(fp12_t<F> &f, const fp2_t<F> &xq, const fp2_t<F> &yq,
                                    const F &xp, const F &yp) {
    jac<fp2_t<F>> T;
    T.x = xq;
    T.y = yq;
    f2_set_one(T.z);
    fp2_t<F> l0, l3, l5;
    f12_set_one(f);
#pragma unroll 1
    for (int i = 62; i >= 0; --i) {  // the bits of |x| below its top one
        dbl_step(T, l0, l3, l5, xp, yp);
        f12_sqr(f, f);
        f12_mul_sparse035(f, f, l0, l3, l5);
        if ((X_ABS >> i) & 1) {
            add_step(T, l0, l3, l5, xq, yq, xp, yp);
            f12_mul_sparse035(f, f, l0, l3, l5);
        }
    }
    f12_conj(f, f);
}

template <typename B>
__global__ void __launch_bounds__(item_threads<B>())
    miller_loop_kernel(const uint32_t *__restrict__ q, const uint32_t *__restrict__ p,
                       uint32_t *out, long long n) {
    field_prologue((B *)nullptr);
    constexpr int W = B::WORDS;
    long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / B::LANES;
    if (i >= n) return;
    fp2_t<B> xq, yq;
    B xp, yp;
    fload(xq, q + (2 * i) * 2 * W);
    fload(yq, q + (2 * i + 1) * 2 * W);
    fload(xp, p + (2 * i) * W);
    fload(yp, p + (2 * i + 1) * W);
    fp12_t<B> f;
    miller(f, xq, yq, xp, yp);
    f12_store(out + 12 * W * i, f);
}

constexpr int TAIL_THREADS = 256;

// Tree-multiplies the k Fp12 values m[0..k) into m[0], in place: at each
// level value i takes value i + ceil(k/2), unit u the products i = u, u + U,
// ... (U units). Every thread of the block calls.
template <typename B>
__device__ void f12_tree_product(uint32_t *m, long long k) {
    constexpr int W = 12 * B::WORDS;
    const int u = threadIdx.x / B::LANES, units = blockDim.x / B::LANES;
    while (k > 1) {
        long long half = (k + 1) / 2;
        for (long long i = u; i < k - half; i += units) {
            fp12_t<B> a, b;
            f12_load(a, m + W * i);
            f12_load(b, m + W * (i + half));
            f12_mul(a, a, b);
            f12_store(m + W * i, a);
        }
        __syncthreads();
        k = half;
    }
}

__global__ void f12_product_kernel(uint32_t *m, long long n) { f12_tree_product<fp>(m, n); }

template <typename B>
__global__ void __launch_bounds__(TAIL_THREADS)
    final_exp_kernel(uint32_t *m, const uint32_t *m2, uint32_t *out, int *ok, long long n,
                     int mode) {
    field_prologue((B *)nullptr);
    constexpr int W = 12 * B::WORDS;
    if (mode == 1) {
        long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / B::LANES;
        if (i >= n) return;
        fp12_t<B> f, g;
        f12_load(f, m + W * i);
        if (m2) {
            f12_load(g, m2 + W * i);
            f12_mul(f, f, g);
        }
        final_exponentiation(f, f);
        f12_store(out + W * i, f);
        bool one = f12_is_one(f);
        if (threadIdx.x % B::LANES == 0) ok[i] = one ? 1 : 0;
        return;
    }
    f12_tree_product<B>(m, n);
    if (threadIdx.x < B::LANES) {
        fp12_t<B> f;
        f12_load(f, m);
        final_exponentiation(f, f);
        f12_store(out, f);
        bool one = f12_is_one(f);
        if (threadIdx.x == 0) ok[0] = one ? 1 : 0;
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
        const int threads = item_threads<B>(), per_block = threads / B::LANES;
        miller_loop_kernel<B><<<(unsigned)((n + per_block - 1) / per_block), threads, 0,
                                (cudaStream_t)stream>>>((const uint32_t *)q, (const uint32_t *)p,
                                                        (uint32_t *)out, n);
    }
    return (int)cudaGetLastError();
}

template <typename B>
static int final_exp_entry(void *m, const void *m2, void *out, void *ok, long long n,
                           long long mode, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (mode == 1) {
            const int threads = item_threads<B>(), per_block = threads / B::LANES;
            final_exp_kernel<B><<<(unsigned)((n + per_block - 1) / per_block), threads, 0, s>>>(
                (uint32_t *)m, (const uint32_t *)m2, (uint32_t *)out, (int *)ok, n, 1);
        } else {
            final_exp_kernel<B><<<1, TAIL_THREADS, 0, s>>>((uint32_t *)m, nullptr,
                                                           (uint32_t *)out, (int *)ok, n, 0);
        }
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
// m[0]; no exponentiation. One block.
extern "C" int f12_product(void *m, long long n, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (n > 0)
        f12_product_kernel<<<1, TAIL_THREADS, 0, (cudaStream_t)stream>>>((uint32_t *)m, n);
    return (int)cudaGetLastError();
}
