// The point work of the randomized batch check, one thread a point.
//
// K9 rlc_ladders: per item [z]·pk over G1 and [z]·sig over G2 with 2-bit
// windows (64-bit z, 32 windows), threads [0, n) on G1 and [n, 2n) on G2 of
// one launch; the G1 result is made affine in the same thread (ungrouped
// path) or kept Jacobian for K10 (grouped path). Replaces
// consensus_specs_tpu/ops/bls12_jax.py:782 `g1_scalar_mul_batch`, :957
// `g2_scalar_mul_batch`, :868 `_g1_jacobian_to_affine_batch`, and the
// ladders of :1157 `rlc_randomize_g1` and :1164 `rlc_collapse_g2`.
//
// K10 point_sums: one block a segment [off[d], off[d+1]) of Jacobian points
// (segments in order, sorted by the caller): each of the block's threads
// adds a strided share, the shares meet in a tree in shared memory
// (curve.cuh's block_tree_sum, which K13's window sums share), thread 0
// makes the sum affine. An empty segment sums to infinity and comes out
// (0, 0) (inv(0) = 0); `pairing_check_rlc` fails such a batch from the
// segment counts. G2 with one segment is the bilinearity collapse (:1014 +
// :1043), G1 with D segments the grouped path's sum by message (:1172,
// :1195); two template instances. The tree order differs from JAX's; the
// affine result, being canonical, does not.
//
// Bound: operations (Fp products). A ladder is about 95 point operations of
// 7-16 products each in one thread; the card holds 16,896 lanes and the
// batches here are 256-2048 items, so both kernels are latency-bound far
// from the card's operation rate (chip_smoke.py reports the ratio).
#include <cuda_runtime.h>

#include "curve.cuh"
#include "stack.cuh"

__global__ void rlc_ladders_kernel(const fp *__restrict__ p, const fp2 *__restrict__ q,
                                   const uint32_t *__restrict__ z, fp *g1, fp2 *g2,
                                   long long n, int has_g1, int has_g2, int affine) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long n1 = has_g1 ? n : 0;
    if (t < n1) {
        jac<fp> pt, r;
        pt.x = p[2 * t];
        pt.y = p[2 * t + 1];
        fp_set_one(pt.z);
        jac_scalar_mul(r, pt, z + 2 * t, 32);
        if (affine) {
            jac_to_affine(g1[2 * t], g1[2 * t + 1], r);
        } else {
            g1[3 * t] = r.x;
            g1[3 * t + 1] = r.y;
            g1[3 * t + 2] = r.z;
        }
    } else if (has_g2 && t < n1 + n) {
        long long i = t - n1;
        jac<fp2> pt, r;
        pt.x = q[2 * i];
        pt.y = q[2 * i + 1];
        f2_set_one(pt.z);
        jac_scalar_mul(r, pt, z + 2 * i, 32);
        g2[3 * i] = r.x;
        g2[3 * i + 1] = r.y;
        g2[3 * i + 2] = r.z;
    }
}

constexpr int SUM_THREADS = 64;

template <typename F>
__global__ void point_sums_kernel(const jac<F> *__restrict__ pts, const long long *__restrict__ off,
                                  F *out) {
    __shared__ jac<F> part[SUM_THREADS];
    int d = blockIdx.x;
    const jac<F> *seg = pts + off[d];
    block_tree_sum(part, off[d + 1] - off[d], [&](long long i, jac<F> &e) {
        e = seg[i];
        return true;
    });
    if (threadIdx.x == 0) jac_to_affine(out[2 * d], out[2 * d + 1], part[0]);
}

extern "C" int rlc_ladders(const void *p, const void *q, const void *z, void *g1, void *g2,
                           long long n, long long has_g1, long long has_g2, long long affine,
                           void *stream) {
    int e = ensure_stack();
    if (e) return e;
    long long items = n * ((has_g1 ? 1 : 0) + (has_g2 ? 1 : 0));
    if (items > 0) {
        const int threads = 64;
        unsigned blocks = (unsigned)((items + threads - 1) / threads);
        rlc_ladders_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const fp *)p, (const fp2 *)q, (const uint32_t *)z, (fp *)g1, (fp2 *)g2, n,
            (int)has_g1, (int)has_g2, (int)affine);
    }
    return (int)cudaGetLastError();
}

extern "C" int point_sums(const void *pts, const void *off, void *out, long long d,
                          long long is_g2, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (d > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (is_g2)
            point_sums_kernel<fp2><<<(unsigned)d, SUM_THREADS, 0, s>>>(
                (const jac<fp2> *)pts, (const long long *)off, (fp2 *)out);
        else
            point_sums_kernel<fp><<<(unsigned)d, SUM_THREADS, 0, s>>>(
                (const jac<fp> *)pts, (const long long *)off, (fp *)out);
    }
    return (int)cudaGetLastError();
}
