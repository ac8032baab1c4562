// The point work of the randomized batch check, templates over the base
// field: one thread a point over the limb field (csrc/fp.cuh), one warp a
// point over RNS (csrc/fp_rns.cuh); each launch takes its geometry from the
// field's lanes an element.
//
// K9 rlc_ladders: per item [z]·pk over G1 and [z]·sig over G2 with 2-bit
// windows (64-bit z, 32 windows), items [0, n) on G1 and [n, 2n) on G2 of
// one launch (under RNS they split on warp boundaries); the G1 result is
// made affine by the same thread or warp (ungrouped path) or kept Jacobian
// for K10 (grouped path). Replaces consensus_specs_tpu/ops/bls12_jax.py:782
// `g1_scalar_mul_batch`, :957 `g2_scalar_mul_batch`, :868
// `_g1_jacobian_to_affine_batch`, and the ladders of :1157
// `rlc_randomize_g1` and :1164 `rlc_collapse_g2`.
//
// K10 point_sums: one block a segment [off[d], off[d+1]) of Jacobian points
// (segments in order, sorted by the caller): each of the block's units (64
// threads, or 16 warps under RNS) adds a strided share, the shares meet in
// a tree in shared memory (curve.cuh's block_tree_sum, which K13's window
// sums share), unit 0 makes the sum affine. An empty segment sums to
// infinity and comes out (0, 0) (inv(0) = 0); `pairing_check_rlc` fails
// such a batch from the segment counts. G2 with one segment is the
// bilinearity collapse (:1014 + :1043), G1 with D segments the grouped
// path's sum by message (:1172, :1195); two template instances a field. The
// order is the plain version's (ops/bls12.py `segment_sums`), which RNS
// values need: their residues depend on it.
//
// Bound: operations (Fp products). A ladder is about 95 point operations of
// 7-16 products each in one thread (warp); the card holds 16,896 lanes and
// the batches here are 256-2048 items, so both kernels are latency-bound far
// from the card's operation rate (chip_smoke.py reports the ratio).
#include <cuda_runtime.h>

#include <type_traits>

#include "curve.cuh"
#include "stack.cuh"

template <typename B>
__global__ void __launch_bounds__(item_threads<B>())
    rlc_ladders_kernel(const uint32_t *__restrict__ p, const uint32_t *__restrict__ q,
                       const uint32_t *__restrict__ z, uint32_t *g1, uint32_t *g2, long long n,
                       int has_g1, int has_g2, int affine) {
    field_prologue((B *)nullptr);
    constexpr int W = B::WORDS;
    long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / B::LANES;
    long long n1 = has_g1 ? n : 0;
    if (t < n1) {
        jac<B> pt, r;
        fload(pt.x, p + (2 * t) * W);
        fload(pt.y, p + (2 * t + 1) * W);
        fset_one(pt.z);
        jac_scalar_mul(r, pt, z + 2 * t, 32);
        if (affine) {
            B x, y;
            jac_to_affine(x, y, r);
            fstore(g1 + (2 * t) * W, x);
            fstore(g1 + (2 * t + 1) * W, y);
        } else {
            fstore(g1 + (3 * t) * W, r.x);
            fstore(g1 + (3 * t + 1) * W, r.y);
            fstore(g1 + (3 * t + 2) * W, r.z);
        }
    } else if (has_g2 && t < n1 + n) {
        long long i = t - n1;
        jac<fp2_t<B>> pt, r;
        fload(pt.x, q + (2 * i) * 2 * W);
        fload(pt.y, q + (2 * i + 1) * 2 * W);
        fset_one(pt.z);
        jac_scalar_mul(r, pt, z + 2 * i, 32);
        fstore(g2 + (3 * i) * 2 * W, r.x);
        fstore(g2 + (3 * i + 1) * 2 * W, r.y);
        fstore(g2 + (3 * i + 2) * 2 * W, r.z);
    }
}

constexpr int SUM_THREADS = 64;  // K10's units over the limb field
constexpr int SUM_WARPS = 16;    // over RNS

template <typename B>
__host__ __device__ constexpr int sum_threads() {
    return B::LANES == 1 ? SUM_THREADS : SUM_WARPS * B::LANES;
}

// C: the coordinate field, B or Fp2 over it
template <typename B, bool G2>
__global__ void __launch_bounds__(sum_threads<B>())
    point_sums_kernel(const uint32_t *__restrict__ pts, const long long *__restrict__ off,
                      uint32_t *out) {
    using C = typename std::conditional<G2, fp2_t<B>, B>::type;
    constexpr int L = B::LANES, W = words_of<C>::value;
    __shared__ jac<C> part[sum_threads<B>()];
    field_prologue((B *)nullptr);
    int d = blockIdx.x;
    const uint32_t *seg = pts + off[d] * 3 * W;
    block_tree_sum(part, off[d + 1] - off[d], [&](long long i, jac<C> &e) {
        fload(e.x, seg + (3 * i) * W);
        fload(e.y, seg + (3 * i + 1) * W);
        fload(e.z, seg + (3 * i + 2) * W);
        return true;
    });
    if (threadIdx.x < L) {
        C x, y;
        jac_to_affine(x, y, part[threadIdx.x]);
        fstore(out + (2 * d) * W, x);
        fstore(out + (2 * d + 1) * W, y);
    }
}

template <typename B>
static int ladders(const void *p, const void *q, const void *z, void *g1, void *g2, long long n,
                   long long has_g1, long long has_g2, long long affine, void *stream) {
    int e = ensure_stack();
    if (e) return e;
    long long items = n * ((has_g1 ? 1 : 0) + (has_g2 ? 1 : 0));
    if (items > 0) {
        const int threads = item_threads<B>(), per_block = threads / B::LANES;
        unsigned blocks = (unsigned)((items + per_block - 1) / per_block);
        rlc_ladders_kernel<B><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint32_t *)p, (const uint32_t *)q, (const uint32_t *)z, (uint32_t *)g1,
            (uint32_t *)g2, n, (int)has_g1, (int)has_g2, (int)affine);
    }
    return (int)cudaGetLastError();
}

template <typename B>
static int sums(const void *pts, const void *off, void *out, long long d, long long is_g2,
                void *stream) {
    int e = ensure_stack();
    if (e) return e;
    if (d > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        if (is_g2)
            point_sums_kernel<B, true><<<(unsigned)d, sum_threads<B>(), 0, s>>>(
                (const uint32_t *)pts, (const long long *)off, (uint32_t *)out);
        else
            point_sums_kernel<B, false><<<(unsigned)d, sum_threads<B>(), 0, s>>>(
                (const uint32_t *)pts, (const long long *)off, (uint32_t *)out);
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

extern "C" int point_sums(const void *pts, const void *off, void *out, long long d,
                          long long is_g2, void *stream) {
    return sums<fp>(pts, off, out, d, is_g2, stream);
}

extern "C" int point_sums_rns(const void *pts, const void *off, void *out, long long d,
                              long long is_g2, void *stream) {
    return sums<rns_w>(pts, off, out, d, is_g2, stream);
}
