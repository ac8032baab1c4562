// K22 fr_ntt and K23 fr_ops: the NTT over the BLS12-381 scalar field and
// the field's elementwise ops, on (.., 8) int32 Montgomery words (fr.cuh).
//
// K22 replaces consensus_specs_tpu/ops/fr_jax.py:106 `make_ntt` ->
// `_ntt_impl` (:90): the bit-reverse permutation (:81), log2 n radix-2 DIT
// stages over the per-stage twiddle tables (:65), and for the inverse a
// product by 1/n (:114, :120). The TPU program runs each stage as one
// vectorised butterfly pass over the batch. Here one entry call runs log2 n
// grids, one a stage, a thread a butterfly; the first stage reads its inputs
// at bit-reversed positions (the gather folds into it), the later stages
// work in place on the output, and for the inverse the last stage multiplies
// both of its outputs by 1/n (the same canonical value as JAX's separate
// product). Each thread reads its twiddle from the flat table in global
// memory: stage s (half-size 2^s) at offset 2^s - 1. Indices are 64-bit
// (B·n/2 can pass 2^31). Bound: operations at the DAS widths
// ((n/2)·log2 n Fr products a transform against 64 B an element read and
// written once); this first design also re-reads and re-writes the whole
// array at every stage, which a shared-memory or four-step design would
// keep on chip.
//
// K23 replaces the Fr field's batched ops (limb_mont.py:39 as fr_jax.py
// binds it): mul, add, sub, inv by op code, one thread an element. On the
// DAS path it converts to and from the Montgomery domain (a product by
// R^2 mod r and by 1). Each op code is its own template instance, so the
// product's instance is straight-line code whose SASS count is the
// instructions of one Fr product (chip_smoke.py's unit of K22's bound).
#include <cuda_runtime.h>

#include "fr.cuh"

template <int OP>
__global__ void fr_ops_kernel(const fr *__restrict__ a, const fr *__restrict__ b,
                              fr *__restrict__ out, long long n, long long b_step) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fr x = a[i], r;
    if (OP == 0) {
        fr y = b[i * b_step];
        fr_mul(r, x, y);
    } else if (OP == 1) {
        fr y = b[i * b_step];
        fr_add(r, x, y);
    } else if (OP == 2) {
        fr y = b[i * b_step];
        fr_sub(r, x, y);
    } else {
        fr_inv(r, x);
    }
    out[i] = r;
}

template <int OP>
static void launch_ops(const void *a, const void *b, void *out, long long n, long long b_step,
                       cudaStream_t s) {
    const int threads = 128;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fr_ops_kernel<OP><<<blocks, threads, 0, s>>>((const fr *)a, (const fr *)b, (fr *)out, n,
                                                 b_step);
}

extern "C" int fr_ops(const void *a, const void *b, void *out, long long n, long long op,
                      long long b_step, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        switch (op) {
            case 0: launch_ops<0>(a, b, out, n, b_step, s); break;
            case 1: launch_ops<1>(a, b, out, n, b_step, s); break;
            case 2: launch_ops<2>(a, b, out, n, b_step, s); break;
            case 3: launch_ops<3>(a, b, out, n, b_step, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

// One DIT stage: thread t owns butterfly k = t mod n/2 of transform
// b = t / (n/2). With src set (the first stage) it reads x[rev(i0)] and
// x[rev(i1)] of src; otherwise x[i0] and x[i1] of dst, in place. With scale
// set (the inverse's last stage) both outputs are multiplied by *scale.
__global__ void fr_ntt_stage(const fr *__restrict__ src, fr *dst, const fr *__restrict__ tw,
                             const fr *__restrict__ scale, long long butterflies, int logn,
                             int s) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= butterflies) return;
    long long k = t & ((1LL << (logn - 1)) - 1);
    long long base = (t >> (logn - 1)) << logn;
    long long half = 1LL << s;
    long long j = k & (half - 1);
    long long i0 = ((k >> s) << (s + 1)) + j;
    long long i1 = i0 + half;
    fr x0, x1;
    if (src) {
        x0 = src[base + (long long)(__brevll((unsigned long long)i0) >> (64 - logn))];
        x1 = src[base + (long long)(__brevll((unsigned long long)i1) >> (64 - logn))];
    } else {
        x0 = dst[base + i0];
        x1 = dst[base + i1];
    }
    fr w = tw[half - 1 + j], p, y0, y1;
    fr_mul(p, x1, w);
    fr_add(y0, x0, p);
    fr_sub(y1, x0, p);
    if (scale) {
        fr c = *scale;
        fr_mul(y0, y0, c);
        fr_mul(y1, y1, c);
    }
    dst[base + i0] = y0;
    dst[base + i1] = y1;
}

// n = 1: no stage; the output is the input, times 1/n = 1 for the inverse
// (a product by the Montgomery one, as JAX's).
__global__ void fr_ntt_single(const fr *__restrict__ src, fr *__restrict__ dst,
                              const fr *__restrict__ scale, long long batch) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= batch) return;
    fr x = src[t];
    if (scale) {
        fr c = *scale;
        fr_mul(x, x, c);
    }
    dst[t] = x;
}

// in, out: (batch, 2^logn, 8) int32, not overlapping; tw: the flat
// (2^logn - 1, 8) twiddle table; scale: (8,) 1/n for the inverse, else null.
extern "C" int fr_ntt(const void *in, void *out, const void *tw, const void *scale,
                      long long batch, long long logn, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (logn < 0 || logn > 32) return (int)cudaErrorInvalidValue;
    if (batch <= 0) return (int)cudaGetLastError();
    const int threads = 128;
    if (logn == 0) {
        unsigned blocks = (unsigned)((batch + threads - 1) / threads);
        fr_ntt_single<<<blocks, threads, 0, s>>>((const fr *)in, (fr *)out, (const fr *)scale,
                                                 batch);
        return (int)cudaGetLastError();
    }
    long long butterflies = batch << (logn - 1);
    unsigned blocks = (unsigned)((butterflies + threads - 1) / threads);
    for (int st = 0; st < (int)logn; ++st) {
        fr_ntt_stage<<<blocks, threads, 0, s>>>(
            st == 0 ? (const fr *)in : nullptr, (fr *)out, (const fr *)tw,
            st == logn - 1 ? (const fr *)scale : nullptr, butterflies, (int)logn, st);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}
