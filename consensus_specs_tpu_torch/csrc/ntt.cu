// K22 fr_ntt and K23 fr_ops: the NTT over the BLS12-381 scalar field and
// the field's elementwise ops, on (.., 8) int32 words (fr.cuh).
//
// K22 replaces consensus_specs_tpu/ops/fr_jax.py:106 `make_ntt` ->
// `_ntt_impl` (:90): the bit-reverse permutation (:81), log2 n radix-2 DIT
// stages over the per-stage twiddle tables (:65), and for the inverse a
// product by 1/n (:114, :120). The TPU program runs each stage as one
// vectorised butterfly pass over the batch.
//
// Here the stages go in passes through shared memory, each pass one grid.
// After the bit-reverse gather, DIT stage s pairs i and i + 2^s inside
// blocks of 2^(s+1), so stages s0 .. s1-1 change only bits s0 .. s1-1 of an
// element's index: a pass over them is independent per group of elements
// that share the other bits. Pass A (s0 = 0) takes a contiguous tile of 2^t
// elements, gathered from the input at bit-reversed positions (tile j's
// element i is input[rev(j·2^t + i)], a stride of 2^(log2 n - t) from
// rev(j): one 32-byte sector a read). A later pass over stages s0 .. s1-1
// takes C = 2^logc consecutive columns c (the low s0 bits) and every row
// (bits s0 .. s1-1): a row of C elements is C·32 bytes, contiguous. The twiddle
// of stage s for the lower element i is tw[2^s - 1 + (i mod 2^s)], the flat
// table of ops/fr.py. One thread a butterfly a stage, `__syncthreads`
// between stages; the last stage of a pass writes to global memory. The
// plan (`ntt_passes`, mirrored by ops/fr.py's): pass A over t stages, then
// passes of at most NTT_PASS_STAGES stages with logc = min(NTT_COLS_LOG,
// s0); at the DAS widths t = 8 gives two grids (2^14: 64 tiles of 8 KB, 64
// column groups of 8 KB; 2^15: 128 tiles, 64 column groups of 16 KB).
//
// Shared memory holds an element as two 16-byte halves in two planes, so
// eight threads on consecutive elements read 128 consecutive bytes (no bank
// conflict from the 32-byte stride of a whole element).
//
// The entry takes two optional constant rows: `pre` multiplies every
// gathered input (R^2 mod r: canonical words into the Montgomery domain)
// and `post` both outputs of the last stage (1/n for the inverse; 1 out of
// the Montgomery domain; canonical n^-1 for both at once, since
// mont(y·R, n^-1) = y·n^-1). Every value stays canonical, so any correct
// order of butterflies gives the words of the plain version. Indices are
// 64-bit. Bound: operations at the DAS widths ((n/2)·log2 n Fr products a
// transform, plus n for each constant row, against 64 B an element read and
// written once); two passes move the array through device memory twice.
//
// K23 replaces the Fr field's batched ops (limb_mont.py:39 as fr_jax.py
// binds it): mul, add, sub, inv by op code, one thread an element; op 4 is
// the inverse of canonical words to canonical words (a product by R^2 mod
// r, Fermat's chain, a product by 1). Each op code is its own template
// instance, so the product's instance is straight-line code whose SASS
// count is the instructions of one Fr product (chip_smoke.py's unit of
// K22's bound).
#include <cuda_runtime.h>

#include "fr.cuh"

#define NTT_PASS_STAGES 8  // stages of a pass after the first
#define NTT_COLS_LOG 2     // a later pass's columns: 4, a 128-byte row
#define NTT_GROUP_LOG 10   // at most 1,024 elements (32 KB) a block

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
    } else if (OP == 3) {
        fr_inv(r, x);
    } else {
        fr c;
#pragma unroll
        for (int j = 0; j < 8; ++j) c.w[j] = FR_R2[j];
        fr_mul(x, x, c);
        fr_inv(r, x);
#pragma unroll
        for (int j = 0; j < 8; ++j) c.w[j] = j == 0;
        fr_mul(r, r, c);
    }
    out[i] = r;
}

FR_INLINE void sh_load(fr &x, const uint4 *lo, const uint4 *hi, int e) {
    uint4 a = lo[e], b = hi[e];
    x.w[0] = a.x, x.w[1] = a.y, x.w[2] = a.z, x.w[3] = a.w;
    x.w[4] = b.x, x.w[5] = b.y, x.w[6] = b.z, x.w[7] = b.w;
}

FR_INLINE void sh_store(uint4 *lo, uint4 *hi, int e, const fr &x) {
    lo[e] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
    hi[e] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
}

// One pass of K22 over stages s0 .. s1-1: a block a group of 2^g elements,
// g = s1 - s0 + logc, and 2^(g-1) threads. Group `grp` of transform b holds
// the elements hi·2^s1 + m·2^s0 + lo0 + c (m a row, c < 2^logc a column),
// at e = m·2^logc + c in shared memory. Pass A (s0 = 0) reads the input at
// bit-reversed positions; `pre` and `post` as in the file comment (`pre`
// only in pass A, `post` only on the transform's last stage, s1 = logn).
__global__ void fr_ntt_pass(const fr *src, fr *dst,
                            const fr *__restrict__ tw, const fr *__restrict__ pre,
                            const fr *__restrict__ post, int logn, int s0, int s1, int logc) {
    extern __shared__ uint4 ntt_smem[];
    const int g = s1 - s0 + logc;
    uint4 *lo = ntt_smem, *hi = ntt_smem + (1 << g);
    const long long groups_log = logn - g;
    const long long blk = blockIdx.x;
    const long long b = blk >> groups_log;
    const long long grp = blk & ((1LL << groups_log) - 1);
    const long long hi_part = (grp >> (s0 - logc)) << s1;
    const long long lo0 = (grp & ((1LL << (s0 - logc)) - 1)) << logc;
    const long long base = b << logn;
    const int cmask = (1 << logc) - 1;
    for (int e = threadIdx.x; e < (1 << g); e += blockDim.x) {
        long long i = hi_part + ((long long)(e >> logc) << s0) + lo0 + (e & cmask);
        if (s0 == 0) i = (long long)(__brevll((unsigned long long)i) >> (64 - logn));
        fr x = src[base + i];
        if (pre) fr_mul(x, x, *pre);
        sh_store(lo, hi, e, x);
    }
    __syncthreads();
    const int k = threadIdx.x;
    const int c = k & cmask, q = k >> logc;
    for (int s = s0; s < s1; ++s) {
        const int ls = s - s0, h = 1 << ls;
        const int m0 = ((q >> ls) << (ls + 1)) + (q & (h - 1));
        const int e0 = (m0 << logc) + c, e1 = e0 + (h << logc);
        fr x0, x1, w, p, y0, y1;
        sh_load(x0, lo, hi, e0);
        sh_load(x1, lo, hi, e1);
        const long long j = ((long long)(q & (h - 1)) << s0) + lo0 + c;
        w = tw[(1LL << s) - 1 + j];
        fr_mul(p, x1, w);
        fr_add(y0, x0, p);
        fr_sub(y1, x0, p);
        if (s + 1 < s1) {  // a thread writes back only the pair it read
            sh_store(lo, hi, e0, y0);
            sh_store(lo, hi, e1, y1);
            __syncthreads();
        } else {
            if (post) {
                fr_mul(y0, y0, *post);
                fr_mul(y1, y1, *post);
            }
            long long i0 = base + hi_part + ((long long)m0 << s0) + lo0 + c;
            dst[i0] = y0;
            dst[i0 + (1LL << s)] = y1;
        }
    }
}

// n = 1: no stage; the output is the input times pre and post, where set.
__global__ void fr_ntt_single(const fr *__restrict__ src, fr *__restrict__ dst,
                              const fr *__restrict__ pre, const fr *__restrict__ post,
                              long long batch) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= batch) return;
    fr x = src[t];
    if (pre) fr_mul(x, x, *pre);
    if (post) fr_mul(x, x, *post);
    dst[t] = x;
}

// ---- launchers (host code) ----

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
            case 4: launch_ops<4>(a, b, out, n, b_step, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

// in, out: (batch, 2^logn, 8) int32, not overlapping (after pass A the
// later passes work in place on out); tw: the flat (2^logn - 1, 8) twiddle
// table; pre, post: (8,) constant rows or null; t: pass A's stages
// (ops/fr.py's `ntt_tile_log`), 1 <= t <= min(logn, NTT_GROUP_LOG).
extern "C" int fr_ntt(const void *in, void *out, const void *tw, const void *pre,
                      const void *post, long long batch, long long logn, long long t,
                      void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (logn < 0 || logn > 32) return (int)cudaErrorInvalidValue;
    if (batch <= 0) return (int)cudaGetLastError();
    if (logn == 0) {
        const int threads = 128;
        unsigned blocks = (unsigned)((batch + threads - 1) / threads);
        fr_ntt_single<<<blocks, threads, 0, s>>>((const fr *)in, (fr *)out, (const fr *)pre,
                                                 (const fr *)post, batch);
        return (int)cudaGetLastError();
    }
    if (t < 1 || t > logn || t > NTT_GROUP_LOG) return (int)cudaErrorInvalidValue;
    for (int s0 = 0, s1 = (int)t; s0 < logn; s0 = s1) {
        if (s0 > 0) s1 = s0 + NTT_PASS_STAGES < logn ? s0 + NTT_PASS_STAGES : (int)logn;
        const int logc = s0 == 0 ? 0 : (s0 < NTT_COLS_LOG ? s0 : NTT_COLS_LOG);
        const int g = s1 - s0 + logc;
        const long long blocks = batch << (logn - g);
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        fr_ntt_pass<<<(unsigned)blocks, 1 << (g - 1), (size_t)32 << g, s>>>(
            s0 == 0 ? (const fr *)in : (const fr *)out, (fr *)out, (const fr *)tw,
            s0 == 0 ? (const fr *)pre : nullptr, s1 == logn ? (const fr *)post : nullptr,
            (int)logn, s0, s1, logc);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}
