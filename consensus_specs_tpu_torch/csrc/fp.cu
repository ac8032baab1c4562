// K8 fp_ops: one Fp operation, chosen by op code, over M elements, one thread
// an element: mul, sqr, add, sub, neg, inv (Fermat), sqrt candidate
// (a^((p+1)/4)). Words in and out: (M, 12) int32 bit patterns.
//
// Replaces consensus_specs_tpu/ops/limb_mont.py:39 `MontgomeryField` and
// ops/fp_jax.py:70-125 as batched ops. On the BLS flush it converts the
// canonical coordinates of every point to the Montgomery domain in one
// launch (a product by R^2 mod p), which the JAX package does on the host
// (crypto/bls_jax.py:304 `ints_to_mont_batch`). Each op code is its own
// template instance, so the product's instance is straight-line code whose
// SASS count is the instructions of one Fp product (chip_smoke.py's unit of
// the BLS kernels' operation bounds). Bound: operations for mul/sqr/inv/
// sqrt, bytes (72 B an element for add/sub) for the rest.
#include <cuda_runtime.h>

#include "fp.cuh"

template <int OP>
__global__ void fp_ops_kernel(const fp *__restrict__ a, const fp *__restrict__ b,
                              fp *__restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fp x = a[i], r;
    if (OP == 0) {
        fp y = b[i];
        fp_mul_inl(r, x, y);
    } else if (OP == 1) {
        fp_mul_inl(r, x, x);
    } else if (OP == 2) {
        fp y = b[i];
        fp_add(r, x, y);
    } else if (OP == 3) {
        fp y = b[i];
        fp_sub(r, x, y);
    } else if (OP == 4) {
        fp_neg(r, x);
    } else if (OP == 5) {
        fp_inv(r, x);
    } else {
        fp_sqrt_candidate(r, x);
    }
    out[i] = r;
}

template <int OP>
static void launch(const void *a, const void *b, void *out, long long n, cudaStream_t s) {
    const int threads = 128;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    fp_ops_kernel<OP><<<blocks, threads, 0, s>>>((const fp *)a, (const fp *)b, (fp *)out, n);
}

extern "C" int fp_ops(const void *a, const void *b, void *out, long long n, long long op,
                      void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        switch (op) {
            case 0: launch<0>(a, b, out, n, s); break;
            case 1: launch<1>(a, b, out, n, s); break;
            case 2: launch<2>(a, b, out, n, s); break;
            case 3: launch<3>(a, b, out, n, s); break;
            case 4: launch<4>(a, b, out, n, s); break;
            case 5: launch<5>(a, b, out, n, s); break;
            case 6: launch<6>(a, b, out, n, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
