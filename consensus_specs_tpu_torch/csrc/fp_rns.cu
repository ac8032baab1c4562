// K24 rns_ops: one operation of the RNS field (fp_rns.cuh), chosen by op
// code, over M elements, one thread an element. Residues in and out:
// (M, 64) int32; sum_stack reads (k, M, 64), k <= 8; is_zero and is_one_mont
// write one byte an element (torch.bool).
//
// Op codes (ops/fp_rns.py): 0 add, 1 sub, 2 neg, 3 mul_wide, 4 mont_reduce,
// 5 mont_mul, 6 the power ladder for p - 2 (Fermat's inverse), 7 for
// (p + 1)/4 (the square-root candidate), 8 sum_stack, 9 is_zero,
// 10 is_one_mont. Replaces consensus_specs_tpu/ops/fp_rns.py's field ops
// (see fp_rns.cuh); on the BLS flush under the "rns" field backend every
// field operation of ops/bls12_field.py is one launch of this kernel.
//
// Each op code is its own template instance, so the product's instance
// (5) is straight-line code whose SASS count is the instructions of one RNS
// Montgomery product (chip_smoke.py's unit of K24's bound). A whole power
// ladder is one launch: 381 (379) squarings, each followed by the product.
// Elements load and store as int4 (16 bytes a thread a step). Bound:
// operations for the ladders (6, 7) and the class compares (9, 10); bytes
// for the rest, mont_mul and mont_reduce included (fp_rns.cuh).
#include <cuda_runtime.h>

#include "fp_rns.cuh"

RNS_INLINE void load(rns &x, const int *p) {
    const int4 *q = (const int4 *)p;
#pragma unroll
    for (int k = 0; k < RNS_N / 4; k++) {
        int4 w = q[k];
        x.v[4 * k] = w.x;
        x.v[4 * k + 1] = w.y;
        x.v[4 * k + 2] = w.z;
        x.v[4 * k + 3] = w.w;
    }
}

RNS_INLINE void store(int *p, const rns &x) {
    int4 *q = (int4 *)p;
#pragma unroll
    for (int k = 0; k < RNS_N / 4; k++)
        q[k] = make_int4(x.v[4 * k], x.v[4 * k + 1], x.v[4 * k + 2], x.v[4 * k + 3]);
}

template <int OP>
__global__ void rns_ops_kernel(const int *__restrict__ a, const int *__restrict__ b,
                               void *__restrict__ out, long long n, int k) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rns x, r;
    if (OP == 8) {  // sum_stack: k rows of (n, 64), summed then reduced
#pragma unroll
        for (int c = 0; c < RNS_N; c++) r.v[c] = 0;
#pragma unroll 1
        for (int j = 0; j < k; j++) {
            load(x, a + ((long long)j * n + i) * RNS_N);
#pragma unroll
            for (int c = 0; c < RNS_N; c++) r.v[c] += x.v[c];
        }
#pragma unroll
        for (int c = 0; c < RNS_N; c++)
            r.v[c] = (int)rns_red_small((uint32_t)r.v[c], (uint32_t)RNS_M[c],
                                        (uint32_t)RNS_DELTA[c]);
        store((int *)out + i * RNS_N, r);
        return;
    }
    load(x, a + i * RNS_N);
    if (OP == 9 || OP == 10) {
        ((unsigned char *)out)[i] = rns_in_classes(x, OP == 9 ? RNS_ZERO_CLASSES : RNS_ONE_CLASSES);
        return;
    }
    if (OP == 0 || OP == 1 || OP == 3 || OP == 5) {
        rns y;
        load(y, b + i * RNS_N);
        if (OP == 0) rns_add(r, x, y);
        if (OP == 1) rns_sub(r, x, y);
        if (OP == 3) rns_mul_wide(r, x, y);
        if (OP == 5) rns_mont_mul(r, x, y);
    } else if (OP == 2) {
        rns_neg(r, x);
    } else if (OP == 4) {
        rns_mont_reduce(r, x);
    } else if (OP == 6) {
        rns_pow(r, x, RNS_EXP_INV, RNS_EXP_INV_BITS);
    } else {
        rns_pow(r, x, RNS_EXP_SQRT, RNS_EXP_SQRT_BITS);
    }
    store((int *)out + i * RNS_N, r);
}

template <int OP>
static void launch(const void *a, const void *b, void *out, long long n, int k, cudaStream_t s) {
    const int threads = 128;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    rns_ops_kernel<OP><<<blocks, threads, 0, s>>>((const int *)a, (const int *)b, out, n, k);
}

extern "C" int rns_ops(const void *a, const void *b, void *out, long long n, long long op,
                       long long k, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        switch (op) {
            case 0: launch<0>(a, b, out, n, (int)k, s); break;
            case 1: launch<1>(a, b, out, n, (int)k, s); break;
            case 2: launch<2>(a, b, out, n, (int)k, s); break;
            case 3: launch<3>(a, b, out, n, (int)k, s); break;
            case 4: launch<4>(a, b, out, n, (int)k, s); break;
            case 5: launch<5>(a, b, out, n, (int)k, s); break;
            case 6: launch<6>(a, b, out, n, (int)k, s); break;
            case 7: launch<7>(a, b, out, n, (int)k, s); break;
            case 8: launch<8>(a, b, out, n, (int)k, s); break;
            case 9: launch<9>(a, b, out, n, (int)k, s); break;
            case 10: launch<10>(a, b, out, n, (int)k, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
