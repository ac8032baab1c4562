// K24 rns_ops: one operation of the RNS field (fp_rns.cuh), chosen by op
// code, over M elements, one warp an element (lane c: residues c and
// 32 + c). Residues in and out: (M, 64) int32; sum_stack reads (k, M, 64),
// k <= 8; is_zero and is_one_mont write one byte an element (torch.bool).
//
// Op codes (ops/fp_rns.py): 0 add, 1 sub, 2 neg, 3 mul_wide, 4 mont_reduce,
// 5 mont_mul, 6 the power ladder for p - 2 (Fermat's inverse), 7 for
// (p + 1)/4 (the square-root candidate), 8 sum_stack, 9 is_zero,
// 10 is_one_mont. Replaces consensus_specs_tpu/ops/fp_rns.py's field ops
// (see fp_rns.cuh). The BLS flush's "rns" field runs the fused kernels
// K9-K12 over the same field (rlc.cu, pairing.cu); K24 is the field op by
// op, held against ops/fp_rns.rns_ops_plain.
//
// Each op code is its own template instance. A whole power ladder is one
// launch: 381 (379) squarings and the products where the exponent's bit is
// set. Each half of an element is one 128-byte warp transaction. Bound:
// operations for the ladders (6, 7) and the class compares (9, 10); bytes
// for the rest, mont_mul and mont_reduce included (fp_rns.cuh).
#include <cuda_runtime.h>

#include "fp_rns.cuh"

constexpr int OPS_WARPS = 4;  // elements a block

template <int OP>
__global__ void __launch_bounds__(OPS_WARPS * 32)
    rns_ops_kernel(const uint32_t *__restrict__ a, const uint32_t *__restrict__ b,
                   void *__restrict__ out, long long n, int k) {
    rns_load_tables();
    long long i = (long long)blockIdx.x * OPS_WARPS + threadIdx.x / 32;
    if (i >= n) return;  // the whole warp
    rns_w x, r;
    if (OP == 8) {  // sum_stack: k rows of (n, 64), summed then reduced
        r.a = r.b = 0;
#pragma unroll 1
        for (int j = 0; j < k; j++) {
            fp_load(x, a + ((long long)j * n + i) * RNS_N);
            r.a += x.a;
            r.b += x.b;
        }
        r.a = (int)rns_red_small((uint32_t)r.a, (uint32_t)rns_v(RV_MA));
        r.b = (int)rns_red_small((uint32_t)r.b, (uint32_t)rns_v(RV_MB));
        fp_store((uint32_t *)out + i * RNS_N, r);
        return;
    }
    fp_load(x, a + i * RNS_N);
    if (OP == 9 || OP == 10) {
        bool v = OP == 9 ? fp_is_zero(x) : fp_is_one(x);
        if (rns_lane() == 0) ((unsigned char *)out)[i] = v;
        return;
    }
    if (OP == 0 || OP == 1 || OP == 3 || OP == 5) {
        rns_w y;
        fp_load(y, b + i * RNS_N);
        if (OP == 0) fp_add(r, x, y);
        if (OP == 1) fp_sub(r, x, y);
        if (OP == 3) rns_mul_wide(r, x, y);
        if (OP == 5) fp_mul(r, x, y);
    } else if (OP == 2) {
        fp_neg(r, x);
    } else if (OP == 4) {
        rns_mont_reduce(r, x);
    } else if (OP == 6) {
        fp_inv(r, x);
    } else {
        fp_sqrt_candidate(r, x);
    }
    fp_store((uint32_t *)out + i * RNS_N, r);
}

template <int OP>
static void launch(const void *a, const void *b, void *out, long long n, int k, cudaStream_t s) {
    unsigned blocks = (unsigned)((n + OPS_WARPS - 1) / OPS_WARPS);
    rns_ops_kernel<OP><<<blocks, OPS_WARPS * 32, 0, s>>>((const uint32_t *)a, (const uint32_t *)b,
                                                         out, n, k);
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
