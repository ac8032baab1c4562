// K2 validator_roots: the N Validator container roots of the registry list,
// one thread per validator. Replaces the per-validator part of
// consensus_specs_tpu/engine/state_root.py:186 `_validators_root`.
//
// Each thread builds the six dynamic leaves in registers (the SSZ uint64
// chunk is bswap32(low) || bswap32(high) || zeros; the boolean leaf is its
// byte << 24) and runs the 7 64-byte hashes of the 8-leaf container tree:
// h01, h23, h45, h67, h0123, h4567, root. Only the (N, 8) roots are
// written; the TPU program kept five (N, 8) and several (N, 16)
// intermediates in device memory. Bound: integer instruction throughput
// (7 sha256 of a 64-byte message, about 16,000 integer instructions, per
// 137 bytes moved).
#include <cuda_runtime.h>
#include "sha256.cuh"

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// msg[off..off+8) <- SSZ chunk of one uint64
__device__ __forceinline__ void u64_chunk(u64 v, uint32_t* msg) {
    msg[0] = bswap32((uint32_t)v);
    msg[1] = bswap32((uint32_t)(v >> 32));
#pragma unroll
    for (int k = 2; k < 8; ++k) msg[k] = 0;
}

__global__ void validator_roots_kernel(const uint4* __restrict__ static01,
                                       const u64* __restrict__ eff, const u64* __restrict__ aee,
                                       const u64* __restrict__ act, const u64* __restrict__ ext,
                                       const u64* __restrict__ wd,
                                       const bool* __restrict__ slashed,
                                       uint4* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t msg[16], left[8], right[8], l2[8], r2[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint4 v = static01[i * 4 + q];
        msg[4 * q] = v.x; msg[4 * q + 1] = v.y; msg[4 * q + 2] = v.z; msg[4 * q + 3] = v.w;
    }
    sha256_64B(msg, left);                      // h01
    u64_chunk(eff[i], msg);
    msg[8] = slashed[i] ? 0x01000000u : 0u;
#pragma unroll
    for (int k = 9; k < 16; ++k) msg[k] = 0;
    sha256_64B(msg, right);                     // h23
    sha256_pair(left, right, l2);               // h0123
    u64_chunk(aee[i], msg);
    u64_chunk(act[i], msg + 8);
    sha256_64B(msg, left);                      // h45
    u64_chunk(ext[i], msg);
    u64_chunk(wd[i], msg + 8);
    sha256_64B(msg, right);                     // h67
    sha256_pair(left, right, r2);               // h4567
    sha256_pair(l2, r2, left);                  // container root
    out[i * 2] = make_uint4(left[0], left[1], left[2], left[3]);
    out[i * 2 + 1] = make_uint4(left[4], left[5], left[6], left[7]);
}

extern "C" int validator_roots(const void* static01, const void* eff, const void* aee,
                               const void* act, const void* ext, const void* wd,
                               const void* slashed, void* out, long long n, void* stream) {
    if (n > 0) {
        const int threads = 128;
        unsigned blocks = (unsigned)((n + threads - 1) / threads);
        validator_roots_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint4*)static01, (const u64*)eff, (const u64*)aee, (const u64*)act,
            (const u64*)ext, (const u64*)wd, (const bool*)slashed, (uint4*)out, n);
    }
    return (int)cudaGetLastError();
}
