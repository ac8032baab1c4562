// K2 validator_roots: the N Validator container roots of the registry list,
// one thread per validator. Replaces the per-validator part of
// consensus_specs_tpu/engine/state_root.py:186 `_validators_root`.
//
// Each thread hashes its container with `validator_root` (validator.cuh,
// shared with K7): the six dynamic leaves in registers and the 7 64-byte
// hashes of the 8-leaf tree. Only the (N, 8) roots are written; the TPU
// program kept five (N, 8) and several (N, 16) intermediates in device
// memory. Bound: integer instruction throughput (7 sha256 of a 64-byte
// message, about 16,000 integer instructions, per 137 bytes moved).
#include <cuda_runtime.h>
#include "validator.cuh"

__global__ void validator_roots_kernel(ValidatorCols cols, uint4* __restrict__ out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t root[8];
    validator_root(cols, i, root);
    out[i * 2] = make_uint4(root[0], root[1], root[2], root[3]);
    out[i * 2 + 1] = make_uint4(root[4], root[5], root[6], root[7]);
}

extern "C" int validator_roots(const void* static01, const void* eff, const void* aee,
                               const void* act, const void* ext, const void* wd,
                               const void* slashed, void* out, long long n, void* stream) {
    if (n > 0) {
        const int threads = 128;
        unsigned blocks = (unsigned)((n + threads - 1) / threads);
        ValidatorCols cols = {(const uint4*)static01, (const u64*)eff, (const u64*)aee,
                              (const u64*)act, (const u64*)ext, (const u64*)wd,
                              (const bool*)slashed};
        validator_roots_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            cols, (uint4*)out, n);
    }
    return (int)cudaGetLastError();
}
