// K1 sha256_64b: sha256 of M independent 64-byte messages, (M, 16) words in,
// (M, 8) words out, one thread per message. A Merkle level is one launch
// over the (2P, 8) -> (P, 16) reshape of its nodes.
//
// Replaces consensus_specs_tpu/ops/sha256_jax.py:84 `sha256_64B_words` (and
// `merkle_parent_level`, :102). Bound: integer instruction throughput, not
// memory. Each message moves 96 bytes but costs two 64-round compressions
// (about 2,300 integer instructions), so the kernel keeps everything in
// registers and reads its 64 bytes with four 16-byte loads.
#include <cuda_runtime.h>
#include "sha256.cuh"

__global__ void sha256_64b_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                                  long long m) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    uint32_t w[16], h[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint4 v = in[i * 4 + q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    sha256_64B(w, h);
    out[i * 2] = make_uint4(h[0], h[1], h[2], h[3]);
    out[i * 2 + 1] = make_uint4(h[4], h[5], h[6], h[7]);
}

extern "C" int sha256_64b(const void* in, void* out, long long m, void* stream) {
    if (m > 0) {
        const int threads = 128;
        unsigned blocks = (unsigned)((m + threads - 1) / threads);
        sha256_64b_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint4*)in, (uint4*)out, m);
    }
    return (int)cudaGetLastError();
}
