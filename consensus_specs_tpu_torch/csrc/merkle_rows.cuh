// Row helpers of the Merkle folds (K19 in tree_root.cu, K20 in
// multiproof.cu): a row is one 32-byte node, eight big-endian sha words,
// read and written as two uint4.
#pragma once
#include <cuda_runtime.h>
#include "sha256.cuh"

// h <- sha256(left || right) for the two 8-word rows at p (four uint4).
__device__ __forceinline__ void hash_row_pair(const uint4* p, uint32_t h[8]) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint4 v = p[q];
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    sha256_64B(w, h);
}

__device__ __forceinline__ void store_row(uint4* p, const uint32_t h[8]) {
    p[0] = make_uint4(h[0], h[1], h[2], h[3]);
    p[1] = make_uint4(h[4], h[5], h[6], h[7]);
}
