// The root of one Validator container, as a device function shared by K2
// (state_root.cu, every validator) and K7 (incremental_root.cu, the dirty
// rows), so both hash a container with one code path.
//
// The six dynamic leaves are built in registers (the SSZ uint64 chunk is
// bswap32(low) || bswap32(high) || zeros; the boolean leaf is its byte
// << 24) and the 8-leaf container tree is 7 64-byte hashes: h01, h23,
// h45, h67, h0123, h4567, root. The hashing order keeps at most two 8-word
// results live besides the 16-word message.
#pragma once
#include "sha256.cuh"

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// msg[0..8) <- SSZ chunk of one uint64
__device__ __forceinline__ void u64_chunk(u64 v, uint32_t* msg) {
    msg[0] = bswap32((uint32_t)v);
    msg[1] = bswap32((uint32_t)(v >> 32));
#pragma unroll
    for (int k = 2; k < 8; ++k) msg[k] = 0;
}

// The registry columns a container root reads, in K2's argument order.
struct ValidatorCols {
    const uint4* static01;  // (N, 16) words: hash_tree_root(pubkey) || withdrawal credentials
    const u64* eff;
    const u64* aee;
    const u64* act;
    const u64* ext;
    const u64* wd;
    const bool* slashed;
};

// root <- hash_tree_root(Validator i)
__device__ __forceinline__ void validator_root(const ValidatorCols& c, long long i,
                                               uint32_t root[8]) {
    uint32_t msg[16], right[8], l2[8], r2[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint4 v = c.static01[i * 4 + q];
        msg[4 * q] = v.x; msg[4 * q + 1] = v.y; msg[4 * q + 2] = v.z; msg[4 * q + 3] = v.w;
    }
    sha256_64B(msg, root);                      // h01
    u64_chunk(c.eff[i], msg);
    msg[8] = c.slashed[i] ? 0x01000000u : 0u;
#pragma unroll
    for (int k = 9; k < 16; ++k) msg[k] = 0;
    sha256_64B(msg, right);                     // h23
    sha256_pair(root, right, l2);               // h0123
    u64_chunk(c.aee[i], msg);
    u64_chunk(c.act[i], msg + 8);
    sha256_64B(msg, root);                      // h45
    u64_chunk(c.ext[i], msg);
    u64_chunk(c.wd[i], msg + 8);
    sha256_64B(msg, right);                     // h67
    sha256_pair(root, right, r2);               // h4567
    sha256_pair(l2, r2, root);                  // container root
}
