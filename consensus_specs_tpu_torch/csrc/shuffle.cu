// K5 shuffle_rounds: every round of the swap-or-not shuffle over all n
// indices in one launch, one thread per index.
//
// Replaces the round loop of consensus_specs_tpu/ops/shuffle.py:97
// `shuffled_index_map` (a `fori_loop` of `rounds` elementwise sweeps over
// the (n,) index vector, each a separate pass through device memory). The
// hashes stay outside: the per-round pivots and the per-(round, 256-index
// bucket) source digests come from K4 (sha256_1block) and are read here.
//
// Each index evolves independently across rounds (round r reads only that
// index's value after round r-1), so a thread keeps its index in a register
// for all rounds and writes it once. Per round it reads one digest word,
// chosen by the data: the sources are rounds x ceil(n/256) x 32 bytes
// (11.8 MB at n = 2**20, 90 rounds), which stays in the 50 MB L2, so the
// kernel is bound by L2 latency and sector traffic, not by HBM. The pivots
// (rounds words) sit in shared memory.
//
// uint32 arithmetic as in the TPU program: pivot < n and idx < n with
// n < 2**31, so pivot + n - idx lies in [1, 2n) and one conditional
// subtraction is the `% n`.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void shuffle_rounds_kernel(const uint32_t* __restrict__ pivots,
                                      const uint32_t* __restrict__ sources,
                                      uint32_t* __restrict__ out, uint32_t n, int rounds,
                                      uint32_t buckets) {
    extern __shared__ uint32_t piv[];
    for (int r = threadIdx.x; r < rounds; r += blockDim.x) piv[r] = pivots[r];
    __syncthreads();
    uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t idx = i;
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
        uint32_t t = piv[r] + n - idx;
        uint32_t flip = t >= n ? t - n : t;
        uint32_t pos = max(idx, flip);
        // word (pos % 256) / 32 of the digest of bucket pos / 256; byte
        // (pos / 8) % 4 of that big-endian word; bit pos % 8 of the byte
        uint32_t word = __ldg(sources + ((size_t)r * buckets + (pos >> 8)) * 8 + ((pos >> 5) & 7));
        uint32_t bit = (word >> (24 - 8 * ((pos >> 3) & 3) + (pos & 7))) & 1u;
        idx = bit ? flip : idx;
    }
    out[i] = idx;
}

extern "C" int shuffle_rounds(const void* pivots, const void* sources, void* out,
                              long long n, long long rounds, void* stream) {
    if (n > 0) {
        const int threads = 256;
        unsigned blocks = (unsigned)((n + threads - 1) / threads);
        uint32_t buckets = (uint32_t)((n + 255) / 256);
        shuffle_rounds_kernel<<<blocks, threads, (size_t)rounds * sizeof(uint32_t),
                                (cudaStream_t)stream>>>(
            (const uint32_t*)pivots, (const uint32_t*)sources, (uint32_t*)out, (uint32_t)n,
            (int)rounds, buckets);
    }
    return (int)cudaGetLastError();
}
