// K19 tree_root_batch: the roots of K Merkle trees of C leaves each, C a
// power of two, (K, C, 8) words in, (K, 8) words out.
//
// Replaces consensus_specs_tpu/engine/state_root.py:114
// `_tree_root_batch_impl` (jitted as `tree_root_batch`, :132), which folds
// the K trees as one flat (K*C, 8) array with one `merkle_parent_level` a
// level: log2 C launches over ever smaller levels. Here one launch folds s
// levels at once (s <= 10): a block takes 2^s consecutive rows (the leaves
// of one subtree, never two trees, since 2^s divides the rows a tree has
// left), hashes its 2^(s-1) sibling pairs straight from global memory into
// shared memory (at most 512 threads, 16 KB), then folds the rest of the
// subtree there, a `__syncthreads()` between levels, and writes one row.
// The wrapper (engine/state_root.py `tree_root_batch`) relaunches over the
// K*C/2^s rows until each tree is one row: the historical append's
// (1, 16,384) takes two launches (s = 10, then 4) where row 4 took 27 K1
// launches.
//
// Bound: integer instructions, as K1: K*(C-1) compressions pairs of 64
// rounds against K*C*32 bytes read. Each hash is K1's `sha256_64B`
// (sha256.cuh), with the schedule in registers. The upper levels of a
// subtree leave most of a block's threads idle; the first level, which
// holds half of all the hashes, runs every thread.
#include <cuda_runtime.h>
#include "merkle_rows.cuh"

// One block per output row; blockDim.x == 2^(s-1); dynamic shared memory
// holds 2^(s-1) rows.
__global__ void tree_root_fold_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                                      int s) {
    extern __shared__ uint4 level[];
    const long long b = blockIdx.x;
    const int t = threadIdx.x;
    uint32_t h[8];
    // level 0 -> 1: rows 2t and 2t+1 of the block's subtree, from global
    hash_row_pair(in + ((b << s) + 2 * t) * 2, h);
    store_row(level + 2 * t, h);
    __syncthreads();
    for (int n = blockDim.x >> 1; n >= 1; n >>= 1) {  // n parents at this level
        const bool active = t < n;
        if (active) hash_row_pair(level + 4 * t, h);
        __syncthreads();  // every read of the level before any write
        if (active) store_row(level + 2 * t, h);
        __syncthreads();
    }
    if (t == 0) {
        out[2 * b] = level[0];
        out[2 * b + 1] = level[1];
    }
}

// rows_out output rows, each the fold of 2^s input rows (1 <= s <= 10).
extern "C" int tree_root_fold(const void* in, void* out, long long rows_out, long long s,
                              void* stream) {
    if (s < 1 || s > 10) return (int)cudaErrorInvalidValue;
    if (rows_out > 0) {
        const int threads = 1 << (s - 1);
        tree_root_fold_kernel<<<(unsigned)rows_out, threads, threads * 32,
                                (cudaStream_t)stream>>>((const uint4*)in, (uint4*)out, (int)s);
    }
    return (int)cudaGetLastError();
}
