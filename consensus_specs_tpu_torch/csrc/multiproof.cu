// K20 multiproof_heap and K21 multiproof_siblings: batched Merkle branches
// of K chunk trees of C leaves each (C a power of two), the read lane's
// multiproof kind.
//
// Replaces consensus_specs_tpu/ops/multiproof_jax.py:29
// `_sibling_rows_impl` (jitted as `sibling_rows_batch`, :74), which folds
// the K trees as one flat array with one `merkle_parent_level` a level,
// concatenates every level into a per-tree heap addressed by generalized
// index (row 0 zero, row 1 the root, the leaves at rows [C, 2C)), and walks
// each query's siblings with a clamped `fori_loop`.
//
// K20 builds that heap, (K, 2C, 8) words. It is K19's fold (tree_root.cu)
// keeping every level: a block owns a 2^s-row subtree (s <= 10) of one
// tree's level, hashes its 2^(s-1) sibling pairs straight from global
// memory, folds the rest of the subtree in shared memory, and each thread
// also stores the parent it computed to the heap at the parent's
// generalized index: rows [C >> l, C >> (l - 1)) of the tree's heap hold
// level l above the leaves. The first launch reads the chunks, copies them
// to rows [C, 2C) and zeroes row 0 (the wrapper allocates the heap with
// torch.empty: a row 0 left unwritten would be garbage, and the pad queries
// and every query shallower than the batch read it); the wrapper relaunches
// over the upper levels, reading them from the heap, until one row a tree
// is left. At the read lane's main shape (8, 2^18) that is two launches
// (s = 10, then 8).
//
// K21 gathers the answers into one (Q * D + Q + K, 8) buffer: the Q * D
// siblings, then the Q nodes, then the K roots, each a 32-byte row. Row i of
// query q is heap[tree_q * 2C + (max(g_q >> i, 1) ^ 1)], the closed form of
// JAX's clamped walk (`g ^ 1`, then `max(g >> 1, 1)`: past the root a query
// reads row 1 ^ 1 = 0, the zero row); the node is heap[tree * 2C + g] and a
// root row 1 of its tree. One warp a query: lane j stores 16-byte half j & 1
// of the query's row j >> 1 (its D siblings, then its node), so neighbouring
// lanes store neighbouring halves and a query's D + 1 rows go out as
// contiguous segments; the warps past the last query store the roots, 16
// rows a warp. No division: the warp is the query, the lane the level and
// half. Heap offsets are 64-bit (JAX's `tree_ids * 2C` is int32 and
// overflows once K * 2C >= 2^31); the rest is 32-bit, since the rows
// written, Q * D + Q + K, stay below 2^31 (the wrapper checks it).
//
// Bounds. K20: K * (C - 1) compressions pairs (64-byte hashes) at K1's SASS
// count each, against K * C * 32 bytes read and K * 2C * 32 written; at
// (8, 2^18) the operations bound it (about 2.1 M hashes). The upper levels
// of a subtree leave most of a block's threads idle, as in K19; the first
// level, half of all the hashes, runs every thread. K21: bytes, Q * D * 32
// read and written (plus Q + K rows); it is a gather of a few hundred KB
// and so one launch's latency, which the wrapper's host cost (one
// allocation, one ctypes call) can exceed.
#include <cuda_runtime.h>
#include "merkle_rows.cuh"

// One block per 2^s-row subtree of the input level of one tree.
//   in:      the input level; row r of tree t at in[(t * in_stride + in_off + r) * 2]
//   heap:    (K, 2C) rows
//   n_in:    rows a tree has at the input level (a power of two >= 2^s)
//   copy_in: first launch: the input rows are the leaves; copy them to the
//            heap's rows [C, 2C) and zero row 0
// blockDim.x == max(2^(s-1), 1); dynamic shared memory holds blockDim.x rows.
__global__ void multiproof_heap_kernel(const uint4* __restrict__ in, long long in_stride,
                                       long long in_off, uint4* __restrict__ heap, long long c,
                                       long long n_in, int s, int copy_in) {
    extern __shared__ uint4 level[];
    const long long per_tree = n_in >> s;  // blocks a tree
    const long long tree = blockIdx.x / per_tree;
    const long long j = blockIdx.x % per_tree;  // the block's subtree in its tree
    const int t = threadIdx.x;
    const uint4* src = in + (tree * in_stride + in_off + (j << s)) * 2;
    uint4* th = heap + tree * 4 * c;  // the tree's heap, 2C rows of two uint4
    if (copy_in) {
        const int rows = s ? 2 : 1;  // input rows a thread owns
        for (int r = 0; r < rows; ++r) {
            const long long row = (j << s) + rows * t + r;
            th[(c + row) * 2] = src[(rows * t + r) * 2];
            th[(c + row) * 2 + 1] = src[(rows * t + r) * 2 + 1];
        }
        if (j == 0 && t == 0) th[0] = th[1] = make_uint4(0, 0, 0, 0);
    }
    if (s == 0) return;  // C == 1: the leaf is the root, row 1
    uint32_t h[8];
    // input level -> the level above, pairs from global memory
    hash_row_pair(src + 4 * t, h);
    store_row(level + 2 * t, h);
    long long above = n_in >> 1;  // rows a tree has at the level being written
    store_row(th + (above + (j << (s - 1)) + t) * 2, h);
    __syncthreads();
    int sub = s - 1;  // log2 of the block's rows at that level
    for (int n = blockDim.x >> 1; n >= 1; n >>= 1) {  // n parents at this level
        above >>= 1;
        --sub;
        const bool active = t < n;
        if (active) hash_row_pair(level + 4 * t, h);
        __syncthreads();  // every read of the level before any write
        if (active) {
            store_row(level + 2 * t, h);
            store_row(th + (above + (j << sub) + t) * 2, h);
        }
        __syncthreads();
    }
}

// K trees, n_in / 2^s blocks a tree (0 <= s <= 10; s = 0 only for n_in = 1).
extern "C" int multiproof_heap(const void* in, void* heap, long long k, long long in_stride,
                               long long in_off, long long c, long long n_in, long long s,
                               long long copy_in, void* stream) {
    if (s < 0 || s > 10 || (s == 0 && n_in != 1) || (n_in >> s) < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = k * (n_in >> s);
    if (blocks > 0) {
        const int threads = s ? 1 << (s - 1) : 1;
        multiproof_heap_kernel<<<(unsigned)blocks, threads, threads * 32,
                                 (cudaStream_t)stream>>>(
            (const uint4*)in, in_stride, in_off, (uint4*)heap, c, n_in, (int)s, (int)copy_in);
    }
    return (int)cudaGetLastError();
}

// One warp a query, then one warp for every 16 roots; out holds q * d
// siblings, q nodes, k roots, as 16-byte halves.
__global__ void multiproof_siblings_kernel(const uint4* __restrict__ heap,
                                           const int* __restrict__ tree_ids,
                                           const int* __restrict__ gindices,
                                           uint4* __restrict__ out, int q, int d, int k,
                                           long long c) {
    const int w = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (w < q) {
        const long long base = (long long)tree_ids[w] * 2 * c;
        const int g = gindices[w];
        uint4* dst = out + (long long)w * d * 2;  // the query's siblings, two halves a row
        for (int j = lane; j < 2 * d; j += 32) {
            const int h = g >> (j >> 1);
            dst[j] = heap[(base + ((h > 1 ? h : 1) ^ 1)) * 2 + (j & 1)];
        }
        if (lane < 2) out[((long long)q * d + w) * 2 + lane] = heap[(base + g) * 2 + lane];
    } else {
        const int t = (w - q) * 16 + (lane >> 1);
        if (t < k) out[((long long)q * d + q + t) * 2 + (lane & 1)] =
            heap[((long long)t * 2 * c + 1) * 2 + (lane & 1)];
    }
}

extern "C" int multiproof_siblings(const void* heap, const void* tree_ids, const void* gindices,
                                   void* out, long long q, long long d, long long k, long long c,
                                   void* stream) {
    if (q < 0 || d < 1 || d > 31 || k < 0 || q * d + q + k >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    const long long warps = q + (k + 15) / 16;
    if (warps > 0) {
        const int threads = 256;
        multiproof_siblings_kernel<<<(unsigned)((warps * 32 + threads - 1) / threads), threads,
                                     0, (cudaStream_t)stream>>>(
            (const uint4*)heap, (const int*)tree_ids, (const int*)gindices, (uint4*)out, (int)q,
            (int)d, (int)k, c);
    }
    return (int)cudaGetLastError();
}
