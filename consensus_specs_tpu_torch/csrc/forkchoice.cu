// K15-K18: the batched LMD-GHOST head over Q padded store snapshots.
//
// Replaces consensus_specs_tpu/ops/forkchoice_jax.py:54 `_ghost_head_impl`
// (vmapped as `ghost_head_bucket`, :158): one XLA program that builds a (B, B)
// bool ancestor matrix by pointer doubling, sums the votes through a
// (4096, B) equality mask a chunk, reduces subtree weights over the matrix,
// applies the FFG filter and walks B greedy steps. Here it is four kernels,
// each compared with its plain version in ops/forkchoice.py on its own output:
//
// K15 fc_ancestors   (Q, B) parents -> (Q, B, W) u32 ancestor-or-self bitsets,
//                    W = ceil(B / 32): bit c of row i says c is i or above it.
// K16 fc_vote_weights (Q, V) votes, balances -> (Q, B) exact int64 direct weight.
// K17 fc_subtree     bitsets, direct weight, FFG columns -> (Q, B) subtree
//                    weight (proposer boost included) and viability.
// K18 fc_head_walk   -> (Q, B) filter and the (Q,) head, one block a snapshot.
//
// Bounds on this card: K16 reads 12 B a vote (3.35 TB/s: 3.8 us at V = 2**20);
// K15 writes B**2 / 8 bytes a snapshot and K17 reads them once (8 MB at
// B = 8192), each with about B * W word operations a doubling step or B**2
// bit tests; K18 touches about 90 B a block and then follows one pointer a
// step of the walk. The design keeps every pass over B rows inside one
// block's shared memory where it fits (B <= FC_SMEM_ROWS) and falls back to
// global scratch of the same layout above it.
//
// Arithmetic matches the JAX program bit for bit: int64 sums wrap as uint64
// atomics do (order-free), the walk's argmax is JAX's lexicographic mask
// refinement (weight against a -1 floor, then the 8 root words compared as
// unsigned, then the lowest index), and every pass reads only the previous
// pass's values (two buffers in K15, barriers in K18).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FC_SMEM_ROWS 8192   // largest B whose per-block tables live in shared memory
#define FC_THREADS 1024
#define VOTES_PER_BLOCK 8192
#define SUB_COLS 256        // K17: one column a thread
#define SUB_ROWS 1024       // K17: rows a block sums over

static __device__ __forceinline__ unsigned long long order_key(long long w) {
    // signed int64 order as unsigned order, for atomicMax
    return (unsigned long long)w ^ 0x8000000000000000ULL;
}

// K15: one block a (bitset word column w, snapshot q). The doubling step
// anc'[i] = anc[i] | anc[jump[i]], jump'[i] = jump[jump[i]] works column by
// column, so a block carries its 32 columns of all B rows (and its own copy of
// the jump pointers) through ceil(log2 B) steps between two buffers, reading
// only the previous step's values. No order of the parents is assumed.
__global__ void fc_ancestors_kernel(const int* __restrict__ parent, uint32_t* __restrict__ anc,
                                    uint32_t* __restrict__ scratch, int B, int W, int levels) {
    extern __shared__ uint32_t fc_smem32[];
    const int w = blockIdx.x, q = blockIdx.y;
    // buffer k (0 or 1): the column at base + 2kB, the jump pointers after it
    uint32_t* base = scratch ? scratch + ((size_t)q * W + w) * 4 * (size_t)B : fc_smem32;
    uint32_t* col = base;
    int* jump = (int*)(base + B);
    const int* par = parent + (size_t)q * B;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
        col[i] = (i >> 5) == w ? 1u << (i & 31) : 0u;
        jump[i] = par[i];
    }
    __syncthreads();
    for (int s = 0; s < levels; ++s) {
        uint32_t* ncol = (s & 1) ? base : base + 2 * (size_t)B;
        int* njump = (int*)(ncol + B);
        for (int i = threadIdx.x; i < B; i += blockDim.x) {
            int j = jump[i];
            ncol[i] = col[i] | col[j];
            njump[i] = jump[j];
        }
        __syncthreads();
        col = ncol;
        jump = njump;
    }
    uint32_t* out = anc + (size_t)q * B * W + w;
    for (int i = threadIdx.x; i < B; i += blockDim.x) out[(size_t)i * W] = col[i];
}

// K16: one block a (slice of VOTES_PER_BLOCK votes, snapshot q). Balances
// add into a shared histogram of B bins with 64-bit atomics, then each
// nonzero bin adds into the snapshot's row in global memory. Integer addition
// makes the order irrelevant: the sum is exact (mod 2**64, as JAX's int64).
// Votes outside [0, B) (-1 = no message) match no block and are skipped.
__global__ void fc_vote_weights_kernel(const int* __restrict__ votes,
                                       const long long* __restrict__ balances,
                                       unsigned long long* __restrict__ direct, long long V, int B,
                                       int use_smem) {
    extern __shared__ unsigned long long fc_smem64[];
    const int q = blockIdx.y;
    unsigned long long* out = direct + (size_t)q * B;
    unsigned long long* acc = use_smem ? fc_smem64 : out;
    if (use_smem) {
        for (int i = threadIdx.x; i < B; i += blockDim.x) fc_smem64[i] = 0;
        __syncthreads();
    }
    const long long v0 = (long long)blockIdx.x * VOTES_PER_BLOCK;
    const long long v1 = min(V, v0 + VOTES_PER_BLOCK);
    const int* vq = votes + (size_t)q * V;
    const long long* bq = balances + (size_t)q * V;
    for (long long k = v0 + threadIdx.x; k < v1; k += blockDim.x) {
        int v = vq[k];
        if (v >= 0 && v < B) atomicAdd(acc + v, (unsigned long long)bq[k]);
    }
    if (use_smem) {
        __syncthreads();
        for (int i = threadIdx.x; i < B; i += blockDim.x)
            if (fc_smem64[i]) atomicAdd(out + i, fc_smem64[i]);
    }
}

// K17: one block a (256 columns, 1024 rows, snapshot q); a thread owns one
// column c and sums direct[i] over the rows i of its slice whose bitset holds
// c (the 32 lanes of a warp read the same word: one broadcast a row), and ORs
// leaf_ok[i] into viable[c]. Partial sums meet in global memory by 64-bit
// atomics (exact, order-free). A block first finds which of its rows have a
// real child that is not themselves (a scan of the B parents) to form
// leaf_ok = leaf & real & FFG agreement, as filter_block_tree's leaf rule with
// the GENESIS_EPOCH escapes. The blocks of row slice 0 add the proposer boost
// on the ancestors-or-self of boost_idx (boost_idx < 0: off).
__global__ void fc_subtree_kernel(const uint32_t* __restrict__ anc,
                                  const long long* __restrict__ direct,
                                  const int* __restrict__ parent,
                                  const long long* __restrict__ ck_epochs,
                                  const int* __restrict__ ck_rids, const bool* __restrict__ is_real,
                                  const int* __restrict__ idx_scalars,
                                  const long long* __restrict__ ep_scalars,
                                  unsigned long long* __restrict__ weight,
                                  bool* __restrict__ viable, int B, int W) {
    __shared__ long long d[SUB_ROWS];
    __shared__ unsigned char leaf_ok[SUB_ROWS];
    const int q = blockIdx.z;
    const int r0 = blockIdx.y * SUB_ROWS;
    const int rows = min(B - r0, SUB_ROWS);
    const int* par = parent + (size_t)q * B;
    const bool* real = is_real + (size_t)q * B;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) leaf_ok[i] = 1;
    __syncthreads();
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
        int p = par[i];
        if (real[i] && p != i && p >= r0 && p < r0 + rows) leaf_ok[p - r0] = 0;
    }
    __syncthreads();
    const long long sje = ep_scalars[4 * q], sfe = ep_scalars[4 * q + 1];
    const long long ge = ep_scalars[4 * q + 2];
    const int sjr = idx_scalars[4 * q + 2], sfr = idx_scalars[4 * q + 3];
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        size_t r = (size_t)q * B + r0 + i;
        bool ok_just = sje == ge || (ck_epochs[2 * r] == sje && ck_rids[2 * r] == sjr);
        bool ok_fin = sfe == ge || (ck_epochs[2 * r + 1] == sfe && ck_rids[2 * r + 1] == sfr);
        leaf_ok[i] = leaf_ok[i] && real[r0 + i] && ok_just && ok_fin;
        d[i] = direct[r];
    }
    __syncthreads();
    const int c = blockIdx.x * SUB_COLS + threadIdx.x;
    if (c >= B) return;
    const uint32_t* a = anc + (size_t)q * B * W + (c >> 5);
    const uint32_t bit = 1u << (c & 31);
    unsigned long long acc = 0;
    bool via = false;
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
        if (__ldg(a + (size_t)(r0 + i) * W) & bit) {
            acc += (unsigned long long)d[i];
            via |= leaf_ok[i] != 0;
        }
    }
    if (blockIdx.y == 0) {
        const int boost = idx_scalars[4 * q + 1];
        if (boost >= 0 && boost < B && (a[(size_t)boost * W] & bit))
            acc += (unsigned long long)ep_scalars[4 * q + 3];
    }
    if (acc) atomicAdd(weight + (size_t)q * B + c, acc);
    if (via) viable[(size_t)q * B + c] = true;
}

// K18: one block a snapshot. filtered = viable & real & (descendant-or-self
// of justified_idx). Then every parent's best filtered child at once, as the
// JAX walk's argmax refines its mask: max weight (floored at -1), then each
// of the 8 root words as unsigned, most significant first, then the lowest
// index; each pass an atomicMax (atomicMin for the index) over the children
// still tied, grouped by parent, between barriers. A parent with children
// and none left after the weight pass (weights below -1 only) takes 0, as
// JAX's argmax of an empty mask does. One thread then follows best[] from
// justified_idx for at most B steps (JAX's B iterations; a childless head
// is a fixed point).
__global__ void fc_head_walk_kernel(const uint32_t* __restrict__ anc,
                                    const long long* __restrict__ weight,
                                    const bool* __restrict__ viable,
                                    const int* __restrict__ parent,
                                    const long long* __restrict__ root_words,
                                    const bool* __restrict__ is_real,
                                    const int* __restrict__ idx_scalars,
                                    bool* __restrict__ filtered, int* __restrict__ head,
                                    unsigned char* __restrict__ scratch, int B, int W) {
    extern __shared__ unsigned long long fc_smem64[];
    const int q = blockIdx.x;
    const size_t stride = (18 * (size_t)B + 7) & ~(size_t)7;  // keeps maxw 8-byte aligned
    unsigned char* base = scratch ? scratch + q * stride : (unsigned char*)fc_smem64;
    unsigned long long* maxw = (unsigned long long*)base;
    unsigned* maxr = (unsigned*)(base + 8 * (size_t)B);
    int* best = (int*)(base + 12 * (size_t)B);
    unsigned char* alive = base + 16 * (size_t)B;
    unsigned char* has_kid = base + 17 * (size_t)B;
    const size_t row0 = (size_t)q * B;
    const int* par = parent + row0;
    const long long* wq = weight + row0;
    const long long* rq = root_words + row0 * 8;
    const int j = idx_scalars[4 * q];
    if (j < 0 || j >= B) {  // no justified block in the bucket: nothing to walk
        for (int c = threadIdx.x; c < B; c += blockDim.x) filtered[row0 + c] = false;
        if (threadIdx.x == 0) head[q] = j;
        return;
    }
    for (int c = threadIdx.x; c < B; c += blockDim.x) {
        maxw[c] = order_key(-1);
        maxr[c] = 0;
        best[c] = INT_MAX;
        has_kid[c] = 0;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < B; c += blockDim.x) {
        bool f = viable[row0 + c] && is_real[row0 + c]
                 && ((anc[(row0 + c) * W + (j >> 5)] >> (j & 31)) & 1u);
        filtered[row0 + c] = f;
        int p = par[c];
        alive[c] = f && p != c;
        if (alive[c]) {
            has_kid[p] = 1;
            atomicMax(maxw + p, order_key(wq[c]));
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < B; c += blockDim.x)
        if (alive[c]) alive[c] = order_key(wq[c]) == maxw[par[c]];
    __syncthreads();
    for (int t = 0; t < 8; ++t) {
        for (int c = threadIdx.x; c < B; c += blockDim.x)
            if (alive[c]) atomicMax(maxr + par[c], (unsigned)rq[8 * (size_t)c + t]);
        __syncthreads();
        for (int c = threadIdx.x; c < B; c += blockDim.x)
            if (alive[c]) alive[c] = (unsigned)rq[8 * (size_t)c + t] == maxr[par[c]];
        __syncthreads();
        for (int c = threadIdx.x; c < B; c += blockDim.x)
            if (alive[c]) maxr[par[c]] = 0;  // the word's maximum holder is still alive
        __syncthreads();
    }
    for (int c = threadIdx.x; c < B; c += blockDim.x)
        if (alive[c]) atomicMin(best + par[c], c);
    __syncthreads();
    if (threadIdx.x == 0) {
        int h = j;
        for (int s = 0; s < B; ++s) {
            int b = best[h];
            if (b == INT_MAX) {
                if (!has_kid[h]) break;
                b = 0;
            }
            h = b;
        }
        head[q] = h;
    }
}

static int fc_threads(long long b) {
    long long t = (b + 31) / 32 * 32;
    return (int)(t < FC_THREADS ? t : FC_THREADS);
}

static int levels_of(long long b) {
    int l = 0;
    while ((1LL << l) < b) ++l;
    return l;
}

// scratch: NULL when B <= FC_SMEM_ROWS, else 16 * B * W * Q bytes.
extern "C" int fc_ancestors(const void* parent, void* anc, void* scratch, long long q,
                            long long b, void* stream) {
    if (q <= 0 || b <= 0) return 0;
    const int w = (int)((b + 31) / 32);
    size_t smem = scratch ? 0 : 16 * (size_t)b;
    cudaError_t e = cudaFuncSetAttribute(fc_ancestors_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         16 * FC_SMEM_ROWS);
    if (e != cudaSuccess) return (int)e;
    fc_ancestors_kernel<<<dim3(w, (unsigned)q), fc_threads(b), smem, (cudaStream_t)stream>>>(
        (const int*)parent, (uint32_t*)anc, (uint32_t*)scratch, (int)b, w, levels_of(b));
    return (int)cudaGetLastError();
}

// direct must be zeroed by the caller.
extern "C" int fc_vote_weights(const void* votes, const void* balances, void* direct,
                               long long q, long long v, long long b, void* stream) {
    if (q <= 0 || v <= 0 || b <= 0) return 0;
    const int use_smem = b <= FC_SMEM_ROWS;
    cudaError_t e = cudaFuncSetAttribute(fc_vote_weights_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         8 * FC_SMEM_ROWS);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((v + VOTES_PER_BLOCK - 1) / VOTES_PER_BLOCK), (unsigned)q);
    fc_vote_weights_kernel<<<grid, 256, use_smem ? 8 * (size_t)b : 0, (cudaStream_t)stream>>>(
        (const int*)votes, (const long long*)balances, (unsigned long long*)direct, v, (int)b,
        use_smem);
    return (int)cudaGetLastError();
}

// weight and viable must be zeroed by the caller.
extern "C" int fc_subtree(const void* anc, const void* direct, const void* parent,
                          const void* ck_epochs, const void* ck_rids, const void* is_real,
                          const void* idx_scalars, const void* ep_scalars, void* weight,
                          void* viable, long long q, long long b, void* stream) {
    if (q <= 0 || b <= 0) return 0;
    const int w = (int)((b + 31) / 32);
    dim3 grid((unsigned)((b + SUB_COLS - 1) / SUB_COLS), (unsigned)((b + SUB_ROWS - 1) / SUB_ROWS),
              (unsigned)q);
    fc_subtree_kernel<<<grid, SUB_COLS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)anc, (const long long*)direct, (const int*)parent,
        (const long long*)ck_epochs, (const int*)ck_rids, (const bool*)is_real,
        (const int*)idx_scalars, (const long long*)ep_scalars, (unsigned long long*)weight,
        (bool*)viable, (int)b, w);
    return (int)cudaGetLastError();
}

// scratch: NULL when B <= FC_SMEM_ROWS, else Q * round_up(18 * B, 8) bytes.
extern "C" int fc_head_walk(const void* anc, const void* weight, const void* viable,
                            const void* parent, const void* root_words, const void* is_real,
                            const void* idx_scalars, void* filtered, void* head, void* scratch,
                            long long q, long long b, void* stream) {
    if (q <= 0 || b <= 0) return 0;
    const int w = (int)((b + 31) / 32);
    size_t smem = scratch ? 0 : 18 * (size_t)b;
    cudaError_t e = cudaFuncSetAttribute(fc_head_walk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         18 * FC_SMEM_ROWS);
    if (e != cudaSuccess) return (int)e;
    fc_head_walk_kernel<<<(unsigned)q, FC_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)anc, (const long long*)weight, (const bool*)viable, (const int*)parent,
        (const long long*)root_words, (const bool*)is_real, (const int*)idx_scalars,
        (bool*)filtered, (int*)head, (unsigned char*)scratch, (int)b, w);
    return (int)cudaGetLastError();
}
