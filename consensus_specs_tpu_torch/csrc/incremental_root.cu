// The resident Merkle cache's two kernels (engine/incremental_root.py).
//
// K6 dirty_scan replaces consensus_specs_tpu/engine/incremental_root.py:137
// `_dirty_scan_fn`: one pass over the six registry columns a Validator
// container hashes (effective balance, slashed, activation eligibility,
// activation, exit, withdrawable) against the cache's own copies. A row
// that differs anywhere is dirty: the thread copies its six fresh values
// into the cache in place, takes a slot with an atomic add on the device
// count, and writes its index there while the slot is below `cap`. The
// first `cap` dirty indices therefore come in no fixed order; the caller
// reads the count once and takes the full rebuild above `cap`. Bound:
// bytes, 2 x 41 read a validator plus 41 written a dirty row; the compare
// is a handful of instructions.
//
// K7 path_fold replaces `multi_path_update` / `path_update` (:70, :84) and
// the gather + container rehash of `_masked_validators_update_fn` (:155):
// it writes K new leaves into a flat level buffer (level l of a depth-d
// tree is rows [2^(d+1) - 2^(d-l+1), ...) of 8 words) and refolds their K
// root paths, in place. A leaf is, by `mode`:
//   0  row idx[j] (or row j) of `src`, 8 words as stored (randao mixes,
//      state/block roots, a recorded root);
//   1  the same row with each word byte-swapped: a chunk of 4 uint64
//      values from their little-endian memory (the slashings vector);
//   2  the container root of validator idx[j] (validator.cuh, the code
//      path K2 runs).
// Level l+1 reads what level l wrote, so the fold must finish one level
// before the next: one block, 256 threads striding over the K paths, and a
// __syncthreads() between levels. A launch a level would cost d host
// launches a refresh (the refresh is host-bound already), and a grid sync
// needs a cooperative launch for no gain at K <= 1024. Duplicate indices
// (the slashings chunks of four consecutive epochs) rehash the same
// parents from the same children: the racing writes store equal values.
// Bound: the hashes (7 a container, one a path node) at the integer
// instruction rate; at a K of a few rows it is latency-bound on one SM.
#include <cuda_runtime.h>
#include "validator.cuh"

__global__ void dirty_scan_kernel(ValidatorCols fresh, u64* __restrict__ c_eff,
                                  bool* __restrict__ c_slashed, u64* __restrict__ c_aee,
                                  u64* __restrict__ c_act, u64* __restrict__ c_ext,
                                  u64* __restrict__ c_wd, unsigned int* __restrict__ count,
                                  long long* __restrict__ idx, long long n, long long cap) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u64 eff = fresh.eff[i], aee = fresh.aee[i], act = fresh.act[i];
    u64 ext = fresh.ext[i], wd = fresh.wd[i];
    bool sl = fresh.slashed[i];
    bool dirty = eff != c_eff[i] || sl != c_slashed[i] || aee != c_aee[i]
                 || act != c_act[i] || ext != c_ext[i] || wd != c_wd[i];
    if (!dirty) return;
    c_eff[i] = eff; c_slashed[i] = sl; c_aee[i] = aee;
    c_act[i] = act; c_ext[i] = ext; c_wd[i] = wd;
    unsigned int slot = atomicAdd(count, 1u);
    if (slot < cap) idx[slot] = i;
}

#define FOLD_THREADS 256

__global__ void __launch_bounds__(FOLD_THREADS)
path_fold_kernel(uint4* levels, const long long* __restrict__ idx, int k, int depth, int mode,
                 int by_index, const uint4* __restrict__ src, ValidatorCols cols) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
        long long leaf = idx[j];
        uint32_t v[8];
        if (mode == 2) {
            validator_root(cols, leaf, v);
        } else {
            long long row = by_index ? leaf : j;
            uint4 a = src[row * 2], b = src[row * 2 + 1];
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
            v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
            if (mode == 1) {
#pragma unroll
                for (int q = 0; q < 8; ++q) v[q] = bswap32(v[q]);
            }
        }
        levels[leaf * 2] = make_uint4(v[0], v[1], v[2], v[3]);
        levels[leaf * 2 + 1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    long long off = 0, width = 1LL << depth;  // rows of the level being read
    for (int l = 0; l < depth; ++l) {
        long long up = off + width;
        for (int j = threadIdx.x; j < k; j += blockDim.x) {
            long long p = idx[j] >> (l + 1);
            uint32_t msg[16], h[8];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint4 c = levels[(off + 2 * p) * 2 + q];
                msg[4 * q] = c.x; msg[4 * q + 1] = c.y; msg[4 * q + 2] = c.z; msg[4 * q + 3] = c.w;
            }
            sha256_64B(msg, h);
            levels[(up + p) * 2] = make_uint4(h[0], h[1], h[2], h[3]);
            levels[(up + p) * 2 + 1] = make_uint4(h[4], h[5], h[6], h[7]);
        }
        __syncthreads();
        off = up;
        width >>= 1;
    }
}

extern "C" int dirty_scan(const void* eff, const void* aee, const void* act, const void* ext,
                          const void* wd, const void* slashed, void* c_eff, void* c_aee,
                          void* c_act, void* c_ext, void* c_wd, void* c_slashed, void* count,
                          void* idx, long long n, long long cap, void* stream) {
    if (n > 0) {
        const int threads = 256;
        unsigned blocks = (unsigned)((n + threads - 1) / threads);
        ValidatorCols fresh = {nullptr, (const u64*)eff, (const u64*)aee, (const u64*)act,
                               (const u64*)ext, (const u64*)wd, (const bool*)slashed};
        dirty_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            fresh, (u64*)c_eff, (bool*)c_slashed, (u64*)c_aee, (u64*)c_act, (u64*)c_ext,
            (u64*)c_wd, (unsigned int*)count, (long long*)idx, n, cap);
    }
    return (int)cudaGetLastError();
}

extern "C" int path_fold(void* levels, const void* idx, const void* src, const void* static01,
                         const void* eff, const void* aee, const void* act, const void* ext,
                         const void* wd, const void* slashed, long long k, long long depth,
                         long long mode, long long by_index, void* stream) {
    if (k > 0) {
        int threads = k < FOLD_THREADS ? (int)((k + 31) / 32 * 32) : FOLD_THREADS;
        ValidatorCols cols = {(const uint4*)static01, (const u64*)eff, (const u64*)aee,
                              (const u64*)act, (const u64*)ext, (const u64*)wd,
                              (const bool*)slashed};
        path_fold_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
            (uint4*)levels, (const long long*)idx, (int)k, (int)depth, (int)mode, (int)by_index,
            (const uint4*)src, cols);
    }
    return (int)cudaGetLastError();
}
