// The groups of units the BLS kernels run an item on, a unit being a lane
// (limb field, csrc/fp.cuh) or a warp (RNS, csrc/fp_rns.cuh). One set of
// types serves K12's and K25's hand schedules (csrc/f12_group.cuh) and the
// group programs of K9 and K11 (csrc/bls_group.cuh). A group type gives its
// SIZE in units, a unit's `rank` in the group, the group's `index` in the
// block and `sync`, which orders the group's shared-memory exchange; a
// thread's index `thread()` among the group's THREADS moves words.
#pragma once
#include "fp.cuh"

// G lanes of a warp (G = 32, 16, 8 or 4), group threadIdx.x / G of the block
template <int G>
struct lanes {
    static constexpr int SIZE = G, THREADS = G;
    static BLS_INLINE int rank() { return threadIdx.x & (G - 1); }
    static BLS_INLINE int thread() { return rank(); }  // of THREADS
    static BLS_INLINE int index() { return threadIdx.x / G; }
    static BLS_INLINE unsigned mask() {
        return G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
    }
    static BLS_INLINE void sync() { __syncwarp(mask()); }
};

// W warps, PER groups a block: one group syncs the block, more sync on the
// named barriers 1..PER. (An index fixed at 0 where PER is 1 made ptxas
// give K9's RNS kernel 48 registers and spills, 10 % slower: PERF.md.)
template <int W, int PER>
struct warps {
    static constexpr int SIZE = W, THREADS = 32 * W;
    static BLS_INLINE int rank() { return (threadIdx.x >> 5) % W; }
    static BLS_INLINE int thread() { return (threadIdx.x & 31) + 32 * rank(); }
    static BLS_INLINE int index() { return (threadIdx.x >> 5) / W; }
    static BLS_INLINE void sync() {
        if (PER == 1)
            __syncthreads();
        else
            asm volatile("bar.sync %0, %1;" ::"r"(1 + index()), "r"(W * 32) : "memory");
    }
};
