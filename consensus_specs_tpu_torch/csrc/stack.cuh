// The per-thread stack of the BLS kernels (K9-K12). A thread holds Fp12
// values and the frames of the called (__noinline__) tower functions; the
// deepest kernel, K12's limb final_exp_kernel, needs 10,160 bytes (ptxas,
// cumulative stack size). The RNS instances hold two words a lane an Fp and
// need far less (K12's 1,504 bytes, K11's 600), but K12's is still above
// the CUDA runtime's default of 1 KiB, so their entries call this too. The
// CUDA driver reserves the limit for every thread the card can hold at once
// (2,048 an SM, 132 SMs), about 2.8 GB at this limit, so it sits just above
// that need.
#pragma once
#include <cuda_runtime.h>

#define BLS_STACK_BYTES 10752  // 10.5 KiB

// Raise the device's stack limit to BLS_STACK_BYTES (never lower it); every
// BLS entry calls this before it launches.
static int ensure_stack() {
    size_t cur = 0;
    cudaError_t e = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
    if (e == cudaSuccess && cur < BLS_STACK_BYTES)
        e = cudaDeviceSetLimit(cudaLimitStackSize, BLS_STACK_BYTES);
    return (int)e;
}
