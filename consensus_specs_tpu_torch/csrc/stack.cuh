// The per-thread stack of the BLS kernels (K9-K12, K25). A thread holds
// Fp12 values and the frames of the called (__noinline__) tower functions:
// K12's limb instance needs 6,464 bytes (ptxas, cumulative stack size) and
// K9's limb kernel 2,240 (its G1 ladder on four lanes; K9's and K11's group
// programs keep their values in shared memory, K11 144), below this limit,
// which tests/test_torch_cuda.py pins at 10,160 bytes or more. The RNS instances hold two words a lane an
// Fp and need far less, but K12's is still above the CUDA runtime's default
// of 1 KiB, so their entries call this too. The CUDA driver reserves the
// limit for every thread the card can hold at once (2,048 an SM, 132 SMs),
// about 2.8 GB at this limit.
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
