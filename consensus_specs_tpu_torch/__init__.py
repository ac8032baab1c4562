"""PyTorch + CUDA port of the device epoch path of `consensus_specs_tpu`.

The JAX package `consensus_specs_tpu/` is the reference; this package mirrors
its layout (`ops/`, `engine/`) and runs the same programs on an NVIDIA
Hopper card through kernels written by hand in CUDA C++ (`csrc/`, built and
loaded by `kernels/build.py`). Every kernel wrapper keeps a plain PyTorch
version of the same function beside it: the wrapper runs the plain version
only for tensors on the CPU, and launches the kernel (or raises) for tensors
on a CUDA device.

The package imports torch and numpy, never jax, flax or the JAX package.
Entry points take `device=` and default to "cuda"; without a card they raise
unless the caller asks for "cpu".
"""
