"""uint64 values carried in `torch.int64` tensors, and 32-bit word helpers.

PyTorch on the CPU has no `+` or `>>` for uint32/uint64, so the port stores
every uint64 column as the int64 tensor with the same 64-bit pattern (numpy's
`.view(np.int64)`), and every 32-bit sha word as the int32 tensor with the
same bit pattern. The CUDA kernels read both as `unsigned long long` /
`uint32_t`; these helpers give the plain PyTorch versions the unsigned
meaning where the signed reading would differ.

Value domains (where each helper equals the JAX uint64 result):
- `ult`, `ule`, `umax`, `sort_key`: every uint64 pattern. FAR_FUTURE_EPOCH
  (2**64 - 1) reads as -1 in int64, so a signed `<` would put it first.
- `+`, `-`, `*` on int64 wrap like uint64 mod 2**64 (two's complement), so
  they agree bit for bit everywhere. Floor division `//` and `%` agree only
  while both operands are below 2**63, which is why the plain epoch version
  states the domain of its products.
- `bswap32`, `words_i64`: values in [0, 2**32).
"""
from __future__ import annotations

import torch

FAR = -1  # FAR_FUTURE_EPOCH = 2**64 - 1 as an int64 bit pattern
SIGN = -(2**63)  # 0x8000000000000000 as int64
MASK32 = 0xFFFFFFFF


def as_i64(x: int) -> int:
    """A Python uint64 value -> the int64 with the same bit pattern."""
    x &= 2**64 - 1
    return x - 2**64 if x >= 2**63 else x


def as_u64(x: int) -> int:
    """An int64 bit pattern -> its uint64 value."""
    return x & (2**64 - 1)


def sort_key(a: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned order of `a`
    (flip the sign bit): FAR (-1) maps to the largest key."""
    return a ^ SIGN


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns (tensor or Python int)."""
    return _key(a) < _key(b)


def ule(a, b) -> torch.Tensor:
    """Unsigned a <= b on int64 bit patterns."""
    return _key(a) <= _key(b)


def umax(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned elementwise max."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    return torch.where(ult(a, b), b, a)


def umax_reduce(a: torch.Tensor) -> torch.Tensor:
    """Unsigned max over all elements (0-d int64)."""
    return sort_key(sort_key(a).max())


def _key(x):
    if isinstance(x, torch.Tensor):
        return x ^ SIGN
    return as_i64(x) ^ SIGN


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte-swap each 32-bit value held in an int64 in [0, 2**32)."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def words_i64(w: torch.Tensor) -> torch.Tensor:
    """int32 word bit patterns -> int64 values in [0, 2**32)."""
    return w.to(torch.int64) & MASK32


def words_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (any; the low 32 bits are kept) -> int32 bit patterns."""
    x = x & MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)
