"""Host-side (pure-Python) BLS12-381 scalar-field helpers: the order r, its
roots of unity and the O(n^2) oracle DFT.

The port's own copy of the JAX package's ops/fr_host.py, unchanged below
this docstring, so that the port's KZG modules import nothing of that
package.
"""
from __future__ import annotations

# Curve order of BLS12-381 (the "inner" / scalar modulus, reference
# specs/sharding/beacon-chain.md:107) and its primitive root 7 (:104).
R_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
PRIMITIVE_ROOT = 7
TWO_ADICITY = 32
assert (R_MODULUS - 1) % (1 << TWO_ADICITY) == 0


def root_of_unity(order: int) -> int:
    """Primitive `order`-th root of unity in Fr (order a power of two ≤ 2^32).

    Matches the reference's ROOT_OF_UNITY derivation
    (specs/sharding/beacon-chain.md:174): 7^((r-1)/order) mod r."""
    assert order & (order - 1) == 0 and order <= (1 << TWO_ADICITY)
    return pow(PRIMITIVE_ROOT, (R_MODULUS - 1) // order, R_MODULUS)


def domain(n: int) -> list[int]:
    """[w^0, w^1, ..., w^(n-1)] for the n-th root w (host ints)."""
    w = root_of_unity(n)
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * w % R_MODULUS
    return out


def host_ntt(values: list[int], inverse: bool = False) -> list[int]:
    """O(n^2) reference DFT over Fr (host ints) for differential tests and
    the host sampling path."""
    n = len(values)
    w = root_of_unity(n)
    if inverse:
        w = pow(w, R_MODULUS - 2, R_MODULUS)
    out = []
    for i in range(n):
        acc = 0
        for j, v in enumerate(values):
            acc = (acc + v * pow(w, i * j, R_MODULUS)) % R_MODULUS
        if inverse:
            acc = acc * pow(n, R_MODULUS - 2, R_MODULUS) % R_MODULUS
        out.append(acc)
    return out
