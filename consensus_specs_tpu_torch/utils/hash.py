"""Scalar host-side hashing (copy of the JAX package's utils/hash.py).

Reference parity: eth2spec's ``hash`` helper (tests/core/pyspec/eth2spec/utils/
hash_function.py:8) — sha256 returning 32 bytes: the one-at-a-time boundary
the compiled spec and host-side control flow call.
"""
from hashlib import sha256 as _sha256


def hash_eth2(data: bytes) -> bytes:
    """sha256(data) -> 32 bytes."""
    return _sha256(data).digest()
