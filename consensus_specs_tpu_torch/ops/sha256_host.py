"""Host-side sha256 constants and helpers (counterpart of ops/sha256_np.py
and of `ssz/merkle.zerohashes` in the JAX package).

The port keeps its own copies: the round constants, the initial hash value,
big-endian byte <-> word conversion, and the zero-subtree roots, built here
with `hashlib` (zero_hashes[d] is the root of a depth-d tree of zero chunks).
"""
from __future__ import annotations

import hashlib

import numpy as np

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

# Padding block of a 64-byte message: 0x80 terminator, bit length 512.
PAD64 = np.zeros(16, dtype=np.uint32)
PAD64[0] = 0x80000000
PAD64[15] = 512


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def bytes_to_words(data: bytes) -> np.ndarray:
    """Big-endian bytes (len % 4 == 0) -> uint32 words."""
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


def words_to_bytes(words) -> bytes:
    """uint32 (or int32 bit-pattern) words -> big-endian bytes."""
    return np.asarray(words).astype(np.uint32).astype(">u4").tobytes()


ZERO_HASHES: list[bytes] = [b"\x00" * 32]
for _ in range(64):
    ZERO_HASHES.append(sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]))


def zero_hash_words() -> np.ndarray:
    """(65, 8) uint32: words of the zero-subtree roots of depth 0..64."""
    return np.stack([bytes_to_words(z) for z in ZERO_HASHES])


def merkle_root_hashlib(chunks: list[bytes]) -> bytes:
    """Root of a power-of-two list of 32-byte chunks, one hashlib call per
    node: the independent fold the kernels are checked against."""
    level = list(chunks)
    if not level or len(level) & (len(level) - 1):
        raise ValueError(f"need a power-of-two chunk count, got {len(level)}")
    while len(level) > 1:
        level = [sha256(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]
