"""Batched swap-or-not shuffle (counterpart of ops/shuffle.py).

`shuffled_index_map(n, seed_words, rounds)` is the spec's
`compute_shuffled_index(i, n, seed)` for every i in [0, n) at once:
- the `rounds` pivot hashes, u64_le(sha256(seed || u8(round))[0:8]) % n,
  and the rounds x ceil(n/256) source hashes,
  sha256(seed || u8(round) || u32_le(bucket)), are single-block messages
  built here in PyTorch glue and hashed by K4 (`sha256_1block`);
- the rounds of flip/select over the index vector are kernel K5
  (`shuffle_rounds`, csrc/shuffle.cu): on a CUDA tensor the wrapper launches
  it, on a CPU tensor it runs `shuffle_rounds_plain`.

Indices come back as (n,) int32 (n < 2**31, so every value is exact).
The plain version carries the uint32 arithmetic in int64 with masks: torch
on the CPU has no uint32 `+` or `>>`. `compute_shuffled_indices_np` is the
JAX package's host numpy/hashlib twin, copied: the reference the tests
hold both versions against.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..kernels import build
from ..utils.device import is_cpu, resolve_device
from ..utils.u64 import bswap32, words_i32, words_i64
from .sha256 import sha256_1block, sha256_1block_plain
from .sha256_host import bytes_to_words


def seed_to_words(seed: bytes) -> np.ndarray:
    """32-byte shuffle seed -> (8,) uint32 big-endian message words."""
    if len(seed) != 32:
        raise ValueError(f"a shuffle seed is 32 bytes, got {len(seed)}")
    return bytes_to_words(seed)


def seed_words_tensor(seed: bytes, device) -> torch.Tensor:
    """32-byte seed -> (8,) int32 word bit patterns on `device`."""
    return torch.from_numpy(seed_to_words(seed).view(np.int32).copy()).to(device)


def _messages(seed_words: torch.Tensor, shape: tuple, w8, w9, bit_len: int) -> torch.Tensor:
    """(*shape, 16) int32 single-block messages: seed || words 8, 9 (int64
    values in [0, 2**32)) || zeros || the bit length."""
    msg = torch.zeros(shape + (16,), dtype=torch.int32, device=seed_words.device)
    msg[..., :8] = seed_words.to(torch.int32)
    msg[..., 8] = words_i32(w8)
    msg[..., 9] = words_i32(torch.as_tensor(w9, dtype=torch.int64, device=seed_words.device))
    msg[..., 15] = bit_len
    return msg


def round_pivots(seed_words: torch.Tensor, n: int, rounds: int, h) -> torch.Tensor:
    """(rounds,) int64 pivots u64_le(sha256(seed || u8(round))[0:8]) % n.
    33-byte messages: byte 32 the round, byte 33 the 0x80 terminator."""
    r = torch.arange(rounds, dtype=torch.int64, device=seed_words.device)
    digest = words_i64(h(_messages(seed_words, (rounds,), (r << 24) | (0x80 << 16), 0, 264)))
    lo, hi = bswap32(digest[:, 0]), bswap32(digest[:, 1])
    # (hi * 2**32 + lo) % n without leaving int64: every term is below 2**62
    return ((hi % n) * (2**32 % n) + lo) % n


def round_sources(seed_words: torch.Tensor, rounds: int, buckets: int, h) -> torch.Tensor:
    """(rounds, buckets, 8) int32 source digests,
    sha256(seed || u8(round) || u32_le(bucket)): 37-byte messages."""
    dev = seed_words.device
    r = torch.arange(rounds, dtype=torch.int64, device=dev)[:, None]
    k = torch.arange(buckets, dtype=torch.int64, device=dev)[None, :]
    # bytes 32..35: round, bucket_le[0..2]; byte 36: bucket_le[3], then 0x80
    w8 = (r << 24) | ((k & 0xFF) << 16) | (((k >> 8) & 0xFF) << 8) | ((k >> 16) & 0xFF)
    w9 = (((k >> 24) & 0xFF) << 24) | (0x80 << 16)
    return h(_messages(seed_words, (rounds, buckets), w8, w9, 296))


def shuffle_rounds_plain(pivots: torch.Tensor, sources: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of K5: the (n,) int32 shuffled index map from
    (rounds,) pivots and (rounds, ceil(n/256), 8) int32 source digests."""
    idx = torch.arange(n, dtype=torch.int64, device=sources.device)
    src = words_i64(sources).reshape(sources.shape[0], -1)
    piv = pivots.to(torch.int64)
    for rnd in range(sources.shape[0]):
        flip = (piv[rnd] + n - idx) % n
        position = torch.maximum(idx, flip)
        # byte (position % 256) // 8 of the big-endian digest of bucket position // 256
        word = src[rnd][(position >> 8) * 8 + ((position >> 5) & 7)]
        byte = (word >> (24 - 8 * ((position >> 3) & 3))) & 0xFF
        bit = (byte >> (position & 7)) & 1
        idx = torch.where(bit == 1, flip, idx)
    return idx.to(torch.int32)


def _shuffle_rounds_kernel(pivots: torch.Tensor, sources: torch.Tensor, n: int) -> torch.Tensor:
    rounds = pivots.shape[0]
    if not 0 <= rounds < 256 or tuple(sources.shape) != (rounds, (n + 255) // 256, 8):
        raise ValueError(f"shuffle_rounds: {rounds} pivots and sources {tuple(sources.shape)} "
                         f"do not fit n = {n}")
    if sources.dtype != torch.int32 or pivots.device != sources.device:
        raise ValueError("shuffle_rounds: sources must be int32 words on the pivots' device")
    piv = pivots.to(torch.int32).contiguous()
    src = sources.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=src.device)
    fn = build.entry("shuffle", "shuffle_rounds", 3, 1)
    build.count_launch("shuffle_rounds")
    build.check(fn(piv.data_ptr(), src.data_ptr(), out.data_ptr(), n, rounds,
                   build.stream_ptr(out)), "shuffle_rounds")
    return out


def shuffle_rounds(pivots: torch.Tensor, sources: torch.Tensor, n: int) -> torch.Tensor:
    """Every round of the shuffle over all n indices: kernel K5 on CUDA
    tensors, `shuffle_rounds_plain` on CPU tensors."""
    if is_cpu(sources):
        return shuffle_rounds_plain(pivots, sources, n)
    return _shuffle_rounds_kernel(pivots, sources, n)


def _index_map(n: int, seed_words: torch.Tensor, rounds: int, h, rounds_fn) -> torch.Tensor:
    if not 1 <= n < 2**31:  # uint32 index math needs pivot + n - idx < 2**32
        raise ValueError(f"shuffle needs 1 <= n < 2**31, got {n}")
    pivots = round_pivots(seed_words, n, rounds, h)
    sources = round_sources(seed_words, rounds, (n + 255) // 256, h)
    return rounds_fn(pivots, sources, n)


def shuffled_index_map(n: int, seed_words: torch.Tensor, rounds: int) -> torch.Tensor:
    """(n,) int32 vector of compute_shuffled_index(i, n, seed) for all i,
    on seed_words' device (ops/shuffle.py:97): K4 and K5 on CUDA, their
    plain versions on the CPU."""
    return _index_map(n, seed_words, rounds, sha256_1block, shuffle_rounds)


def shuffled_index_map_plain(n: int, seed_words: torch.Tensor, rounds: int) -> torch.Tensor:
    """`shuffled_index_map` through the plain versions only, on any device."""
    return _index_map(n, seed_words, rounds, sha256_1block_plain, shuffle_rounds_plain)


def compute_shuffled_indices(n: int, seed: bytes, rounds: int, device="cuda") -> np.ndarray:
    """Host wrapper: the full shuffled-index map as numpy uint32."""
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    dev = resolve_device(device)
    out = shuffled_index_map(n, seed_words_tensor(seed, dev), rounds)
    return out.cpu().numpy().astype(np.uint32)


def compute_shuffled_indices_np(n: int, seed: bytes, rounds: int) -> np.ndarray:
    """Pure-host numpy/hashlib twin of `shuffled_index_map` (copied from the
    JAX package's ops/shuffle.py:134): the same round structure, one
    hashlib call per pivot and per source digest."""
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    if not 1 <= n < 2**31:
        raise ValueError(f"shuffle needs 1 <= n < 2**31, got {n}")
    idx = np.arange(n, dtype=np.uint64)
    un = np.uint64(n)
    buckets = (n + 255) // 256
    for rnd in range(rounds):
        rb = bytes([rnd])
        pivot = np.uint64(
            int.from_bytes(hashlib.sha256(seed + rb).digest()[:8], "little") % n)
        src = np.frombuffer(
            b"".join(hashlib.sha256(seed + rb + k.to_bytes(4, "little")).digest()
                     for k in range(buckets)),
            dtype=np.uint8,
        )
        flip = (pivot + un - idx) % un
        position = np.maximum(idx, flip)
        byte = src[(position >> 8) * 32 + ((position & 0xFF) >> 3)]
        bit = (byte >> (position & 0x7).astype(np.uint8)) & 1
        idx = np.where(bit == 1, flip, idx)
    return idx.astype(np.uint32)
