"""Merkleization core (the port's copy of the JAX package's ssz/merkle.py).

Reference parity: eth2spec's merkle_minimal (tests/core/pyspec/eth2spec/utils/
merkle_minimal.py) and the merkleization rules of ssz/simple-serialize.md:210-249
— but level hashing is *batched*: each tree level is one call into the native
pair hasher (native/hashtree.cpp, SHA-NI where the CPU has it) over all parent
nodes, instead of a Python loop of hashlib calls. Virtual zero-subtree padding
keeps huge-limit lists (e.g. the 2^40 validator registry limit) O(n) instead
of O(limit). The copy drops the JAX package's numpy and hashlib fallbacks: a
pair hasher that does not build raises (native/hashtree.py).
"""
from __future__ import annotations

from typing import Sequence

from ..native import hashtree as _native
from ..utils.hash import hash_eth2

ZERO_CHUNK = b"\x00" * 32

# zerohashes[i] = root of a depth-i tree of zero chunks.
zerohashes: list[bytes] = [ZERO_CHUNK]
for _ in range(64):
    zerohashes.append(hash_eth2(zerohashes[-1] + zerohashes[-1]))

def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def hash_pairs_blob(data: bytes) -> bytes:
    """sha256 every 64-byte pair of `data` into one 32-byte digest each, in
    one call into the native pair hasher."""
    return _native.hash_pairs(data)


def hash_level(level: Sequence[bytes], depth: int) -> list[bytes]:
    """Hash one level of 32-byte nodes into parents; odd tail is padded with
    the zero-subtree root for `depth` (the level's height above the leaves)."""
    n = len(level)
    if n % 2 == 1:
        level = list(level) + [zerohashes[depth]]
        n += 1
    out = hash_pairs_blob(b"".join(level))
    return [out[32 * i : 32 * (i + 1)] for i in range(n // 2)]


def merkleize_chunks(chunks: Sequence[bytes], limit: int | None = None) -> bytes:
    """Merkle root of `chunks`, padded with zero chunks to next_power_of_two
    (of `limit` if given). ssz/simple-serialize.md merkleize(chunks, limit).

    Raises ValueError if len(chunks) exceeds the limit.
    """
    count = len(chunks)
    if limit is None:
        limit = count
    if count > limit:
        raise ValueError(f"merkleize: {count} chunks exceeds limit {limit}")
    target = next_power_of_two(limit)
    depth = target.bit_length() - 1
    if count == 0:
        return zerohashes[depth]
    level = list(chunks)
    for d in range(depth):
        if len(level) == 1:
            # Remaining ancestors combine with pure zero subtrees.
            root = level[0]
            for d2 in range(d, depth):
                root = hash_eth2(root + zerohashes[d2])
            return root
        level = hash_level(level, d)
    return level[0]


class IncrementalTree:
    """Materialized level-array merkle tree over 32-byte chunks, supporting
    in-place chunk updates with O(dirty · log n) rehashing — the structural-
    sharing role remerkleable's persistent tree plays for the reference
    (eth2spec/utils/ssz/ssz_typing.py re-exports), shaped for the batched
    hash kernels: every level's dirty parents rehash in ONE
    `hash_pairs_blob` call.

    Levels store only the data region as contiguous bytearrays (32 bytes per
    node — 1M validators cost ~64 MB, not a pointer-heavy object tree); the
    zero-padded tail out to `limit` is folded in virtually via `zerohashes`.
    Structural changes (append/pop/length change) are the caller's problem:
    rebuild the tree (sequence types set a structural flag and do exactly
    that)."""

    __slots__ = ("limit", "levels")

    def __init__(self, chunks_blob: bytes, limit: int):
        if len(chunks_blob) % 32:
            raise ValueError("chunk blob must be a multiple of 32 bytes")
        n = len(chunks_blob) // 32
        if n > limit:
            raise ValueError(f"IncrementalTree: {n} chunks exceeds limit {limit}")
        self.limit = limit
        self.levels = [bytearray(chunks_blob)]
        if n > 1:
            built = _native.build_tree_levels(bytes(chunks_blob))
            if built is not None:
                self.levels.extend(built)
                return
        d = 0
        while len(self.levels[-1]) > 32:
            cur = self.levels[-1]
            if (len(cur) // 32) % 2:
                cur = cur + zerohashes[d]
            self.levels.append(bytearray(hash_pairs_blob(bytes(cur))))
            d += 1

    @property
    def depth(self) -> int:
        return next_power_of_two(self.limit).bit_length() - 1

    def n_chunks(self) -> int:
        return len(self.levels[0]) // 32

    def root(self) -> bytes:
        depth = self.depth
        if not self.levels[0]:
            return zerohashes[depth]
        root = bytes(self.levels[-1][:32])
        for d in range(len(self.levels) - 1, depth):
            root = hash_eth2(root + zerohashes[d])
        return root

    def clone(self) -> "IncrementalTree":
        """Independent deep copy (copy-on-write would save memory but the
        updates mutate level bytes in place; clones must not share)."""
        new = IncrementalTree.__new__(IncrementalTree)
        new.limit = self.limit
        new.levels = [bytearray(lv) for lv in self.levels]
        return new

    def update(self, updates: dict[int, bytes]) -> None:
        """Overwrite chunks {index: 32-byte value} and rehash their paths.
        Indices past the current chunk count are ignored (stale dirty marks
        from since-popped elements)."""
        lv0 = self.levels[0]
        n0 = len(lv0) // 32
        idxs = set()
        for i, v in updates.items():
            if i < n0:
                lv0[32 * i : 32 * (i + 1)] = v
                idxs.add(i >> 1)
        for d in range(len(self.levels) - 1):
            cur, nxt = self.levels[d], self.levels[d + 1]
            count = len(cur) // 32
            zh = zerohashes[d]
            cols = sorted(idxs)
            buf = bytearray()
            for j in cols:
                buf += cur[64 * j : 64 * j + 32]
                right = cur[64 * j + 32 : 64 * j + 64]
                buf += right if right else zh
            out = hash_pairs_blob(bytes(buf))
            for k, j in enumerate(cols):
                nxt[32 * j : 32 * (j + 1)] = out[32 * k : 32 * (k + 1)]
            idxs = {j >> 1 for j in cols}


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_eth2(root + length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_eth2(root + selector.to_bytes(32, "little"))


def subtree_root(chunks: Sequence[bytes], height: int, index: int) -> bytes:
    """Root of the subtree of `height` at position `index` within the
    virtually zero-padded chunk sequence (leaf span: index*2^h .. (index+1)*2^h)."""
    start = index << height
    if start >= len(chunks):
        return zerohashes[height]
    if height == 0:
        return chunks[start]
    left = subtree_root(chunks, height - 1, 2 * index)
    right = subtree_root(chunks, height - 1, 2 * index + 1)
    return hash_eth2(left + right)


def calc_merkle_tree_from_leaves(values: Sequence[bytes], layer_count: int = 32) -> list[list[bytes]]:
    """Full power-of-two padded tree as a list of layers (layer 0 = leaves).

    Reference parity: merkle_minimal.calc_merkle_tree_from_leaves
    (eth2spec/utils/merkle_minimal.py:12). Materializes 2^layer_count leaf
    slots *virtually*: each layer stores only the non-zero prefix.
    """
    tree: list[list[bytes]] = [list(values)]
    for d in range(layer_count):
        level = tree[-1]
        tree.append(hash_level(level, d) if level else [])
    return tree


def get_merkle_root(tree: list[list[bytes]]) -> bytes:
    top = tree[-1]
    return top[0] if top else zerohashes[len(tree) - 1]


def get_merkle_proof(tree: list[list[bytes]], item_index: int, tree_len: int | None = None) -> list[bytes]:
    """Sibling path for leaf `item_index` (reference parity:
    merkle_minimal.get_merkle_proof, which defaults to len(tree) siblings —
    one per stored layer including the top). `tree_len` overrides proof depth."""
    depth = (tree_len if tree_len is not None else len(tree))
    proof = []
    for d in range(depth):
        layer = tree[d]
        sibling_idx = (item_index >> d) ^ 1
        proof.append(layer[sibling_idx] if sibling_idx < len(layer) else zerohashes[d])
    return proof
