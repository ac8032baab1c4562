"""Batched Merkle multiproofs (counterpart of ops/multiproof_jax.py): the
read lane's kernel pair.

For a bucketed batch of (tree, gindex) queries over K equal-shape chunk
trees, every interior level is hashed once into a per-tree binary heap
addressed by generalized index (row 0 zero, row 1 the root, the leaves at
rows [C, 2C)), then each query gathers its node and its sibling rows,
deepest first: `ssz/proofs.build_chunk_proof` order. A query of depth
d < D fills siblings[:d]; the rows past it read the zero row.

Two kernels in csrc/multiproof.cu, each behind its wrapper: K20
`multiproof_heap` builds the heap (K19's fold keeping every level), K21
`multiproof_gather` (kernel `multiproof_siblings`) gathers the siblings,
nodes and roots. On CPU tensors each wrapper runs its plain version
(`multiproof_heap_plain`, `multiproof_gather_plain`), the same function in
plain PyTorch over int32 word bit patterns (K1's plain hash a level).

`sibling_rows_batch` runs both. It checks its inputs and raises ValueError: int32 (K, C, 8) chunks
with C a power of two, int32 (Q,) tree ids and gindices, all contiguous,
0 <= tree_id < K and 1 <= g < 2C. The JAX function does not check, and
leaves that to the scheduler's work class.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..utils.device import is_cpu
from .sha256 import sha256_64B_words_plain

HEAP_FOLD_MAX_LEVELS = 10  # levels one K20 launch folds: 2^10 rows a block


def _check(chunks: torch.Tensor, tree_ids: torch.Tensor, gindices: torch.Tensor) -> tuple:
    """(K, C, Q, D) of valid inputs; ValueError otherwise."""
    if chunks.dtype != torch.int32 or chunks.dim() != 3 or chunks.shape[2] != 8:
        raise ValueError(f"chunks must be (K, C, 8) int32, got {tuple(chunks.shape)} "
                         f"{chunks.dtype}")
    k, c = chunks.shape[0], chunks.shape[1]
    if c < 1 or c & (c - 1):
        raise ValueError(f"chunks per tree must be a power of two, got {c}")
    for name, t in (("tree_ids", tree_ids), ("gindices", gindices)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be (Q,) int32, got {tuple(t.shape)} {t.dtype}")
        if t.device != chunks.device:
            raise ValueError(f"{name} is on {t.device}, chunks on {chunks.device}")
    if tree_ids.shape != gindices.shape:
        raise ValueError(f"tree_ids {tuple(tree_ids.shape)} and gindices "
                         f"{tuple(gindices.shape)} differ in shape")
    if not (chunks.is_contiguous() and tree_ids.is_contiguous() and gindices.is_contiguous()):
        raise ValueError("chunks, tree_ids and gindices must be contiguous")
    q = gindices.shape[0]
    if q:
        lo_t, hi_t = torch.aminmax(tree_ids)
        lo_g, hi_g = torch.aminmax(gindices)
        lo_t, hi_t, lo_g, hi_g = torch.stack([lo_t, hi_t, lo_g, hi_g]).tolist()
        if lo_t < 0 or hi_t >= k:
            raise ValueError(f"tree ids must lie in [0, {k}), got [{lo_t}, {hi_t}]")
        if lo_g < 1 or hi_g >= 2 * c:
            raise ValueError(f"gindices must lie in [1, {2 * c}), got [{lo_g}, {hi_g}]")
    depth = (c - 1).bit_length()
    return k, c, q, max(depth, 1)


def gather_rows_index(tree_ids: torch.Tensor, gindices: torch.Tensor, k: int, c: int,
                      d: int) -> torch.Tensor:
    """The (Q*D + Q + K,) int64 heap rows K21 reads, in its output order:
    each query's D sibling rows (the walk's closed form, max(g >> i, 1) ^ 1),
    then each query's node, then each tree's root (row 1)."""
    base = tree_ids.long() * (2 * c)
    g = gindices.long()
    shifts = torch.arange(d, dtype=torch.int64, device=g.device)
    walk = base[:, None] + (torch.clamp(g[:, None] >> shifts[None, :], min=1) ^ 1)
    roots = torch.arange(k, dtype=torch.int64, device=g.device) * (2 * c) + 1
    return torch.cat([walk.reshape(-1), base + g, roots])


def multiproof_gather_plain(heap: torch.Tensor, tree_ids: torch.Tensor,
                            gindices: torch.Tensor, d: int) -> tuple:
    """Plain PyTorch version of K21: (siblings (Q, D, 8), nodes (Q, 8),
    roots (K, 8)) gathered from the (K, 2C, 8) heap."""
    k, c2 = heap.shape[0], heap.shape[1]
    q = gindices.shape[0]
    rows = heap.reshape(-1, 8)[gather_rows_index(tree_ids, gindices, k, c2 // 2, d)]
    return rows[:q * d].reshape(q, d, 8), rows[q * d:q * d + q], rows[q * d + q:]


def multiproof_heap_plain(chunks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K20: (K, C, 8) int32 words, C a power of
    two -> the (K, 2C, 8) heap. The K trees fold as one flat (K*C, 8) array,
    one level at a time (a level's adjacent pairs never cross a tree), and
    the levels are concatenated root first (ops/multiproof_jax.py:43-56)."""
    k, c = chunks.shape[0], chunks.shape[1]
    levels = [chunks.reshape(k * c, 8)]
    for _ in range((c - 1).bit_length()):
        levels.append(sha256_64B_words_plain(levels[-1].reshape(-1, 16)))
    zero = chunks.new_zeros((k, 1, 8))
    return torch.cat([zero] + [lvl.reshape(k, -1, 8) for lvl in reversed(levels)], dim=1)


def sibling_rows_batch_plain(chunks: torch.Tensor, tree_ids: torch.Tensor,
                             gindices: torch.Tensor) -> tuple:
    """Plain PyTorch version of K20 + K21 (ops/multiproof_jax.py:29
    `_sibling_rows_impl`): (siblings (Q, D, 8), nodes (Q, 8), roots (K, 8))
    int32, D = max(log2 C, 1)."""
    d = _check(chunks, tree_ids, gindices)[3]
    return multiproof_gather_plain(multiproof_heap_plain(chunks), tree_ids, gindices, d)


def multiproof_heap(chunks: torch.Tensor) -> torch.Tensor:
    """The (K, 2C, 8) heap of (K, C, 8) int32 chunks (C a power of two, the
    caller has checked them): K20 on a CUDA tensor, one launch a 10 levels
    (the first also copies the leaves and zeroes row 0); the plain version
    on a CPU tensor."""
    if is_cpu(chunks):
        return multiproof_heap_plain(chunks)
    k, c = chunks.shape[0], chunks.shape[1]
    if chunks.data_ptr() % 16:
        chunks = chunks.clone()  # the kernel reads 16-byte vectors
    heap = torch.empty((k, 2 * c, 8), dtype=torch.int32, device=chunks.device)
    fn = build.entry("multiproof", "multiproof_heap", 2, 6)
    src, stride, off, n_in = chunks, c, 0, c
    while True:
        s = min(HEAP_FOLD_MAX_LEVELS, (n_in - 1).bit_length())
        build.count_launch("multiproof_heap")
        build.check(fn(src.data_ptr(), heap.data_ptr(), k, stride, off, c, n_in, s,
                       int(src is chunks), build.stream_ptr(heap)), "multiproof_heap")
        n_in >>= s
        if n_in <= 1:
            return heap
        src, stride, off = heap, 2 * c, n_in


def multiproof_gather(heap: torch.Tensor, tree_ids: torch.Tensor, gindices: torch.Tensor,
                      d: int) -> tuple:
    """(siblings (Q, D, 8), nodes (Q, 8), roots (K, 8)) from the (K, 2C, 8)
    heap (inputs checked by the caller): K21 on CUDA tensors, one launch
    into one (Q*D + Q + K, 8) buffer, the three outputs views of it; the
    plain version on CPU tensors."""
    if is_cpu(heap):
        return multiproof_gather_plain(heap, tree_ids, gindices, d)
    k, c, q = heap.shape[0], heap.shape[1] // 2, gindices.shape[0]
    out = heap.new_empty((q * d + q + k, 8))
    fn = build.entry("multiproof", "multiproof_siblings", 4, 3)
    build.count_launch("multiproof_siblings")
    build.check(fn(heap.data_ptr(), tree_ids.data_ptr(), gindices.data_ptr(), out.data_ptr(),
                   q, d, k, c, build.stream_ptr(heap)), "multiproof_siblings")
    siblings, nodes, roots = out.split_with_sizes((q * d, q, k))
    return siblings.view(q, d, 8), nodes, roots


def sibling_rows_batch(chunks: torch.Tensor, tree_ids: torch.Tensor,
                       gindices: torch.Tensor) -> tuple:
    """Node, sibling rows and roots of Q (tree, gindex) queries over K chunk
    trees: (K, C, 8) int32 words (C a power of two), (Q,) int32 tree slots
    and in-tree generalized indices -> (siblings (Q, D, 8), nodes (Q, 8),
    roots (K, 8)) int32 with D = max(log2 C, 1). Kernels K20 then K21 on
    CUDA tensors, `sibling_rows_batch_plain` on CPU tensors."""
    if is_cpu(chunks):
        return sibling_rows_batch_plain(chunks, tree_ids, gindices)
    d = _check(chunks, tree_ids, gindices)[3]
    return multiproof_gather(multiproof_heap(chunks), tree_ids, gindices, d)
