"""Incremental device-side BeaconState roots for the resident loop
(counterpart of engine/incremental_root.py).

`state_root.field_roots` recomputes every registry-scale field root per
call. `IncrementalStateRoot` keeps the Merkle trees resident on the device
and rehashes only what changed:

  per epoch   balances / participation / inactivity roots rebuild (they
              change wholesale: `state_root.light_field_roots`); ONE randao
              row and ONE slashings entry per epoch path-update (their
              indices follow from the epoch number); the validator
              container roots update by dirty row: kernel K6 (`dirty_scan`)
              diffs the six registry columns against the cache's copies,
              and kernel K7 (`path_fold`) rehashes the dirty containers and
              folds their K tree paths in place
  per slot    one state_roots / block_roots leaf path-update
              (`record_state_root`, `record_block_root`: K7 at K = 1)
  always      the O(1) fields (slot, checkpoints, justification bits)

Above MAX_DIRTY_VALIDATORS dirty rows the refresh rebuilds the registry
tree (K2 + K1 levels). A tree lives in one flat (2**(d+1) - 1, 8) int32
buffer, leaves first (`TreeLevels`), which K1 fills level by level and K7
updates in place.

The cache holds COPIES of the registry columns: the resident step
overwrites the state's columns in place, so a cache of views would compare
each column with itself and never see a dirty row. The JAX package copies
for another reason (donation) with the same effect. K6 leaves no dirty
index list padded: the count crosses to the host once a refresh (as in
JAX), and K7 takes exactly that many paths, so the JAX package's padding
to a power of two and its nonzero fill with row 0 have no counterpart.

On CPU tensors every wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..ops.sha256 import merkle_parent_level, sha256_64B_words, sha256_64B_words_plain
from ..utils.device import is_cpu
from ..utils.u64 import bswap32, words_i32, words_i64
from .state import EpochState
from .state_root import (
    DEPTH_VALIDATORS,
    REGISTRY_COLUMNS,
    _extend,
    _mix_len,
    _u64_chunk_words,
    _u64_single_chunk,
    container_roots_plain,
    light_field_roots,
    registry_columns,
    validator_roots,
)

# Dirty-row budget for the masked validator update (the JAX package's
# value); a refresh that finds more rebuilds the registry tree.
MAX_DIRTY_VALIDATORS = 1024

# K7 leaf sources
FOLD_ROWS, FOLD_U64_CHUNKS, FOLD_VALIDATORS = 0, 1, 2


class TreeLevels:
    """The levels of a full binary Merkle tree of 2**depth leaves in one
    flat (2**(depth+1) - 1, 8) int32 buffer: level l (2**(depth-l) nodes)
    starts at row 2**(depth+1) - 2**(depth-l+1); the root is the last row."""

    def __init__(self, depth: int, device):
        self.depth = depth
        self.buf = torch.empty(((2 << depth) - 1, 8), dtype=torch.int32, device=device)

    def level(self, lvl: int) -> torch.Tensor:
        start = (2 << self.depth) - (2 << (self.depth - lvl))
        return self.buf[start:start + (1 << (self.depth - lvl))]

    def root(self) -> torch.Tensor:
        return self.buf[-1]


def _tree_depth(c: int) -> int:
    return (c - 1).bit_length() if c > 1 else 0


def build_tree_levels(chunks: torch.Tensor, out: TreeLevels | None = None) -> TreeLevels:
    """(C, 8) chunk words -> TreeLevels, C padded to the next power of two
    with zero CHUNKS (engine/incremental_root.py:56); every level one K1
    launch (`merkle_parent_level`) writing into the buffer. `out`, a tree
    of the same depth, is refilled in place."""
    depth = _tree_depth(chunks.shape[0])
    levels = out if out is not None else TreeLevels(depth, chunks.device)
    if levels.depth != depth:
        raise ValueError(f"tree of depth {levels.depth} cannot hold {chunks.shape[0]} chunks")
    leaves = levels.level(0)
    if chunks.data_ptr() != leaves.data_ptr():  # the caller may have written them in place
        leaves[:chunks.shape[0]] = chunks
    leaves[chunks.shape[0]:] = 0
    for lvl in range(depth):
        merkle_parent_level(levels.level(lvl), out=levels.level(lvl + 1))
    return levels


# ---------------------------------------------------------------------------
# Kernel K6 and its plain version


def dirty_scan_plain(fresh: tuple, cached: tuple, cap: int = MAX_DIRTY_VALIDATORS):
    """Plain PyTorch version of K6. fresh, cached: the six REGISTRY_COLUMNS
    of the state and of the cache. Returns ((1,) int32 count of rows that
    differ, (cap,) int64 whose first min(count, cap) entries are dirty row
    indices, here ascending) and copies the fresh values of every dirty row
    into `cached`, in place."""
    mask = torch.zeros_like(fresh[0], dtype=torch.bool)
    for a, b in zip(fresh, cached):
        mask |= a != b
    rows = torch.nonzero(mask).flatten()
    for a, b in zip(fresh, cached):
        b[rows] = a[rows]
    idx = torch.zeros(cap, dtype=torch.int64, device=mask.device)
    take = rows[:cap]
    idx[:take.shape[0]] = take
    return rows.shape[0] * torch.ones(1, dtype=torch.int32, device=mask.device), idx


def _check_columns(cols: tuple, n: int, what: str) -> None:
    for name, t in zip(REGISTRY_COLUMNS, cols):
        dtype = torch.bool if name == "slashed" else torch.int64
        if t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({n},) {dtype} tensor")


def _dirty_scan_kernel(fresh: tuple, cached: tuple, cap: int):
    n = fresh[0].shape[0]
    _check_columns(fresh, n, "dirty_scan")
    _check_columns(cached, n, "dirty_scan cache")
    dev = fresh[0].device
    if any(t.device != dev for t in fresh + cached):
        raise ValueError("dirty_scan: columns on different devices")
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    idx = torch.empty(cap, dtype=torch.int64, device=dev)
    order = (0, 2, 3, 4, 5, 1)  # the C argument order: eff, aee, act, ext, wd, slashed
    fn = build.entry("incremental_root", "dirty_scan", 14, 1)
    build.count_launch("dirty_scan")
    build.check(fn(*[fresh[i].data_ptr() for i in order], *[cached[i].data_ptr() for i in order],
                   count.data_ptr(), idx.data_ptr(), n, cap, build.stream_ptr(count)),
                "dirty_scan")
    return count, idx


def dirty_scan(fresh: tuple, cached: tuple, cap: int = MAX_DIRTY_VALIDATORS):
    """Kernel K6 on CUDA tensors, `dirty_scan_plain` on CPU tensors. The
    kernel's first min(count, cap) indices come in no fixed order."""
    if is_cpu(fresh[0]):
        return dirty_scan_plain(fresh, cached, cap)
    return _dirty_scan_kernel(fresh, cached, cap)


# ---------------------------------------------------------------------------
# Kernel K7 and its plain version


def _fold_leaves_plain(idx: torch.Tensor, mode: int, src, by_index: bool, validators):
    if mode == FOLD_VALIDATORS:
        static01, cols = validators
        return container_roots_plain(static01[idx], tuple(c[idx] for c in cols))
    if mode == FOLD_U64_CHUNKS:
        src = src.view(torch.int32).reshape(-1, 8)
    rows = src[idx] if by_index else src[:idx.shape[0]]
    if mode == FOLD_U64_CHUNKS:
        rows = words_i32(bswap32(words_i64(rows)))
    return rows


def path_fold_plain(levels: TreeLevels, idx: torch.Tensor, mode: int, src=None,
                    by_index: bool = True, validators=None) -> None:
    """Plain PyTorch version of K7 (engine/incremental_root.py:84
    `multi_path_update`, with the leaf gathers of :155 and :214): write K
    new leaves at positions idx and refold their paths, in place. The leaf
    j is, by mode: FOLD_ROWS, row idx[j] (by_index) or row j of src
    ((R, 8) int32); FOLD_U64_CHUNKS, the same row of src with each word
    byte-swapped (src an (V,) int64 vector viewed as (V/4, 8) int32 chunks
    of little-endian uint64 values); FOLD_VALIDATORS, the container root of
    validator idx[j] from validators = (static01, six REGISTRY_COLUMNS).
    Duplicate indices rehash equal values."""
    levels.level(0)[idx] = _fold_leaves_plain(idx, mode, src, by_index, validators)
    cur = idx
    for lvl in range(levels.depth):
        parent = cur >> 1
        nodes = levels.level(lvl)
        pairs = torch.cat([nodes[2 * parent], nodes[2 * parent + 1]], dim=1)
        levels.level(lvl + 1)[parent] = sha256_64B_words_plain(pairs)
        cur = parent


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t  # the kernel reads 16-byte vectors


def _path_fold_kernel(levels: TreeLevels, idx: torch.Tensor, mode: int, src, by_index: bool,
                      validators) -> None:
    dev = levels.buf.device
    k = idx.shape[0]
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.device != dev:
        raise ValueError("path_fold: idx must be a (K,) int64 tensor on the tree's device")
    ptrs = [0] * 8  # src, static01, eff, aee, act, ext, wd, slashed
    if mode == FOLD_VALIDATORS:
        static01, cols = validators
        n = static01.shape[0]
        if static01.dtype != torch.int32 or tuple(static01.shape) != (n, 16):
            raise ValueError("path_fold: static01 must be (N, 16) int32")
        _check_columns(cols, n, "path_fold")
        static01 = _aligned(static01)
        eff, slashed, aee, act, ext, wd = cols
        ptrs[1:] = [t.data_ptr() for t in (static01, eff, aee, act, ext, wd, slashed)]
        if any(t.device != dev for t in (static01, *cols)):
            raise ValueError("path_fold: validator columns on another device")
    else:
        rows = src.view(torch.int32).reshape(-1, 8) if mode == FOLD_U64_CHUNKS else src
        if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 8:
            raise ValueError("path_fold: leaf rows must be (R, 8) int32")
        if rows.device != dev:
            raise ValueError("path_fold: leaf rows on another device")
        if not by_index and rows.shape[0] < k:
            raise ValueError(f"path_fold: {k} leaves from {rows.shape[0]} rows")
        rows = _aligned(rows)
        ptrs[0] = rows.data_ptr()
    fn = build.entry("incremental_root", "path_fold", 10, 3)
    build.count_launch("path_fold")
    build.check(fn(levels.buf.data_ptr(), idx.data_ptr(), *ptrs, k, levels.depth, mode,
                   int(by_index), build.stream_ptr(idx)), "path_fold")


def path_fold(levels: TreeLevels, idx: torch.Tensor, mode: int, src=None, by_index: bool = True,
              validators=None) -> None:
    """Kernel K7 on CUDA tensors, `path_fold_plain` (which states the
    arguments) on CPU tensors. The indices stay on the device unchecked:
    each must be a leaf of the tree (and a row of src when by_index, a
    validator when FOLD_VALIDATORS), as the callers here make them."""
    if idx.shape[0] == 0:
        return
    if is_cpu(levels.buf):
        return path_fold_plain(levels, idx, mode, src, by_index, validators)
    return _path_fold_kernel(levels, idx, mode, src, by_index, validators)


def path_update(levels: TreeLevels, idx: int, node: torch.Tensor) -> None:
    """Replace leaf idx with the (8,) node and refold its path: depth
    hashes (engine/incremental_root.py:70), K7 at K = 1."""
    pos = torch.full((1,), idx, dtype=torch.int64, device=levels.buf.device)
    path_fold(levels, pos, FOLD_ROWS, node.reshape(1, 8), by_index=False)


def multi_path_update(levels: TreeLevels, idxs: torch.Tensor, nodes: torch.Tensor) -> None:
    """Replace K leaves with the (K, 8) nodes and refold: K x depth hashes."""
    path_fold(levels, idxs, FOLD_ROWS, nodes, by_index=False)


# ---------------------------------------------------------------------------


class IncrementalStateRoot:
    """Device-resident Merkle state for every registry-scale BeaconState
    field (engine/incremental_root.py:235).

    Built from a state; `refresh_after_epochs` follows each run of epoch
    steps, `record_state_root` / `record_block_root` follow each per-slot
    root write, and `device_roots(slot)` yields the 14 field roots, equal to
    `state_root.field_roots` of the same state.

    Contract (as in the JAX package): between the build or the previous
    refresh and a refresh, the state may have been changed only by epoch
    steps and by the per-slot root writes that went through record_*.
    `last_dirty` and `last_branch` ("none", "masked" or "full"; "build"
    before the first refresh) tell what the last refresh found and did."""

    def __init__(self, st: EpochState, static01: torch.Tensor):
        self.n = st.num_validators
        self._static01 = static01
        self._cached_cols = tuple(c.clone() for c in registry_columns(st))
        depth = _tree_depth(self.n)
        self._val_levels = TreeLevels(depth, st.device)
        self._val_root = self._rebuild_validators(st)
        self._randao_levels = build_tree_levels(st.randao_mixes)
        self._block_levels = build_tree_levels(st.block_roots)
        self._state_levels = build_tree_levels(st.state_roots)
        self._slash_levels = build_tree_levels(_u64_chunk_words(st.slashings))
        self._slash_len = st.slashings.shape[0]
        self._light = light_field_roots(st)
        self.last_dirty = self.n
        self.last_branch = "build"

    def _validators_list_root(self) -> torch.Tensor:
        root = _extend(self._val_levels.root(), self._val_levels.depth, DEPTH_VALIDATORS,
                       sha256_64B_words)
        return _mix_len(root, self.n, sha256_64B_words)

    def _rebuild_validators(self, st: EpochState) -> torch.Tensor:
        """Every container root (K2, into the leaf level), then every level
        (K1)."""
        leaves = self._val_levels.level(0)
        validator_roots(self._static01, st, out=leaves[:self.n])
        build_tree_levels(leaves[:self.n], out=self._val_levels)
        return self._validators_list_root()

    def refresh_after_epochs(self, st: EpochState, last_epoch: int, count: int,
                             epochs_per_historical_vector: int) -> None:
        """Update every cached root for a run of `count` epoch steps ending
        in epoch `last_epoch` (the epoch just entered). Each step writes one
        randao row (next_epoch % EPV) and resets one slashings entry
        (next_epoch % EPSV); within an EPV/EPSV window they are distinct,
        so path-updating each touched row against the current state is
        exact. The registry columns are diffed once for the whole run."""
        if st.num_validators != self.n:
            raise ValueError(
                f"IncrementalStateRoot built for {self.n} validators, got a state with "
                f"{st.num_validators}: registry growth is outside the epoch-only contract; "
                "build a new cache")
        self._light = light_field_roots(st)
        fresh = registry_columns(st)
        count_dirty, idxs = dirty_scan(fresh, self._cached_cols)
        dirty = int(count_dirty[0])  # the one host readout of a refresh
        self.last_dirty = dirty
        if dirty == 0:
            self.last_branch = "none"
        elif dirty <= MAX_DIRTY_VALIDATORS:
            self.last_branch = "masked"
            path_fold(self._val_levels, idxs[:dirty], FOLD_VALIDATORS,
                      validators=(self._static01, fresh))
            self._val_root = self._validators_list_root()
        else:
            self.last_branch = "full"
            self._val_root = self._rebuild_validators(st)

        if count > 0:
            dev = st.device
            epochs = torch.arange(last_epoch - count + 1, last_epoch + 1, dtype=torch.int64,
                                  device=dev)
            path_fold(self._randao_levels, epochs % epochs_per_historical_vector, FOLD_ROWS,
                      st.randao_mixes)
            path_fold(self._slash_levels, (epochs % self._slash_len) // 4, FOLD_U64_CHUNKS,
                      st.slashings)

    def record_state_root(self, slot_index: int, root_words: torch.Tensor) -> None:
        """process_slot writes hash_tree_root(state) into
        state_roots[slot % SLOTS_PER_HISTORICAL_ROOT]."""
        path_update(self._state_levels, slot_index, root_words)

    def record_block_root(self, slot_index: int, root_words: torch.Tensor) -> None:
        path_update(self._block_levels, slot_index, root_words)

    def device_roots(self, slot) -> dict:
        """{DEVICE_FIELDS name: (8,) int32 root words}; `slot` a () int64
        tensor or an int. The roots are copies: later updates of the cache
        leave a returned dict as it was."""
        roots = dict(self._light)
        dev = self._val_levels.buf.device
        roots["slot"] = _u64_single_chunk(torch.as_tensor(slot, dtype=torch.int64, device=dev))
        roots["validators"] = self._val_root.clone()
        roots["randao_mixes"] = self._randao_levels.root().clone()
        roots["block_roots"] = self._block_levels.root().clone()
        roots["state_roots"] = self._state_levels.root().clone()
        roots["slashings"] = self._slash_levels.root().clone()
        return roots
