"""Host-side store mirror: the gather-form arrays behind the head kernels
(a copy of the JAX package's forkchoice/mirror.py).

A StoreMirror incrementally tracks a spec Store as flat arrays: the block
tree as parent-pointer indices (parents always precede children, anchor
self-looped), per-validator latest messages as one int32 vote lane,
per-block FFG checkpoints as interned root ids + epochs. It emits immutable
StoreSnapshots, consumed identically by the device path
(engine/fork_choice.ghost_head_batch) and the host oracle
(forkchoice/reference.host_head).

Sync is incremental along every axis the Store itself grows
incrementally: blocks are an append-only suffix scan (dict insertion
order), latest messages a diff against a per-validator cache, and the
justified-state balance/boost-weight rebuild fires only when the store's
justified checkpoint actually moves. The mirror can also be driven
directly (add_block / set_vote / set_votes / set_registry) for synthetic
trees. `sync` is duck-typed over a compiled spec's Store.

numpy only: no torch, no device.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

ZERO_ROOT = b"\x00" * 32


@dataclass(frozen=True)
class StoreSnapshot:
    """One immutable gather-form view of a Store.

    Invariant: `parent[i] <= i` (insertion order is parent-before-child;
    the anchor — and any engine-side pad row — is self-looped), which is
    what lets the host oracle accumulate subtree weights in one reverse
    sweep and the kernel saturate ancestry in log2(B) doubling steps."""

    parent: np.ndarray      # (B,) int32 parent index, anchor self-looped
    slots: np.ndarray       # (B,) int64 block slots
    root_words: np.ndarray  # (B, 8) uint32 big-endian root words
    ck_epochs: np.ndarray   # (B, 2) int64 per-block (justified, finalized)
    ck_rids: np.ndarray     # (B, 2) int32 interned checkpoint-root ids
    votes: np.ndarray       # (V,) int32 latest-message block index, -1 none
    balances: np.ndarray    # (V,) int64 effective Gwei at justified state
    justified_idx: int      # index of store.justified_checkpoint.root
    boost_idx: int          # proposer-boost block index, -1 = boost off
    boost_weight: int       # spec committee-fraction score, exact Gwei
    store_justified: tuple  # (epoch, rid) of store.justified_checkpoint
    store_finalized: tuple  # (epoch, rid) of store.finalized_checkpoint
    genesis_epoch: int

    @property
    def n_blocks(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_validators(self) -> int:
        return int(self.votes.shape[0])

    def root_bytes(self, index: int) -> bytes:
        return self.root_words[index].astype(">u4").tobytes()


class StoreMirror:
    """Incrementally mirror a Store (or a hand-built tree) in gather form."""

    def __init__(self):
        # One reentrant lock over every public entry point: the mirror may
        # be mutated by one thread (a verified-vote feed) and read by
        # another. RLock, not Lock: `sync` re-enters `add_block`.
        self._lock = threading.RLock()
        self._block_index: dict = {}   # root bytes -> block index
        self._roots: list = []         # block index -> root bytes
        self._parent: list = []
        self._slots: list = []
        self._root_words: list = []    # (8,) uint32 rows
        self._ck_epochs: list = []     # (justified, finalized) epochs
        self._ck_rids: list = []       # (justified, finalized) root ids
        self._rids: dict = {}          # checkpoint root bytes -> interned id
        self._lm_cache: dict = {}      # validator -> (epoch, root bytes)
        self._votes = np.empty(0, dtype=np.int32)
        self._balances = np.empty(0, dtype=np.int64)
        self._justified_key = None     # (epoch, root) of last balance build
        self._justified_idx = 0
        self._boost_idx = -1
        self._boost_weight = 0
        self._store_justified = (0, 0)
        self._store_finalized = (0, 0)
        self._genesis_epoch = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._roots)

    @property
    def n_validators(self) -> int:
        with self._lock:
            return int(self._votes.shape[0])

    def root_at(self, index: int) -> bytes:
        with self._lock:
            return self._roots[index]

    def index_of(self, root) -> int:
        with self._lock:
            return self._block_index[bytes(root)]

    def _rid(self, root: bytes) -> int:
        rid = self._rids.get(root)
        if rid is None:
            rid = len(self._rids)
            self._rids[root] = rid
        return rid

    def _grow_validators(self, n: int) -> None:
        cur = self._votes.shape[0]
        if n <= cur:
            return
        votes = np.full(n, -1, dtype=np.int32)
        votes[:cur] = self._votes
        balances = np.zeros(n, dtype=np.int64)
        balances[:cur] = self._balances
        self._votes, self._balances = votes, balances

    # --- direct drive (synthetic trees, tests) ------------------------------

    def add_block(self, root, parent_root, slot, *,
                  justified=(0, ZERO_ROOT), finalized=(0, ZERO_ROOT)) -> int:
        """Append one block; the parent must already be present (or equal
        the block's own root for the anchor). `justified`/`finalized` are
        the block state's (epoch, checkpoint-root) pairs."""
        with self._lock:
            rb = bytes(root)
            pb = bytes(parent_root)
            if rb in self._block_index:
                return self._block_index[rb]
            index = len(self._roots)
            self._block_index[rb] = index
            self._roots.append(rb)
            self._parent.append(self._block_index.get(pb, index))
            self._slots.append(int(slot))
            self._root_words.append(
                np.frombuffer(rb, dtype=">u4").astype(np.uint32))
            self._ck_epochs.append((int(justified[0]), int(finalized[0])))
            self._ck_rids.append((self._rid(bytes(justified[1])),
                                  self._rid(bytes(finalized[1]))))
            return index

    def set_registry(self, balances) -> None:
        """Replace the effective-balance lane (grows the vote lane)."""
        balances = np.asarray(balances, dtype=np.int64)
        with self._lock:
            self._grow_validators(balances.shape[0])
            self._balances[:balances.shape[0]] = balances
            self._balances[balances.shape[0]:] = 0

    def set_vote(self, index: int, root) -> None:
        """Record validator `index`'s latest message as a block root (or
        None to clear). Admission filtering is the caller's job
        (`forkchoice._walk.latest_message_updates`)."""
        with self._lock:
            self._grow_validators(int(index) + 1)
            self._votes[int(index)] = (
                -1 if root is None else self._block_index[bytes(root)])

    def set_votes(self, indices, root) -> None:
        """`set_vote(i, root)` for every i in `indices` at once (a root,
        never None): one vectorized write for registry-sized swings."""
        indices = np.asarray(indices, dtype=np.int64)
        with self._lock:
            if indices.size:
                self._grow_validators(int(indices.max()) + 1)
            self._votes[indices] = self._block_index[bytes(root)]

    def set_checkpoints(self, justified, finalized, *,
                        genesis_epoch: int = 0) -> None:
        """Set the store-level (epoch, root) checkpoint pair; the
        justified root must be a known block."""
        with self._lock:
            self._justified_idx = self._block_index[bytes(justified[1])]
            self._store_justified = (int(justified[0]),
                                     self._rid(bytes(justified[1])))
            self._store_finalized = (int(finalized[0]),
                                     self._rid(bytes(finalized[1])))
            self._genesis_epoch = int(genesis_epoch)

    def set_boost(self, root, weight: int = 0) -> None:
        with self._lock:
            self._boost_idx = (-1 if root is None
                               else self._block_index.get(bytes(root), -1))
            self._boost_weight = int(weight)

    # --- incremental Store sync -------------------------------------------

    def sync(self, spec, store) -> None:
        """Fold the Store's growth since the last sync into the mirror."""
        with self._lock:
            blocks = store.blocks
            if len(blocks) > len(self._roots):
                for root, block in list(blocks.items())[len(self._roots):]:
                    state = store.block_states[root]
                    cj = state.current_justified_checkpoint
                    cf = state.finalized_checkpoint
                    self.add_block(
                        root, block.parent_root, block.slot,
                        justified=(int(cj.epoch), bytes(cj.root)),
                        finalized=(int(cf.epoch), bytes(cf.root)))

            jc = store.justified_checkpoint
            jkey = (int(jc.epoch), bytes(jc.root))
            if jkey != self._justified_key:
                state = store.checkpoint_states[jc]
                active = spec.get_active_validator_indices(
                    state, spec.get_current_epoch(state))
                self._grow_validators(len(state.validators))
                self._balances[:] = 0
                validators = state.validators
                for i in active:
                    self._balances[int(i)] = int(
                        validators[int(i)].effective_balance)
                num = len(active)
                if num:
                    # spec get_latest_attesting_balance proposer_score:
                    # (num_active/SLOTS_PER_EPOCH) * avg_balance * BOOST // 100
                    avg = int(spec.get_total_active_balance(state)) // num
                    committee_size = num // int(spec.SLOTS_PER_EPOCH)
                    self._boost_weight = (
                        committee_size * avg
                        * int(spec.config.PROPOSER_SCORE_BOOST)) // 100
                else:
                    self._boost_weight = 0
                self._justified_key = jkey

            for i, lm in store.latest_messages.items():
                index = int(i)
                entry = (int(lm.epoch), bytes(lm.root))
                if self._lm_cache.get(index) != entry:
                    self._lm_cache[index] = entry
                    self._grow_validators(index + 1)
                    self._votes[index] = self._block_index.get(entry[1], -1)

            fc = store.finalized_checkpoint
            self._justified_idx = self._block_index[bytes(jc.root)]
            self._store_justified = (int(jc.epoch), self._rid(bytes(jc.root)))
            self._store_finalized = (int(fc.epoch), self._rid(bytes(fc.root)))
            self._genesis_epoch = int(spec.GENESIS_EPOCH)
            pb = bytes(store.proposer_boost_root)
            self._boost_idx = (self._block_index.get(pb, -1)
                               if pb != ZERO_ROOT else -1)

    def snapshot(self) -> StoreSnapshot:
        """Freeze the current mirror state (arrays copied: a snapshot must
        not alias the live lanes)."""
        with self._lock:
            b = len(self._roots)
            if b == 0:
                raise ValueError("empty mirror: no anchor block synced")
            return StoreSnapshot(
                parent=np.asarray(self._parent, dtype=np.int32),
                slots=np.asarray(self._slots, dtype=np.int64),
                root_words=np.vstack(self._root_words).astype(np.uint32),
                ck_epochs=np.asarray(self._ck_epochs, dtype=np.int64),
                ck_rids=np.asarray(self._ck_rids, dtype=np.int32),
                votes=self._votes.copy(),
                balances=self._balances.copy(),
                justified_idx=int(self._justified_idx),
                boost_idx=int(self._boost_idx),
                boost_weight=int(self._boost_weight),
                store_justified=self._store_justified,
                store_finalized=self._store_finalized,
                genesis_epoch=int(self._genesis_epoch))
