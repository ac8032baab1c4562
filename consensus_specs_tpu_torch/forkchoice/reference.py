"""Host oracle for the fork choice: LMD-GHOST over a StoreSnapshot (a copy
of the JAX package's forkchoice/reference.py).

`host_head` follows the spec shape — `filter_block_tree`'s leaf rule, the
greedy `(weight, root)` child walk, and the proposer-boost ancestor test
through `ancestor_at_slot` (the spec's `get_ancestor` walk) — with one
documented departure: per-candidate LMD weights come from a single exact
int64 direct-vote accumulation plus one reverse subtree sweep instead of
O(B·V) ancestor walks. That is the same sum: slots strictly increase
parent -> child, so `get_ancestor(store, vote_root, candidate.slot) ==
candidate` holds exactly when the candidate is an ancestor-or-self of the
vote root, i.e. when the vote's block sits in the candidate's subtree.

numpy only: the oracle the device path is held against.
"""
from __future__ import annotations

import numpy as np

from ._walk import ancestor_at_slot
from .mirror import StoreSnapshot


class _BlockView:
    """Minimal block-like (slot, parent_root-as-index) for the spec walk."""

    __slots__ = ("slot", "parent_root")

    def __init__(self, slot: int, parent_root: int):
        self.slot = slot
        self.parent_root = parent_root


def subtree_weights(snap: StoreSnapshot) -> np.ndarray:
    """(B,) exact int64 LMD weight per candidate: direct latest-message
    balances accumulated up the tree (parent-before-child order makes one
    reverse sweep sufficient), plus the spec proposer-boost score on every
    ancestor-or-self of the boost root."""
    b = snap.n_blocks
    direct = np.zeros(b, dtype=np.int64)
    live = snap.votes >= 0
    np.add.at(direct, snap.votes[live], snap.balances[live])
    weight = direct
    parent = snap.parent
    for i in range(b - 1, -1, -1):
        p = int(parent[i])
        if p != i:
            weight[p] += weight[i]
    if snap.boost_idx >= 0:
        views = {i: _BlockView(int(snap.slots[i]), int(parent[i]))
                 for i in range(b)}
        for c in range(b):
            if ancestor_at_slot(views, snap.boost_idx,
                                snap.slots[c]) == c:
                weight[c] += snap.boost_weight
    return weight


def filtered_mask(snap: StoreSnapshot) -> np.ndarray:
    """(B,) bool: `get_filtered_block_tree` membership — descendants-or-self
    of the justified root owning at least one leaf whose state checkpoints
    agree with the store's (GENESIS_EPOCH short-circuits per spec)."""
    b = snap.n_blocks
    parent = snap.parent
    just_epoch, just_rid = snap.store_justified
    fin_epoch, fin_rid = snap.store_finalized
    genesis = snap.genesis_epoch
    has_child = np.zeros(b, dtype=bool)
    for i in range(b):
        if int(parent[i]) != i:
            has_child[int(parent[i])] = True
    viable = np.zeros(b, dtype=bool)
    for i in range(b):
        if has_child[i]:
            continue
        ok_just = (just_epoch == genesis
                   or (int(snap.ck_epochs[i, 0]) == just_epoch
                       and int(snap.ck_rids[i, 0]) == just_rid))
        ok_fin = (fin_epoch == genesis
                  or (int(snap.ck_epochs[i, 1]) == fin_epoch
                      and int(snap.ck_rids[i, 1]) == fin_rid))
        viable[i] = ok_just and ok_fin
    for i in range(b - 1, -1, -1):
        if viable[i] and int(parent[i]) != i:
            viable[int(parent[i])] = True
    under = np.zeros(b, dtype=bool)
    for i in range(b):
        under[i] = (i == snap.justified_idx
                    or (int(parent[i]) != i and under[int(parent[i])]))
    return viable & under


def host_head(snap: StoreSnapshot) -> int:
    """Head block index for one snapshot — the spec's greedy `get_head`
    walk over the filtered tree, ties broken by highest root bytes."""
    weight = subtree_weights(snap)
    keep = filtered_mask(snap)
    b = snap.n_blocks
    children: list = [[] for _ in range(b)]
    parent = snap.parent
    for i in range(b):
        if int(parent[i]) != i and keep[i]:
            children[int(parent[i])].append(i)
    head = int(snap.justified_idx)
    while children[head]:
        head = max(children[head],
                   key=lambda c: (int(weight[c]), snap.root_bytes(c)))
    return head
