"""Host entry for the device LMD-GHOST head: bucket, pad, launch
(counterpart of engine/fork_choice.py).

Snapshots group by their pow2 (blocks, validators) bucket, as the JAX
package groups them (one compiled program a bucket there; one launch of
each of K15-K18 a group here), and each group pads its query axis to a pow2
count by replicating the first member (discarded). Block-axis pads are
self-looped unreal rows (isolated in the ancestor bitsets, excluded from
every mask); validator-axis pads vote -1 with balance 0 (they match no
block).
"""
from __future__ import annotations

import numpy as np
import torch

from ..forkchoice.mirror import StoreSnapshot
from ..ops.forkchoice import ghost_head
from ..utils import bucketing
from ..utils.device import resolve_device

MIN_BLOCK_BUCKET = 8
MIN_VALIDATOR_BUCKET = 64


def _padded_member(snap: StoreSnapshot, b: int, v: int) -> tuple:
    n, nv = snap.n_blocks, snap.n_validators
    parent = np.arange(b, dtype=np.int32)
    parent[:n] = snap.parent
    if not (0 <= snap.justified_idx < n and -1 <= snap.boost_idx < n
            and ((parent >= 0) & (parent < b)).all()):
        raise ValueError("snapshot indices out of range: parents, justified_idx and "
                         "boost_idx must name blocks of the snapshot")
    root_words = np.zeros((b, 8), dtype=np.int64)
    root_words[:n] = np.asarray(snap.root_words, dtype=np.uint32)
    ck_epochs = np.zeros((b, 2), dtype=np.int64)
    ck_epochs[:n] = snap.ck_epochs
    ck_rids = np.full((b, 2), -1, dtype=np.int32)
    ck_rids[:n] = snap.ck_rids
    is_real = np.zeros(b, dtype=bool)
    is_real[:n] = True
    votes = np.full(v, -1, dtype=np.int32)
    votes[:nv] = snap.votes
    balances = np.zeros(v, dtype=np.int64)
    balances[:nv] = snap.balances
    idx_scalars = np.asarray(
        [snap.justified_idx, snap.boost_idx,
         snap.store_justified[1], snap.store_finalized[1]], dtype=np.int32)
    ep_scalars = np.asarray(
        [snap.store_justified[0], snap.store_finalized[0],
         snap.genesis_epoch, snap.boost_weight], dtype=np.int64)
    return (parent, root_words, ck_epochs, ck_rids, is_real, votes,
            balances, idx_scalars, ep_scalars)


def bucket_of(snap: StoreSnapshot) -> tuple:
    """The (blocks, validators) pow2 bucket a snapshot pads to."""
    return (bucketing.pow2_bucket(max(1, snap.n_blocks), MIN_BLOCK_BUCKET),
            bucketing.pow2_bucket(max(1, snap.n_validators), MIN_VALIDATOR_BUCKET))


def group_tensors(snapshots: list, device) -> list:
    """[((b, v), member indices, the group's 9 padded (Q, ...) tensors on
    `device`)] in bucket order; Q is the group's pow2 count, padded by
    replicating the first member."""
    dev = resolve_device(device)
    groups: dict = {}
    for i, snap in enumerate(snapshots):
        groups.setdefault(bucket_of(snap), []).append(i)
    out = []
    for (b, v), members in sorted(groups.items()):
        q = bucketing.pow2_bucket(len(members), 1)
        rows = [_padded_member(snapshots[i], b, v) for i in members]
        rows.extend([rows[0]] * (q - len(rows)))
        batch = [torch.from_numpy(np.stack(arrs)).to(dev) for arrs in zip(*rows)]
        out.append(((b, v), members, batch))
    return out


def ghost_head_batch(snapshots: list, device="cuda") -> np.ndarray:
    """(n,) int32 head block indices, one per StoreSnapshot, in order: one
    launch of each of K15-K18 a bucket group on the card (the plain
    versions for device="cpu")."""
    out = np.empty(len(snapshots), dtype=np.int32)
    for _, members, batch in group_tensors(snapshots, device):
        heads = ghost_head(*batch).cpu().numpy()
        for row, i in enumerate(members):
            out[i] = heads[row]
    return out
