"""The spec's latest-message admission filter and ancestor walk as pure
functions over plain mappings (copies of the JAX package's
testlib/fork_choice.py `latest_message_updates` and `ancestor_at_slot`).
"""
from __future__ import annotations


def latest_message_updates(latest_messages, attesting_indices, target_epoch):
    """Pure twin of the spec's `update_latest_messages` admission filter
    (phase0/fork-choice.md): of `attesting_indices`, the indices whose
    latest message a new vote at `target_epoch` replaces — unseen
    validators, or ones whose recorded message is from a strictly earlier
    epoch. `latest_messages` maps index -> object with an `.epoch`
    attribute (the spec's LatestMessage, or any namedtuple twin)."""
    target_epoch = int(target_epoch)
    return [i for i in attesting_indices
            if i not in latest_messages
            or target_epoch > int(latest_messages[i].epoch)]


def ancestor_at_slot(blocks, root, slot):
    """Pure twin of the spec's `get_ancestor` over any {root: block-like}
    mapping (block-like = has `.slot` and `.parent_root`): walk parent
    pointers while the block sits above `slot`; at or below it, the
    current root is its own ancestor. Iterative where the spec recurses —
    thousand-slot chains would overflow Python's stack — and a parent
    outside the mapping (or a self-parented anchor) terminates at the
    current root where the spec would KeyError, which is what the
    anchored/padded fork-choice mirrors rely on."""
    slot = int(slot)
    block = blocks[root]
    while int(block.slot) > slot:
        parent = block.parent_root
        if parent == root or parent not in blocks:
            return root
        root = parent
        block = blocks[root]
    return root
