"""Fork choice (counterpart of the JAX package's forkchoice/): the store
mirrored in gather form (mirror.py), the spec-shaped host oracle
(reference.py), the spec's pure walk helpers (_walk.py) and a seeded
contested tree at registry scale (synthetic.py). The device head lives in
ops/forkchoice.py behind engine/fork_choice.py.
"""
from ._walk import ancestor_at_slot, latest_message_updates
from .mirror import ZERO_ROOT, StoreMirror, StoreSnapshot
from .reference import filtered_mask, host_head, subtree_weights

__all__ = [
    "StoreMirror",
    "StoreSnapshot",
    "ZERO_ROOT",
    "ancestor_at_slot",
    "filtered_mask",
    "host_head",
    "latest_message_updates",
    "subtree_weights",
]
