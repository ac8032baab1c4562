"""Route a compiled spec module's epoch transition through the port's
bridge (counterpart of scenarios/lanes.py:247-275 `_engine_epoch_router`).

    spec = build_spec("altair", "mainnet")
    with routed_spec(spec, device="cuda"):
        spec.state_transition(state, signed_block)

Inside the context:
- `process_epoch` runs `bridge.apply_epoch_via_engine` on `device` for
  altair and later states; phase0 states (no participation flags) stay on
  the pure path. The patch is removed around each bridge call, so nothing
  the bridge calls can reach the bridge again.

Every name is restored on exit, also when the body raises. The caller
builds the module (`compiler.build_spec`); the BLS shim and the shuffle hook
are bound there.

`memoized_total_active_balance(spec)` is a separate host-side cut, not
routing: it memoizes `get_total_active_balance` on (registry root, current
epoch). The sum of the active validators' effective balances is fixed by
the registry root and the epoch, so the memo returns what the spec
function returns. Without it every newly set participation flag of a
block's attestations (`get_base_reward`) sums the whole registry again:
1,536 sums of 2^20 balances for one committee of 512 at mainnet scale.
"""
from __future__ import annotations

from contextlib import contextmanager

from . import bridge

_MEMO_SIZE = 16


@contextmanager
def routed_spec(spec, device="cuda", **bridge_kwargs):
    """Route `spec.process_epoch` through the bridge on `device` (keyword
    arguments go to `apply_epoch_via_engine` on every call); yields the
    module."""
    original_epoch = spec.process_epoch

    def routed(state):
        if not hasattr(state, "previous_epoch_participation"):
            return original_epoch(state)
        spec.process_epoch = original_epoch
        try:
            bridge.apply_epoch_via_engine(spec, state, device=device, **bridge_kwargs)
        finally:
            spec.process_epoch = routed

    spec.process_epoch = routed
    try:
        yield spec
    finally:
        spec.process_epoch = original_epoch


@contextmanager
def memoized_total_active_balance(spec):
    """Memoize `spec.get_total_active_balance` on (registry root, current
    epoch), keeping the last 16 entries; yields the module."""
    original = spec.get_total_active_balance
    memo: dict = {}

    def total_active_balance(state):
        key = (bytes(state.validators.hash_tree_root()), int(spec.get_current_epoch(state)))
        value = memo.get(key)
        if value is None:
            value = original(state)
            if len(memo) >= _MEMO_SIZE:
                memo.pop(next(iter(memo)))
            memo[key] = value
        return value

    spec.get_total_active_balance = total_active_balance
    try:
        yield spec
    finally:
        spec.get_total_active_balance = original
