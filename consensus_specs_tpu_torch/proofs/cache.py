"""Epoch-versioned Merkle proof cache keyed by the dirty-column diff (the
port's copy of the JAX package's proofs/cache.py).

The epoch kernel reports exactly which registry columns a transition
touched (`engine/state.EpochAux.dirty_cols`; the resident loop
OR-accumulates them, `ResidentEpochLoop.dirty_columns()`). A branch proven inside a
column's chunk tree stays valid as long as that column's values do, so
the cache invalidates per COLUMN, not per epoch: clean columns keep their
sibling rows across epoch advances, only dirty columns drop.

Hit/miss/invalidation counters plus the hit-ratio and resident-entry
gauges land in obs (`proof_cache_*`), so the read lane's cache behaviour
is part of every snapshot.
"""
from __future__ import annotations

import threading

from ..obs import metrics as obs_metrics


class ProofCache:
    """(column, gindex) -> deepest-first sibling-branch tuple, dropped per
    dirty column at each epoch advance."""

    def __init__(self, registry: obs_metrics.MetricsRegistry | None = None):
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self._lock = threading.Lock()
        self._entries: dict[str, dict[int, tuple]] = {}
        self._hits = 0
        self._misses = 0
        self.epoch = 0

    def lookup(self, column: str, gindex: int):
        """Cached branch or None; counts the hit/miss and refreshes the
        hit-ratio gauge either way."""
        with self._lock:
            branch = self._entries.get(column, {}).get(int(gindex))
            if branch is None:
                self._misses += 1
                self.registry.counter(
                    "proof_cache_misses_total", column=column).inc()
            else:
                self._hits += 1
                self.registry.counter(
                    "proof_cache_hits_total", column=column).inc()
            self._refresh_gauges_locked()
            return branch

    def store(self, column: str, gindex: int, branch) -> None:
        with self._lock:
            self._entries.setdefault(column, {})[int(gindex)] = tuple(
                bytes(b) for b in branch)
            self._refresh_gauges_locked()

    def advance_epoch(self, dirty_columns) -> int:
        """Advance one epoch, invalidating exactly the dirty columns'
        entries; returns how many branches dropped. `dirty_columns` is an
        iterable of column names (a mapping counts its truthy-valued
        keys — the `resident.dirty_columns()` shape)."""
        if hasattr(dirty_columns, "items"):
            dirty_columns = [k for k, v in dirty_columns.items() if v]
        with self._lock:
            self.epoch += 1
            dropped = 0
            for col in dirty_columns:
                n = len(self._entries.pop(col, ()))
                if n:
                    self.registry.counter(
                        "proof_cache_invalidated_total", column=col).inc(n)
                dropped += n
            self._refresh_gauges_locked()
            return dropped

    def entries(self, column: str) -> dict:
        """Snapshot of one column's cached {gindex: branch} (tests and
        introspection; mutating the copy does not touch the cache)."""
        with self._lock:
            return dict(self._entries.get(column, ()))

    def size(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._entries.values())

    def _refresh_gauges_locked(self) -> None:
        total = self._hits + self._misses
        self.registry.gauge("proof_cache_hit_ratio").set(
            self._hits / total if total else 0.0)
        self.registry.gauge("proof_cache_entries").set(
            sum(len(v) for v in self._entries.values()))
