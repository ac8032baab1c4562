"""Read-lane front end: cache lookups backed by sched multiproof batches
(the port's copy of the JAX package's proofs/service.py).

A ProofService owns column providers (name -> callable returning the
column's CURRENT 32-byte chunk list), a ProofCache, and a scheduler.
`prove_many` answers every query it can from cache and batches the misses
into "multiproof" submits on the merkle work class: one flush serves all
misses, same-column queries share one provider read and one device tree
slot, and each device branch is stored back so the next epoch's clean
columns answer from cache. `note_epoch` wires the resident loop's
dirty-column diff into the cache's invalidation.

The lane's own latency histogram (`proof_request_latency_seconds`) is
where the lane's p99 comes from: each query in a batch observes the full
batch latency — what a beacon-API caller of that batch actually waited.
With a tracer installed, `prove_many` opens the span `proofs.prove_many`
(annotated with its query count and the latency each of them observed, so
a reader can take exact quantiles that the histogram's buckets blur) and,
around the column reads of a flush, `proofs.provider_read`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..sched.api import Request
from .cache import ProofCache


def u64_column_chunks(column) -> list[bytes]:
    """SSZ-pack a uint64 column into 32-byte chunks (4 values per chunk,
    little-endian, zero-padded) — the registry-column leaf layout the
    multiproof kernel serves. `column` is a numpy array or a CPU tensor
    (the port's uint64 columns are int64 bit patterns); a provider over a
    CUDA column copies it to the host first, once per flush."""
    if isinstance(column, torch.Tensor):
        if column.device.type != "cpu":
            raise ValueError(f"u64_column_chunks takes a CPU tensor or a numpy array, got a "
                             f"tensor on {column.device}: copy it to the host first")
        column = column.numpy()
    a = np.asarray(column).astype("<u8", copy=False).reshape(-1)
    pad = (-a.shape[0]) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, dtype="<u8")])
    raw = a.tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def leaf_gindex(chunk_index: int, chunk_count: int) -> int:
    """Generalized index of chunk `chunk_index` within a chunk tree padded
    to the next power of two — the "multiproof" kind's leaf addressing."""
    from ..ssz.merkle import next_power_of_two

    c_full = next_power_of_two(max(1, int(chunk_count)))
    if not 0 <= int(chunk_index) < c_full:
        raise ValueError(
            f"chunk index {chunk_index} outside the {c_full}-leaf tree")
    return c_full + int(chunk_index)


class ProofService:
    """Serve (column, gindex) branch queries: cache first, batched device
    multiproofs for the misses, dirty-column invalidation per epoch."""

    def __init__(self, scheduler=None, cache: ProofCache | None = None,
                 registry: obs_metrics.MetricsRegistry | None = None):
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self.cache = (cache if cache is not None
                      else ProofCache(registry=self.registry))
        self._scheduler = scheduler
        self._providers: dict = {}
        self._latency = self.registry.histogram(
            "proof_request_latency_seconds")
        self._requests = self.registry.counter("proof_requests_total")

    def _sched(self):
        if self._scheduler is None:
            from ..sched.scheduler import default_scheduler

            self._scheduler = default_scheduler()
        return self._scheduler

    def register_column(self, name: str, chunks_provider) -> None:
        """`chunks_provider()` must return the column's CURRENT 32-byte
        chunk list; it is consulted at most once per prove_many flush."""
        self._providers[name] = chunks_provider

    def note_epoch(self, dirty) -> int:
        """Advance the cache one epoch given the dirty-column diff
        (mapping name -> moved, or an iterable of dirty names); returns
        the number of invalidated branches."""
        return self.cache.advance_epoch(dirty)

    def prove(self, column: str, gindex: int) -> tuple:
        return self.prove_many([(column, gindex)])[0]

    def prove_host(self, column: str, gindex: int) -> tuple:
        """Degraded read: serve the branch from the host `build_chunk_proof`
        oracle, bypassing cache and scheduler entirely. This is the shed
        ladder's light-client fallback (the JAX package's front door): when
        the device lanes are saturated, a caller that opted into degraded reads still gets a
        bit-identical branch — build_chunk_proof is the same oracle the
        multiproof kernel is pinned against — it just pays host latency and
        never warms the cache."""
        if column not in self._providers:
            raise KeyError(f"unregistered proof column {column!r}")
        from ..ssz.proofs import build_chunk_proof

        chunks = list(map(bytes, self._providers[column]()))
        branch = tuple(build_chunk_proof(chunks, int(gindex)))
        self.registry.counter("proof_degraded_reads_total").inc()
        return branch

    def prove_many(self, queries) -> list:
        """One branch (deepest-first tuple of 32-byte siblings) per
        (column, gindex) query, in input order; cache hits answer
        immediately, misses batch into one scheduler flush."""
        with obs_trace.span("proofs.prove_many"):
            return self._prove_many(queries)

    def _prove_many(self, queries) -> list:
        t0 = time.perf_counter()
        queries = list(queries)
        results: list = [None] * len(queries)
        misses = []
        for qi, (column, gindex) in enumerate(queries):
            if column not in self._providers:
                raise KeyError(f"unregistered proof column {column!r}")
            branch = self.cache.lookup(column, gindex)
            if branch is None:
                misses.append(qi)
            else:
                results[qi] = branch
        if misses:
            sched = self._sched()
            with obs_trace.span("proofs.provider_read"):
                chunks_by_column: dict = {}
                for qi in misses:
                    column = queries[qi][0]
                    if column not in chunks_by_column:
                        chunks_by_column[column] = tuple(
                            map(bytes, self._providers[column]()))
            handles = []
            for qi in misses:
                column, gindex = queries[qi]
                handles.append(sched.submit(Request(
                    work_class="merkle", kind="multiproof",
                    payload=(chunks_by_column[column], int(gindex)))))
            sched.flush("merkle")
            for qi, h in zip(misses, handles):
                column, gindex = queries[qi]
                branch = tuple(h.result())
                self.cache.store(column, gindex, branch)
                results[qi] = branch
        dt = time.perf_counter() - t0
        self._requests.inc(len(queries))
        for _ in queries:
            self._latency.observe(dt)
        obs_trace.annotate(queries=len(queries), request_latency_s=dt)
        return results
