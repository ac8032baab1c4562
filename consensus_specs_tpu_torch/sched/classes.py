"""Work classes served by the port's scheduler (counterpart of the JAX
package's sched/classes.py).

A work class owns everything lane-specific the scheduler itself must not
know: how a batch of requests executes on the device (`execute`), the
pure-Python degrade path the circuit breaker falls back to
(`execute_degraded`), how a result row converts to the caller-facing value
(`to_result`), the live/padded unit accounting behind the occupancy and
pad-waste metrics (`load`), and — for classes that opt in — the admission
collapse hooks (`collapse_key` / `merge`).

Executors return a numpy array with one row per request. The scheduler
validates shape and dtype after the `sched.dispatch` fault seam, so
corrupt-kind chaos faults are caught and retried instead of resolving
handles with garbage.

The port has one class so far, `MerkleWorkClass`; the JAX package's BLS,
KZG, MSM and fork-choice classes are still to come (ROADMAP A4(b)). The
engine modules are imported inside the execute bodies, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np

from ..obs import trace as _obs_trace
from ..utils.device import resolve_device
from . import bucketing
from .api import Request


class WorkClass:
    """Base class: one verification lane behind the shared dispatch seam."""

    name = "work"
    kinds: tuple = ()
    # per-class queue-depth flush trigger; None defers to the scheduler's
    # default admission policy
    max_depth: int | None = None
    min_bucket = bucketing.MIN_BUCKET

    def execute(self, requests: list) -> np.ndarray:
        """Device path: one row per request."""
        raise NotImplementedError

    @staticmethod
    def pack(requests: list, members: list, c_full: int) -> tuple:
        """The kernel inputs of one leaf-count bucket: (words (b_k, c_full, 8)
        uint32, tree_ids (b_q,) int32, gindices (b_q,) int32, queries), where
        members are the bucket's (request index, gindex) pairs and queries
        the (request index, tree slot, gindex) of each live row. Equal trees
        share one slot; the tree axis pads with zero trees and the query axis
        with root queries against tree 0."""
        # slots by content; the slot memoized by payload identity: a
        # proof-service flush reuses ONE chunks tuple for a whole column's
        # queries, so the O(leaf-count) key build and its hash run once per
        # distinct tuple, not once per request (the payloads stay alive in
        # `requests`, so ids cannot be recycled underneath the memo)
        slots: dict = {}
        slot_of_payload: dict = {}
        queries = []
        for i, g in members:
            chunks = requests[i].payload[0]
            slot = slot_of_payload.get(id(chunks))
            if slot is None:
                slot = slots.setdefault(tuple(map(bytes, chunks)), len(slots))
                slot_of_payload[id(chunks)] = slot
            queries.append((i, slot, g))
        b_k = bucketing.pow2_bucket(len(slots), 1)
        b_q = bucketing.pow2_bucket(len(queries), 1)
        words = np.zeros((b_k, c_full, 8), dtype=np.uint32)
        for key, slot in slots.items():
            words[slot, :len(key)] = _leaf_words(key)
        tree_ids = np.zeros(b_q, dtype=np.int32)
        gidx = np.ones(b_q, dtype=np.int32)  # pad: root query on tree 0
        for row, (i, slot, g) in enumerate(queries):
            tree_ids[row] = slot
            gidx[row] = g
        return words, tree_ids, gidx, queries

    def execute_degraded(self, requests: list) -> np.ndarray:
        """Pure-host fallback the breaker degrades to; must agree with
        `execute` bit-for-bit on every valid input."""
        raise NotImplementedError

    def to_result(self, row):
        return bool(row)

    def load(self, requests: list) -> tuple:
        """(live_units, padded_units) for the dispatched batch — feeds the
        sched_batch_occupancy / sched_pad_waste series."""
        n = len(requests)
        return n, bucketing.pow2_bucket(n, self.min_bucket)

    # -- admission collapse (off unless a class overrides) -----------------

    def collapse_key(self, request: Request):
        """Truthy key = this request may merge with queued requests sharing
        the key into ONE device check. None = never collapse."""
        return None

    def merge(self, merged: Request, request: Request) -> Request:
        """Fold `request` into the synthetic collapsed request `merged`;
        raising aborts the collapse (the request queues individually)."""
        raise NotImplementedError

    # Optional batched collapse hook used by Scheduler.submit_many:
    # merge_group(merged, requests) folds a whole same-key group in one
    # aggregation pass. None = the scheduler chains pairwise merge() calls.
    merge_group = None

    # Optional post-dispatch value check: verify_results(requests, results)
    # runs after the scheduler's shape/dtype validation and raises a
    # retryable IntegrityError when a structurally valid batch fails a
    # semantic self-check. None = no check.
    verify_results = None


def _leaf_words(leaves) -> np.ndarray:
    """(n, 8) big-endian words of n 32-byte leaves, one frombuffer over their
    join (the words the JAX package packs leaf by leaf); assigning them into
    a uint32 array converts them."""
    blob = b"".join(map(bytes, leaves))
    if len(blob) != 32 * len(leaves):
        raise ValueError("every Merkle leaf must be 32 bytes")
    return np.frombuffer(blob, dtype=">u4").reshape(-1, 8)


class MerkleWorkClass(WorkClass):
    """Batched SSZ chunk-tree lanes. Two kinds, both over 32-byte leaves:

    - "tree_root": payload = (chunks,). Trees sharing a leaf count fold in
      one `engine/state_root.tree_root_batch` call (kernel K19), padded to
      the pow2 tree bucket with zero trees (results discarded); host
      fallback is the ssz merkleize oracle.
    - "multiproof": payload = (chunks, gindex) with gindex a generalized
      index over the pow2-padded chunk tree (1 = root, C..2C-1 = leaves).
      Queries sharing a leaf-count bucket fold in one
      `engine/state_root.multiproof_batch` call (kernels K20 + K21);
      identical trees within the batch share ONE device slot (interior
      hashing paid once), the tree axis pads with zero trees and the query
      axis with root queries against tree 0 (both discarded). The result
      row is the deepest-first sibling branch as a tuple of 32-byte
      values; host fallback is the `ssz/proofs.build_chunk_proof` oracle,
      bit-identical by construction.

    A pure tree_root batch keeps the (n, 32) uint8 result array; any batch
    containing a multiproof returns object dtype — branch tuples alongside
    (32,) uint8 root rows.

    `device` is where the kernels run ("cuda" by default; "cpu" runs their
    plain versions); it is resolved at construction, so asking for "cuda"
    without a card raises there. With a tracer installed the multiproof
    path opens the spans `merkle.pack`, `merkle.device` (which gets
    `device_event_ms` on the card) and `merkle.unpack`."""

    name = "merkle"
    kinds = ("tree_root", "multiproof")

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def execute(self, requests: list) -> np.ndarray:
        if all(r.kind == "tree_root" for r in requests):
            return self._tree_roots_device(requests)
        out = np.empty(len(requests), dtype=object)
        root_idxs = [i for i, r in enumerate(requests) if r.kind == "tree_root"]
        if root_idxs:
            rows = self._tree_roots_device([requests[i] for i in root_idxs])
            for row, i in zip(rows, root_idxs):
                out[i] = row
        self._multiproofs_device(
            requests, [i for i, r in enumerate(requests) if r.kind == "multiproof"], out)
        return out

    def _tree_roots_device(self, requests: list) -> np.ndarray:
        import torch

        from ..engine import state_root as SR

        out = [None] * len(requests)
        by_shape: dict = {}
        for i, r in enumerate(requests):
            c_full = bucketing.pow2_bucket(max(1, len(r.payload[0])), 1)
            by_shape.setdefault(c_full, []).append(i)
        for c_full, idxs in sorted(by_shape.items()):
            b_k = bucketing.pow2_bucket(len(idxs), 1)
            words = np.zeros((b_k, c_full, 8), dtype=np.uint32)
            for row, i in enumerate(idxs):
                leaves = requests[i].payload[0]
                words[row, :len(leaves)] = _leaf_words(leaves)
            roots = SR.tree_root_batch(torch.from_numpy(words.view(np.int32)).to(self.device))
            raw = roots.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
            for row, i in enumerate(idxs):
                out[i] = np.frombuffer(raw[32 * row:32 * row + 32], dtype=np.uint8)
        return np.asarray(out, dtype=np.uint8)

    def _multiproofs_device(self, requests: list, idxs: list, out: np.ndarray) -> None:
        """Fill out[i] (a branch tuple) for every multiproof index."""
        from ..engine import state_root as SR

        by_shape: dict = {}
        for i in idxs:
            chunks, gindex = requests[i].payload
            c_full = bucketing.pow2_bucket(max(1, len(chunks)), 1)
            depth = (c_full - 1).bit_length() if c_full > 1 else 0
            g = int(gindex)
            if g < 1 or g.bit_length() - 1 > depth:
                raise ValueError(
                    f"multiproof gindex {g} outside the depth-{depth} padded chunk tree")
            by_shape.setdefault(c_full, []).append((i, g))
        for c_full, members in sorted(by_shape.items()):
            with _obs_trace.span("merkle.pack", chunks=c_full):
                words, tree_ids, gidx, queries = self.pack(requests, members, c_full)
            with _obs_trace.span("merkle.device", trees=words.shape[0], chunks=c_full,
                                 queries=gidx.shape[0]):
                sib, _nodes, _roots = SR.multiproof_batch(words, tree_ids, gidx,
                                                          device=self.device)
            with _obs_trace.span("merkle.unpack", queries=len(queries)):
                depth_rows = sib.shape[1]
                raw = sib.astype(">u4").tobytes()
                for row, (i, slot, g) in enumerate(queries):
                    base = 32 * depth_rows * row
                    out[i] = tuple(raw[base + 32 * lvl:base + 32 * lvl + 32]
                                   for lvl in range(g.bit_length() - 1))

    def execute_degraded(self, requests: list) -> np.ndarray:
        from ..ssz.merkle import merkleize_chunks

        if all(r.kind == "tree_root" for r in requests):
            return np.asarray(
                [np.frombuffer(merkleize_chunks([bytes(c) for c in r.payload[0]]),
                               dtype=np.uint8)
                 for r in requests], dtype=np.uint8)
        from ..ssz.proofs import build_chunk_proof

        out = np.empty(len(requests), dtype=object)
        for i, r in enumerate(requests):
            if r.kind == "tree_root":
                out[i] = np.frombuffer(merkleize_chunks([bytes(c) for c in r.payload[0]]),
                                       dtype=np.uint8)
            else:
                chunks, gindex = r.payload
                out[i] = tuple(build_chunk_proof([bytes(c) for c in chunks], int(gindex)))
        return out

    def to_result(self, row):
        if isinstance(row, tuple):
            return row  # multiproof branch: deepest-first 32-byte siblings
        return np.asarray(row, dtype=np.uint8).tobytes()

    def load(self, requests: list) -> tuple:
        # units are whole trees (tree_root) / queries (multiproof); each
        # (kind, leaf-count) bucket pads independently
        by_shape: dict = {}
        for r in requests:
            c_full = bucketing.pow2_bucket(max(1, len(r.payload[0])), 1)
            key = (r.kind, c_full)
            by_shape[key] = by_shape.get(key, 0) + 1
        live = len(requests)
        padded = sum(bucketing.pow2_bucket(k, 1) for k in by_shape.values())
        return live, padded


def default_classes() -> list:
    """The classes the port has: the Merkle lane on the card."""
    return [MerkleWorkClass()]
