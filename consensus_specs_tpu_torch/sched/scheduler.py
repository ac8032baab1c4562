"""Unified verification scheduler: one shape-bucketed device queue (the
port's copy of the JAX package's sched/scheduler.py).

It multiplexes the work classes (sched/classes.py) behind one dispatch
seam:

  * admission: `submit(Request) -> Handle` appends to a bounded per-class
    queue. Depth at/over the class bound flushes immediately (backpressure
    stays bounded without a background thread); an optional deadline
    flushes any class whose oldest entry has waited too long, checked at
    every admission. Classes may opt into same-key collapse at admission
    (the JAX package's BLS class merges same-message FastAggregateVerify
    checks; the port's Merkle class never collapses).
    Installing a `SealPolicy` replaces both built-in triggers: the policy
    alone decides which classes seal after each admission (`EdfSealPolicy`
    is earliest-deadline-first over `Request.deadline`), and `class_priority` orders multi-class
    flush/drain passes so the proposal lane dispatches before reads.
  * dispatch: one batch per class per flush, executed behind the
    `sched.dispatch` fault seam with the retry policy; results are
    validated (row count + dtype) so corrupt-kind chaos faults retry
    instead of resolving handles with garbage. Retries always re-enter
    from intact host payloads — requests carry host bytes, never donated
    device buffers, so the pre-donation retry invariant holds by
    construction.
  * degrade: a dispatch that exhausts retries on a device failure trips
    the per-class circuit breaker and falls back to the class's
    pure-Python path. One poisoned lane degrades alone; the other classes
    keep their device queues. A kernel that does not build, load or launch
    (`kernels/build.KernelError`, `retryable = False`) is not a device
    failure: the flush fails its handles and raises.
  * observability: per-class queue depth, batch occupancy, pad-waste
    ratio, and submit->result latency histograms (p50/p99 via the
    registry), plus dispatch/degrade/collapse counters.

Device work happens inside the work classes' execute bodies.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..obs import flight as _flight
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..robustness import breaker as _breaker
from ..robustness import faults as _faults
from ..robustness import retry as _retry
from .api import Handle, Request
from .classes import default_classes

# The JAX package's crypto/bls.py FLUSH_RETRY_POLICY: the seam absorbs the
# same transient budget as the deferral flush there.
DISPATCH_RETRY_POLICY = _retry.RetryPolicy(
    max_attempts=3, base_delay=0.02, max_delay=0.2)

# Admission bound: far above any single epoch's check count, so the depth
# trigger is backpressure against unbounded producers, not a batch splitter
# for normal workloads (splitting a flush changes grouped-RLC routing).
DEFAULT_MAX_DEPTH = 8192


class SchedResultIntegrityError(_faults.IntegrityError):
    """Executor returned a result batch that fails shape/dtype validation
    (the corrupt-fault detection point). Retryable: request payloads are
    host-side and intact, so re-execution is safe."""


class SchedSelfCheckError(_faults.IntegrityError):
    """A work class's post-dispatch `verify_results` hook rejected a
    structurally VALID result batch — the seam where a semantic self-check
    (the JAX package's msm class's 2G2T equation) catches
    well-formed-but-wrong values that shape/dtype validation cannot.
    Retryable for the same reason as SchedResultIntegrityError."""


class _Entry:
    """One queue slot: the requests collapsed into it and their handles."""

    __slots__ = ("members", "handles", "collapsed", "t_submit", "deadline")

    def __init__(self, request: Request, handle: Handle, now: float):
        self.members = [request]
        self.handles = [handle]
        self.collapsed = request  # the request dispatch actually executes
        self.t_submit = now
        self.deadline = request.deadline

    def note_deadline(self, request: Request) -> None:
        """Fold a merged member's deadline in: the entry owes its verdict
        by the EARLIEST member deadline (a collapse must not let a tight
        request inherit a lax neighbour's slack)."""
        d = request.deadline
        if d is not None and (self.deadline is None or d < self.deadline):
            self.deadline = d


class SealPolicy:
    """Seam deciding WHICH queued classes to seal after an admission.

    Installed on a Scheduler via `seal_policy=`, `select(scheduler, now)`
    runs after every submit/submit_many admission (outside the queue lock)
    and returns the class names to flush, in flush order. It REPLACES the
    built-in depth/deadline triggers — a policy that wants depth
    backpressure must implement it (EdfSealPolicy does)."""

    def select(self, scheduler: "Scheduler", now: float) -> list:
        raise NotImplementedError


class EdfSealPolicy(SealPolicy):
    """Earliest-deadline-first sealing: seal the batch whose earliest
    deadline is closest to expiry.

    A class becomes due when its earliest queued deadline is within
    `slack_s` of `now` (the slack covers dispatch time so the verdict — not
    just the flush — lands inside the deadline), when its depth reaches the
    depth limit (backpressure, same bound the built-in trigger used), or —
    for deadline-free entries — when its oldest entry has waited
    `max_wait_s`. Due classes flush earliest-deadline-first; deadline-free
    overflow follows, oldest-first."""

    def __init__(self, slack_s: float = 0.0, *,
                 max_wait_s: float | None = None,
                 depth_limit: int | None = None):
        self.slack_s = slack_s
        self.max_wait_s = max_wait_s
        self.depth_limit = depth_limit

    def select(self, scheduler: "Scheduler", now: float) -> list:
        due = []
        for name, wc in scheduler.classes.items():
            depth, oldest, earliest = scheduler.queue_meta(name)
            if not depth:
                continue
            limit = self.depth_limit
            if limit is None:
                limit = (wc.max_depth if wc.max_depth is not None
                         else scheduler.max_depth)
            if earliest is not None and earliest - now <= self.slack_s:
                due.append((earliest, name))
            elif depth >= limit:
                due.append((now, name))
            elif (self.max_wait_s is not None and oldest is not None
                  and now - oldest >= self.max_wait_s):
                due.append((oldest + self.max_wait_s, name))
        due.sort()
        return [name for _, name in due]


class Scheduler:
    """Shape-bucketed multiplexer for heterogeneous verification work."""

    def __init__(self, classes=None, *, retry_policy=None,
                 failure_threshold: int = 3,
                 max_depth: int = DEFAULT_MAX_DEPTH,
                 flush_deadline_s: float | None = None,
                 seal_policy: SealPolicy | None = None,
                 class_priority: dict | None = None,
                 clock=time.monotonic,
                 registry=None):
        self.classes = {wc.name: wc for wc in
                        (default_classes() if classes is None else classes)}
        self.retry_policy = retry_policy or DISPATCH_RETRY_POLICY
        self.max_depth = max_depth
        self.flush_deadline_s = flush_deadline_s
        # seal_policy: when set, it owns the "when do we flush" decision
        # entirely (depth/deadline triggers are bypassed). class_priority
        # maps name -> rank (lower flushes first) and orders multi-class
        # flush()/drain() passes; unranked classes keep admission order
        # after every ranked one. clock is injectable so deadline math is
        # deterministic under a virtual clock.
        self.seal_policy = seal_policy
        self.class_priority = class_priority
        self.clock = clock
        self.registry = registry if registry is not None else _obs_metrics.REGISTRY
        self._breakers = {
            name: _breaker.CircuitBreaker(
                failure_threshold=failure_threshold, name=f"sched-{name}")
            for name in self.classes}
        self._queues: dict = {name: [] for name in self.classes}
        self._collapse_index: dict = {name: {} for name in self.classes}
        self._lock = threading.RLock()

    # -- admission ---------------------------------------------------------

    def breaker(self, work_class: str) -> _breaker.CircuitBreaker:
        return self._breakers[work_class]

    def queue_depth(self, work_class: str) -> int:
        with self._lock:
            return len(self._queues[work_class])

    def queue_meta(self, work_class: str) -> tuple:
        """(depth, oldest_t_submit, earliest_deadline) for one class queue
        — the seal policy's decision inputs. Empty queue: (0, None, None);
        a queue whose entries carry no deadline reports earliest None."""
        with self._lock:
            queue = self._queues[work_class]
            if not queue:
                return 0, None, None
            deadlines = [e.deadline for e in queue if e.deadline is not None]
            return (len(queue), queue[0].t_submit,
                    min(deadlines) if deadlines else None)

    def _ordered(self, names) -> list:
        """Flush order for a multi-class pass: class_priority rank when
        installed (stable within a rank), registration order otherwise."""
        names = list(names)
        if self.class_priority is None:
            return names
        rank = self.class_priority
        return sorted(names, key=lambda n: rank.get(n, len(rank)))

    def queue_load(self, work_class: str) -> tuple:
        """(entries, members) currently queued: distinct device checks vs
        the requests collapsed into them. members/entries is the live
        collapse ratio a streaming consumer reports before it seals a batch."""
        with self._lock:
            queue = self._queues[work_class]
            return len(queue), sum(len(e.members) for e in queue)

    def submit(self, request: Request) -> Handle:
        wc = self.classes.get(request.work_class)
        if wc is None:
            raise ValueError(f"unknown work class {request.work_class!r} "
                             f"(registered: {sorted(self.classes)})")
        if request.kind not in wc.kinds:
            raise ValueError(f"unknown kind {request.kind!r} for work class "
                             f"{wc.name!r} (kinds: {wc.kinds})")
        now = self.clock()
        handle = Handle(request, self, _submitted_at=now)
        reg = self.registry
        with self._lock:
            depth = self._admit(wc, request, handle, now)
        reg.counter("sched_submitted_total",
                    work_class=wc.name, kind=request.kind).inc()
        reg.gauge("sched_queue_depth", work_class=wc.name).set(depth)
        if self.seal_policy is not None:
            self._run_seal_policy(now)
            return handle
        limit = wc.max_depth if wc.max_depth is not None else self.max_depth
        if depth >= limit:
            self._flush_class(wc.name, trigger="depth")
        elif self.flush_deadline_s is not None:
            self._flush_overdue(now)
        return handle

    def submit_many(self, requests: list) -> list:
        """Admit a batch of requests under ONE lock acquisition.

        Semantics match a submit() loop (same collapse behaviour, counters,
        and depth/deadline triggers evaluated after admission), with one
        batch-level improvement: same-collapse-key groups fold through the
        class's `merge_group` hook when it defines one, so a committee's
        worth of same-message signatures aggregates in a single pass
        instead of a chain of pairwise merges. The depth trigger fires at
        most once per class AFTER the whole batch is admitted — a batched
        producer wants one sealed flush, not a flush per boundary crossing.
        """
        if not requests:
            return []
        now = self.clock()
        handles: list[Handle] = []
        per_class: dict = {}
        for request in requests:
            wc = self.classes.get(request.work_class)
            if wc is None:
                raise ValueError(f"unknown work class {request.work_class!r} "
                                 f"(registered: {sorted(self.classes)})")
            if request.kind not in wc.kinds:
                raise ValueError(f"unknown kind {request.kind!r} for work "
                                 f"class {wc.name!r} (kinds: {wc.kinds})")
            handle = Handle(request, self, _submitted_at=now)
            handles.append(handle)
            per_class.setdefault(wc.name, []).append((request, handle))
        reg = self.registry
        depths: dict = {}
        with self._lock:
            for name, pairs in per_class.items():
                depths[name] = self._admit_batch(
                    self.classes[name], pairs, now)
        for name, pairs in per_class.items():
            for request, _ in pairs:
                reg.counter("sched_submitted_total",
                            work_class=name, kind=request.kind).inc()
            reg.gauge("sched_queue_depth", work_class=name).set(depths[name])
            if self.seal_policy is not None:
                continue
            wc = self.classes[name]
            limit = wc.max_depth if wc.max_depth is not None else self.max_depth
            if depths[name] >= limit:
                self._flush_class(name, trigger="depth")
        if self.seal_policy is not None:
            self._run_seal_policy(self.clock())
        elif self.flush_deadline_s is not None:
            self._flush_overdue(self.clock())
        return handles

    def _run_seal_policy(self, now: float) -> None:
        for name in self.seal_policy.select(self, now):
            self._flush_class(name, trigger="seal")

    def _admit_batch(self, wc, pairs: list, now: float) -> int:
        """Admit (request, handle) pairs for one class under the held lock."""
        groups: dict = {}
        for request, handle in pairs:
            key = wc.collapse_key(request)
            if key is None:
                self._admit(wc, request, handle, now)
            else:
                groups.setdefault(key, []).append((request, handle))
        for key, members in groups.items():
            self._admit_group(wc, key, members, now)
        return len(self._queues[wc.name])

    def _admit_group(self, wc, key, members: list, now: float) -> None:
        """Collapse one same-key group in a single merge_group pass; any
        class without the hook — or a group whose aggregation rejects a
        payload — falls back to the pairwise _admit path, which isolates
        the unmergeable request instead of poisoning the group."""
        merge_group = getattr(wc, "merge_group", None)
        entry = self._collapse_index[wc.name].get(key)
        if merge_group is not None and (entry is not None or len(members) > 1):
            base = entry.collapsed if entry is not None else members[0][0]
            rest = members if entry is not None else members[1:]
            try:
                merged = merge_group(base, [r for r, _ in rest])
            except Exception:
                merged = None  # unmergeable payload somewhere: isolate below
            if merged is not None:
                if entry is None:
                    request, handle = members[0]
                    entry = _Entry(request, handle, now)
                    self._collapse_index[wc.name][key] = entry
                    self._queues[wc.name].append(entry)
                for request, handle in rest:
                    entry.members.append(request)
                    entry.handles.append(handle)
                    entry.note_deadline(request)
                    self.registry.counter(
                        "sched_collapsed_total", work_class=wc.name).inc()
                entry.collapsed = merged
                return
        for request, handle in members:
            self._admit(wc, request, handle, now)

    def _admit(self, wc, request: Request, handle: Handle, now: float) -> int:
        """Append (or collapse) under the lock; returns the queue depth."""
        queue = self._queues[wc.name]
        key = wc.collapse_key(request)
        if key is not None:
            index = self._collapse_index[wc.name]
            entry = index.get(key)
            if entry is not None:
                try:
                    merged = wc.merge(entry.collapsed, request)
                except Exception:
                    merged = None  # unmergeable payload: queue individually
                if merged is not None:
                    entry.members.append(request)
                    entry.handles.append(handle)
                    entry.note_deadline(request)
                    entry.collapsed = merged
                    self.registry.counter(
                        "sched_collapsed_total", work_class=wc.name).inc()
                    return len(queue)
            entry = _Entry(request, handle, now)
            index[key] = entry
            queue.append(entry)
            return len(queue)
        queue.append(_Entry(request, handle, now))
        return len(queue)

    def _flush_overdue(self, now: float) -> None:
        overdue = []
        with self._lock:
            for name, queue in self._queues.items():
                if queue and now - queue[0].t_submit >= self.flush_deadline_s:
                    overdue.append(name)
        for name in overdue:
            self._flush_class(name, trigger="deadline")

    # -- flush / drain -----------------------------------------------------

    def flush(self, work_class: str | None = None, *,
              trigger: str = "explicit") -> None:
        """Dispatch everything queued (for one class, or all of them).
        `trigger` only labels the sched_flush_total series — streaming
        callers tag their flushes distinctly."""
        names = ([work_class] if work_class is not None
                 else self._ordered(self.classes))
        for name in names:
            self._flush_class(name, trigger=trigger)

    def drain(self) -> None:
        """Flush until every queue is empty (a flush can enqueue more work
        through degraded re-verification paths, hence the loop)."""
        while True:
            with self._lock:
                pending = [n for n, q in self._queues.items() if q]
            if not pending:
                return
            for name in self._ordered(pending):
                self._flush_class(name, trigger="drain")

    def _flush_class(self, name: str, trigger: str) -> None:
        with self._lock:
            entries = self._queues[name]
            if not entries:
                return
            self._queues[name] = []
            self._collapse_index[name] = {}
        reg = self.registry
        reg.counter("sched_flush_total", work_class=name,
                    trigger=trigger).inc()
        reg.gauge("sched_queue_depth", work_class=name).set(0)
        self._dispatch(self.classes[name], entries)

    # -- dispatch seam -----------------------------------------------------

    def _dispatch(self, wc, entries: list) -> None:
        reg = self.registry
        requests = [e.collapsed for e in entries]
        brk = self._breakers[wc.name]
        # fan-in span links: N member requests (across every admission
        # collapse in the batch) -> ONE dispatch span, so a device verdict
        # is attributable to exactly the traces that rode this batch
        links = None
        if _obs_trace.current_tracer() is not None:
            links = [m.trace for e in entries for m in e.members
                     if m.trace is not None] or None
        with _obs_trace.span("sched.dispatch", work_class=wc.name,
                             batch=len(requests), links=links):
            mode = brk.on_attempt()
            n = len(requests)

            def attempt():
                _faults.fire("sched.dispatch")
                res = np.asarray(wc.execute(requests))
                res = _faults.corrupt_array("sched.dispatch", res)
                res = self._validated(res, n, wc.name)
                # Optional per-class value check (a semantic self-check):
                # raises a retryable error so corrupt-but-well-formed rows
                # re-execute or degrade instead of resolving handles. The
                # degraded path below skips it — the host oracle is the
                # trust anchor the check compares against. A rejection is
                # an incident: the black box freezes its event ring.
                if wc.verify_results is not None:
                    try:
                        wc.verify_results(requests, res)
                    except Exception as exc:
                        _flight.record("self_check", work_class=wc.name,
                                       error=type(exc).__name__,
                                       detail=str(exc)[:200])
                        _flight.dump("sched_self_check",
                                     meta={"work_class": wc.name})
                        raise
                return res

            degraded = False
            try:
                policy = (self.retry_policy if mode == "closed"
                          else _retry.PROBE_POLICY)
                results = _retry.call_with_retry(attempt, policy)
                brk.record_success()
            except Exception as exc:
                if not _retry.is_device_failure(exc):
                    for e in entries:
                        for h in e.handles:
                            h._fail(exc)
                    raise
                brk.record_failure(degraded=True)
                reg.counter("sched_degraded_total", work_class=wc.name).inc()
                _obs_trace.annotate(degraded_class=wc.name)
                results = self._validated(
                    np.asarray(wc.execute_degraded(requests)), n, wc.name)
                degraded = True

            live, padded = wc.load(requests)
            occ = (live / padded) if padded else 1.0
            reg.counter("sched_dispatch_total", work_class=wc.name,
                        path="host" if degraded else "device").inc()
            reg.counter("sched_items_total", work_class=wc.name).inc(live)
            reg.histogram("sched_batch_occupancy",
                          buckets=_OCCUPANCY_BUCKETS,
                          work_class=wc.name).observe(occ)
            reg.gauge("sched_last_batch_occupancy",
                      work_class=wc.name).set(occ)
            reg.gauge("sched_last_pad_waste", work_class=wc.name).set(1 - occ)
            self._resolve(wc, entries, results, degraded)

    def _resolve(self, wc, entries: list, results, degraded: bool) -> None:
        lat = self.registry.histogram(
            "sched_submit_latency_seconds", work_class=wc.name)
        now = self.clock()

        def _ex(h):
            tr = h.request.trace
            return tr.trace_id if tr is not None else None

        for e, row in zip(entries, results):
            if len(e.members) > 1 and not wc.to_result(row):
                # a failing collapsed check proves nothing about members:
                # re-verify each for sound attribution (Wonderboom
                # fallback). Fan-out span links name the EXACT member set
                # the failure decomposes into — the reverse edge of the
                # dispatch span's fan-in.
                self.registry.counter("sched_collapse_reverify_total",
                                      work_class=wc.name).inc()
                runner = wc.execute_degraded if degraded else wc.execute
                mlinks = [m.trace for m in e.members if m.trace is not None]
                with _obs_trace.span("sched.reverify", work_class=wc.name,
                                     members=len(e.members),
                                     links=mlinks or None):
                    member_rows = self._validated(
                        np.asarray(runner(e.members)), len(e.members),
                        wc.name)
                for h, mrow in zip(e.handles, member_rows):
                    lat.observe(max(0.0, now - h._submitted_at),
                                exemplar=_ex(h))
                    h._resolve(wc.to_result(mrow))
                continue
            value = wc.to_result(row)
            for h in e.handles:
                lat.observe(max(0.0, now - h._submitted_at), exemplar=_ex(h))
                h._resolve(value)

    def _validated(self, res: np.ndarray, n: int, name: str) -> np.ndarray:
        arr = np.asarray(res)
        if arr.ndim == 0 or arr.shape[0] != n or arr.dtype.kind == "f":
            raise SchedResultIntegrityError(
                f"sched.dispatch[{name}]: executor returned "
                f"shape={arr.shape} dtype={arr.dtype} for {n} requests")
        return arr


# Occupancy is a ratio in [0, 1]; the default latency-shaped buckets would
# collapse every observation into the top decades.
_OCCUPANCY_BUCKETS = tuple(i / 16 for i in range(1, 17))


# -- process-default instance ---------------------------------------------
#
# Callers without a scheduler of their own (a ProofService built without
# one) route through one shared scheduler, so their submits share queues.
# Tests that inject faults or trip breakers build their own instances, or
# reset this one to avoid cross-test state.

_DEFAULT: Scheduler | None = None
_DEFAULT_LOCK = threading.Lock()


def default_scheduler() -> Scheduler:
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Scheduler()
    return _DEFAULT


def reset_default_scheduler() -> None:
    """Drop the process-default instance (fresh queues and breakers)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
