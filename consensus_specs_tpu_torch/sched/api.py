"""Typed request/result surface of the verification scheduler (the port's
copy of the JAX package's sched/api.py).

A `Request` names a work class (registered with the Scheduler) and a kind
within it; the payload is the class-specific argument tuple, opaque to the
scheduler. `submit` returns a `Handle` — a single-assignment future whose
`result()` lazily flushes the owning class, so callers that submit-then-read
synchronously (the proof service's flush) never deadlock on an idle queue.

Handles are resolved with host values (root bytes, branch tuples) after
the dispatch loop has read the device result back.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Hashable, Optional

_PENDING = object()


@dataclass
class Request:
    """One unit of verification work.

    work_class: registered class name ("bls", "kzg", "merkle", ...).
    kind: class-specific operation ("verify", "verify_samples", ...).
    payload: positional arguments for the class executor, already
        host-side (bytes / ints / tuples) — never device arrays.
    group_key: admission-collapse key; requests sharing a truthy key may
        be merged into one device check when the class opts in (the
        Wonderboom same-message FastAggregateVerify collapse).
    """

    work_class: str
    kind: str
    payload: tuple
    group_key: Optional[Hashable] = None
    # deadline: absolute time (in the owning scheduler's clock space —
    # time.monotonic unless the scheduler was built with an injected clock)
    # by which the submitter wants a verdict. The scheduler never rejects
    # on it; it only feeds the seal policy's EDF ordering (scheduler.py),
    # so a deadline-free request behaves exactly as before.
    deadline: Optional[float] = None
    # trace: the submitter's trace context (see obs/trace.py), when tracing
    # is on. The scheduler never reads it for scheduling decisions — it only
    # links the dispatch/reverify spans back to every member request, and
    # stamps latency-histogram exemplars, so a verdict stays attributable
    # through admission collapse. Handles reach it via `handle.request`.
    trace: Optional[Any] = None


@dataclass
class Handle:
    """Single-assignment future for one submitted Request."""

    request: Request
    _scheduler: Any = field(repr=False, default=None)
    _value: Any = field(repr=False, default=_PENDING)
    _error: Optional[BaseException] = field(repr=False, default=None)
    _submitted_at: float = 0.0

    def done(self) -> bool:
        return self._value is not _PENDING or self._error is not None

    def result(self):
        """The verification result, flushing the owning class if needed."""
        if not self.done() and self._scheduler is not None:
            self._scheduler.flush(self.request.work_class)
        if self._error is not None:
            raise self._error
        if self._value is _PENDING:
            raise RuntimeError(
                f"handle for {self.request.work_class}/{self.request.kind} "
                "still pending after flush")
        return self._value

    def _resolve(self, value) -> None:
        self._value = value

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
