"""Span tracer for the resident pipeline's hot-path seams (the port's copy
of the JAX package's obs/trace.py).

`span("engine.dispatch", epoch=3)` is a context manager that times the
enclosed work on the monotonic clock, tracks nesting (a dispatch inside an
epoch inside a run), carries structured attributes, and feeds the metrics
registry (`<name>_seconds` histogram + `span_total{span=...}` counter) so
p50/p99 per seam fall out of the same snapshot as every counter.

Disabled-by-default, mirroring robustness.faults.FaultPlan: a module global
`_TRACER` starts as None and `span(...)` then returns one shared immutable
`_NullSpan` — the disabled cost is a module-global read, a tuple lookup and
a no-op __enter__/__exit__ pair. Production code therefore instruments
unconditionally; only installing a `Tracer` (chaos tests, chip_smoke.py) turns the lights on.

Thread model: the active-span stack is thread-local (each thread gets its
own nesting chain); the finished-span ring and the registry are
shared and locked. The ring is FIXED SIZE with a drop counter — same
bounded-memory rule as the breaker event log and the metrics histograms.

Causality: a span may carry a trace context (any object with
`trace_id`, `span_id` and `parent_span_id`, as the JAX package's
obs/context.TraceContext) and *links* to other contexts,
expressing fan-in (N collapsed requests → one dispatch span) and fan-out
(one failed collapse → N reverify attributions). Finished spans also
record their thread name/id and monotonic start time. All of it rides the same
disabled-mode contract: no tracer ⇒ `span(...)` still returns the shared
no-op singleton and nothing mints, links, or records.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from . import flight as _flight
from .metrics import REGISTRY, MetricsRegistry


class _NullSpan:
    """The disabled-mode span: every operation is a no-op. One shared
    instance — `span()` must not allocate when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self

    def link(self, ctx):
        return self

    @property
    def attrs(self):
        return {}


NULL_SPAN = _NullSpan()


class Span:
    """One live (or finished) span. Created only by an installed Tracer."""

    __slots__ = ("name", "attrs", "depth", "parent", "t_start", "duration",
                 "status", "ctx", "links", "thread", "thread_id", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 depth: int, parent: Optional[str],
                 ctx=None, links=None):
        self.name = name
        self.attrs = attrs
        self.depth = depth
        self.parent = parent
        self.t_start = 0.0
        self.duration = 0.0
        self.status = "ok"
        self.ctx = ctx
        self.links = list(links) if links else []
        self.thread = ""
        self.thread_id = 0
        self._tracer = tracer

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def link(self, ctx) -> "Span":
        """Add a span link to another request's context — fan-in/fan-out
        causality the parent/child nesting cannot express."""
        if ctx is not None:
            self.links.append(ctx)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        th = threading.current_thread()
        self.thread = th.name
        self.thread_id = th.ident or 0
        self.t_start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = time.monotonic() - self.t_start
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("exc", exc_type.__name__)
        self._tracer._pop(self)
        return False

    def to_dict(self) -> dict:
        ctx = self.ctx
        return {
            "name": self.name,
            "depth": self.depth,
            "parent": self.parent,
            "t_start": self.t_start,
            "duration": self.duration,
            "status": self.status,
            "thread": self.thread,
            "thread_id": self.thread_id,
            "trace_id": ctx.trace_id if ctx is not None else None,
            "span_id": ctx.span_id if ctx is not None else None,
            "parent_span_id": (ctx.parent_span_id
                               if ctx is not None else None),
            "links": [{"trace_id": c.trace_id, "span_id": c.span_id}
                      for c in self.links],
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Collects finished spans into a bounded ring and mirrors timings into
    the metrics registry.

    max_spans bounds the ring; older spans are dropped oldest-first and
    counted in `spans_dropped_total` (visible in the snapshot, so a soak
    that overflows the ring says so instead of silently forgetting)."""

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 max_spans: int = 4096):
        self.registry = registry
        self.max_spans = int(max_spans)
        self.finished: list[dict] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- stack ----------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        self._record(sp)

    # -- recording ------------------------------------------------------------

    def _record(self, sp: Span) -> None:
        with self._lock:
            self.finished.append(sp.to_dict())
            if len(self.finished) > self.max_spans:
                drop = len(self.finished) - self.max_spans
                del self.finished[:drop]
                self.dropped += drop
                self.registry.counter("spans_dropped_total").inc(drop)
        self.registry.counter("span_total", span=sp.name).inc()
        if sp.status == "error":
            self.registry.counter("span_errors_total", span=sp.name).inc()
        self.registry.histogram("span_seconds", span=sp.name).observe(
            sp.duration,
            exemplar=(sp.ctx.trace_id if sp.ctx is not None else None))
        # black box: span completions are flight-recorder events, so a dump
        # shows what the pipeline was DOING just before the trigger
        _flight.record("span", name=sp.name, status=sp.status,
                       duration=round(sp.duration, 6),
                       trace_id=(sp.ctx.trace_id
                                 if sp.ctx is not None else None))

    def span(self, name: str, ctx=None, links=None, **attrs) -> Span:
        cur = self.current()
        return Span(self, name, attrs,
                    depth=(cur.depth + 1 if cur is not None else 0),
                    parent=(cur.name if cur is not None else None),
                    ctx=ctx, links=links)

    def spans(self, name: Optional[str] = None) -> list[dict]:
        """Finished spans (optionally filtered by name), oldest first."""
        with self._lock:
            out = list(self.finished)
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def install(self) -> "Tracer":
        global _TRACER
        _TRACER = self
        return self

    def uninstall(self) -> None:
        global _TRACER
        if _TRACER is self:
            _TRACER = None


_TRACER: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    return _TRACER


def uninstall() -> None:
    """Remove whatever tracer is installed (test-teardown safety net)."""
    global _TRACER
    _TRACER = None


def span(name: str, ctx=None, links=None, **attrs):
    """THE hot-path entry point. Disabled: one global read + shared no-op
    object (ctx/links ignored — callers gate minting on `current_tracer()`
    so nothing is even built). Enabled: a real nested span carrying the
    request context and any fan-in/fan-out links."""
    tracer = _TRACER
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, ctx=ctx, links=links, **attrs)


def annotate(**attrs) -> None:
    """Attach attributes to the innermost active span of the calling thread
    (no-op when tracing is disabled or no span is open). This is how deep
    seams — fault injection, retry classification — mark the enclosing
    dispatch span without threading a span object through every call."""
    tracer = _TRACER
    if tracer is None:
        return
    cur = tracer.current()
    if cur is None:
        return
    for k, v in attrs.items():
        if k in ("fault_sites", "retried_errors"):
            cur.attrs.setdefault(k, [])
            cur.attrs[k].append(v)
        else:
            cur.attrs[k] = v
