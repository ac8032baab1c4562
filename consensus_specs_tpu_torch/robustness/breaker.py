"""Circuit breaker for the device paths (the port's copy of the JAX
package's robustness/breaker.py).

`bridge.apply_epoch_via_engine` must complete every epoch even when the
accelerator is gone (tunnel drop, preemption): a failed device attempt
degrades that epoch to the pure-Python spec path (`spec.process_epoch`),
which the differential tests prove bit-identical. The breaker bounds what
the degraded steady state COSTS:

  closed      device path with the full retry budget.
  open        reached after `failure_threshold` consecutive epoch-level
              device failures; the very next epoch transitions to...
  half_open   ...a single-attempt probe of the device path. Success
              re-arms (closed, counter reset); failure re-opens, so a dead
              device costs one cheap probe per epoch instead of a full
              retry budget, while recovery is detected within one epoch.

Every transition and degraded epoch is recorded in `events` — liveness
under partial failure is only worth having if it is observable. The log is
a BOUNDED ring (a week-long soak on a dead device would otherwise grow it
one dict per epoch, forever); overflow is not silent — dropped entries are
counted on the ring and as `breaker_events_dropped_total` in the metrics
registry, and every event also ticks `breaker_events_total{event=...}`
there, so the full history survives in counter form after the ring wraps.

No torch at module level.
"""
from __future__ import annotations

import threading

from ..obs import flight as _flight
from ..obs import metrics as _obs_metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Default event-ring capacity: plenty for any test or incident window
# (an epoch produces at most ~2 events even fully degraded).
EVENT_RING_SIZE = 256


class BoundedEventLog(list):
    """A list that drops its OLDEST entries past `maxlen`, counting them.

    A plain `list` subclass on purpose: existing consumers compare the log
    to list literals (`brk.events == []`) and slice it — a deque would
    break them. Only `append` is bounded; the breaker never inserts any
    other way."""

    def __init__(self, maxlen: int = EVENT_RING_SIZE):
        super().__init__()
        self.maxlen = int(maxlen)
        self.dropped = 0

    def append(self, item) -> None:
        super().append(item)
        overflow = len(self) - self.maxlen
        if overflow > 0:
            del self[:overflow]
            self.dropped += overflow

    def clear(self) -> None:
        super().clear()
        self.dropped = 0


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3, name: str = "device-epoch",
                 event_ring_size: int = EVENT_RING_SIZE):
        self.failure_threshold = int(failure_threshold)
        self.name = name
        # The breaker is driven from the sched flush path (possibly a
        # flusher thread) and inspected from the main thread; one lock over
        # every transition keeps the counter/event/state triple coherent.
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self.degraded_epochs = 0
        self.events: BoundedEventLog = BoundedEventLog(event_ring_size)

    def on_attempt(self) -> str:
        """Call once per epoch before trying the device path. Returns the
        attempt mode: "closed" (full retry budget) or "probe" (single
        attempt; the breaker is half-open)."""
        with self._lock:
            if self.state == OPEN:
                self.state = HALF_OPEN
                self._log("half_open_probe")
            return "probe" if self.state == HALF_OPEN else "closed"

    def record_success(self) -> None:
        with self._lock:
            if self.state != CLOSED:
                self._log("rearmed")
            self.state = CLOSED
            self.consecutive_failures = 0

    def record_failure(self, degraded: bool = True) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if degraded:
                self.degraded_epochs += 1
                self._log("degraded_to_python")
            if self.state == HALF_OPEN or \
                    self.consecutive_failures >= self.failure_threshold:
                if self.state != OPEN:
                    self._log("opened")
                self.state = OPEN

    def reset(self) -> None:
        with self._lock:
            self.state = CLOSED
            self.consecutive_failures = 0
            self.degraded_epochs = 0
            self.events.clear()

    def _log(self, event: str) -> None:
        before = self.events.dropped
        self.events.append({
            "event": event,
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
        })
        reg = _obs_metrics.REGISTRY
        reg.counter("breaker_events_total",
                    breaker=self.name, event=event).inc()
        if self.events.dropped > before:
            reg.counter("breaker_events_dropped_total",
                        breaker=self.name).inc(self.events.dropped - before)
        # black box: every transition is a flight-recorder event, and an
        # OPEN is an incident — dump the ring exactly once per transition
        # (the state != OPEN guard in record_failure already guarantees
        # one "opened" per open, so this stays one dump per incident)
        _flight.record("breaker", breaker=self.name, event=event,
                       consecutive_failures=self.consecutive_failures)
        if event == "opened":
            _flight.dump("breaker_open", meta={"breaker": self.name})

    def __repr__(self) -> str:  # observability in test failures
        return (f"CircuitBreaker({self.name!r}, state={self.state}, "
                f"failures={self.consecutive_failures}, "
                f"degraded={self.degraded_epochs})")
