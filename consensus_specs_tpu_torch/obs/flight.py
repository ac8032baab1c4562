"""Flight recorder: an always-on black box for the resident pipeline (the
port's copy of the JAX package's obs/flight.py).

A bounded ring of recent structured events — span completions, fault
fires, breaker transitions, queue-depth/occupancy samples, self-check
failures — that costs one locked list append per event and nothing else.
Unlike the tracer (opt-in, per-run) the recorder is ALWAYS armed: the
events that feed it come from seams that are rare (breaker transitions,
faults) or already behind an installed tracer (span completions), so the
disabled-observability hot path never touches it.

On a trigger — breaker open, `SchedSelfCheckError` — `dump(trigger)`
freezes the ring into a canonical-JSON artifact (obs/export.py
serialization rules): the last N events before the incident, post-mortem
without re-running. Dumps are kept in-process (`dumps`, bounded) for
tests, counted in `flight_dumps_total{trigger=...}`, and — when the
`OBS_FLIGHT_DIR` environment variable names a directory, and only then —
written there as `flight_<trigger>_<seq>.json`.

Same bounded-memory rule as the breaker event log and the span ring:
overflow drops oldest-first and is counted, never silent.

No torch at module level.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from . import export as _export
from .metrics import REGISTRY, MetricsRegistry

# Default ring capacity: at one event per span/fault/flush, a few thousand
# events is minutes of steady-state history — plenty of pre-incident
# context without unbounded growth.
DEFAULT_CAPACITY = 2048

# In-process dump retention: incidents are rare; keep the last few so a
# multi-fault chaos schedule can still inspect each one.
KEEP_DUMPS = 8

DUMP_VERSION = 1


def _jsonable(v):
    """Clamp event field values to the canonical-JSON type set; anything
    exotic degrades to repr() instead of poisoning a later dump."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


class FlightRecorder:
    """Bounded structured-event ring + triggered canonical-JSON dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 registry: MetricsRegistry = REGISTRY,
                 keep_dumps: int = KEEP_DUMPS):
        self.capacity = int(capacity)
        self.registry = registry
        self.keep_dumps = int(keep_dumps)
        self.dropped = 0
        self.dumps: list[dict] = []
        self._ring: list[dict] = []
        self._seq = 0
        self._dump_seq = 0
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        ev = {"kind": kind, "t": round(time.monotonic(), 6),
              "thread": threading.current_thread().name}
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            overflow = len(self._ring) - self.capacity
            if overflow > 0:
                del self._ring[:overflow]
                self.dropped += overflow

    def events(self, kind: Optional[str] = None) -> list[dict]:
        """Ring contents (optionally filtered by kind), oldest first."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    # -- triggered dump ----------------------------------------------------

    def dump(self, trigger: str, meta: Optional[dict] = None) -> dict:
        """Freeze the ring into a black-box artifact. Returns the artifact
        dict; also retains it in `dumps`, ticks the trigger counter, and
        writes `OBS_FLIGHT_DIR/flight_<trigger>_<seq>.json` when that env
        var names a directory."""
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
            artifact = {
                "version": DUMP_VERSION,
                "trigger": trigger,
                "dump_seq": seq,
                "events": [dict(e) for e in self._ring],
                "events_dropped": self.dropped,
                "meta": _jsonable(meta or {}),
            }
            self.dumps.append(artifact)
            if len(self.dumps) > self.keep_dumps:
                del self.dumps[:len(self.dumps) - self.keep_dumps]
        self.registry.counter("flight_dumps_total", trigger=trigger).inc()
        out_dir = os.environ.get("OBS_FLIGHT_DIR")
        if out_dir:
            try:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir, f"flight_{trigger}_{seq:04d}.json")
                with open(path, "w") as f:
                    f.write(_export.canonical_json(artifact))
            except OSError:
                # the black box must never turn an incident into a second
                # incident; the in-process copy and the counter survive
                pass
        return artifact

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dumps.clear()
            self.dropped = 0

    # -- install (tests swap in an isolated instance) ----------------------

    def install(self) -> "FlightRecorder":
        global _RECORDER
        _RECORDER = self
        return self

    def uninstall(self) -> None:
        global _RECORDER
        if _RECORDER is self:
            _RECORDER = _DEFAULT


# The always-on process recorder. Tests that need isolation install their
# own instance and uninstall back to this default.
_DEFAULT = FlightRecorder()
_RECORDER = _DEFAULT


def current_recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, **fields) -> None:
    _RECORDER.record(kind, **fields)


def dump(trigger: str, meta: Optional[dict] = None) -> dict:
    return _RECORDER.dump(trigger, meta)
