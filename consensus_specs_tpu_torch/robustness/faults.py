"""Seeded, deterministic fault injection at the device-boundary seams (the
port's copy of the JAX package's robustness/faults.py).

A `FaultPlan` injects failures at named seams whose hooks live in the
production code paths, not in test mocks, so the chaos tests exercise the
same retry/validate/degrade machinery a live node runs. In the port the
seam is `sched.dispatch` (sched/scheduler.py), the one every Merkle batch
crosses.

Determinism: every site draws from its OWN `random.Random` stream keyed by
(plan seed, site name), so the fire schedule of one site is independent of
how often any other site is called. Two runs of the same workload under the
same plan fire identically.

`FaultSpec(exc="xla")` raises `TransientFault`: the JAX package's own
branch when jax is absent. The port never imports jax, so its chaos
schedules stay those of the JAX package's tests.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from random import Random
from typing import Optional

import numpy as np

from ..obs import flight as _flight
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace


# --- error taxonomy ----------------------------------------------------------


class FaultInjected(Exception):
    """Base class for injected failures (never raised by real code paths)."""


class TransientFault(FaultInjected):
    """An injected failure the retry layer is expected to absorb."""

    retryable = True


class FatalFault(FaultInjected):
    """An injected failure that must NOT be retried (models a hard crash —
    the kill-mid-write-back scenario)."""

    retryable = False


class IntegrityError(Exception):
    """Validation caught corrupted data crossing the device boundary.

    The device source is intact (corruption happens on the host copy), so
    re-reading is safe — hence retryable."""

    retryable = True


class CorruptAuxError(IntegrityError):
    """EpochAux host copy failed validation (dtype/shape/NaN)."""


class TornWriteBackError(IntegrityError):
    """A staged write-back column failed validation against the device
    array it was copied from."""


# --- plan --------------------------------------------------------------------


@dataclass(frozen=True)
class FaultSpec:
    """What one injection site does when it fires.

    kind        "raise" (fire() sites), "corrupt" (corrupt_array sites),
                "mangle" (mangle_bytes sites). A spec whose kind does not
                match the seam's call type never fires.
    rate        per-call fire probability, drawn from the site's own stream.
    at_calls    1-based call indices that always fire (exact schedules for
                tests like "kill on the 3rd staged column").
    max_fires   cap on total fires for the site (None = unlimited).
    exc         raise kind: "transient" | "fatal" | "xla" (a
                TransientFault, as in the JAX package without jax).
    corruption  "nan" | "truncate" for arrays; "truncate" | "garble" for
                byte payloads.
    """

    kind: str = "raise"
    rate: float = 0.0
    at_calls: tuple = ()
    max_fires: Optional[int] = None
    exc: str = "transient"
    corruption: str = "nan"


@dataclass(frozen=True)
class FaultEvent:
    site: str
    call_index: int
    action: str


class FaultPlan:
    """A seeded schedule of injected failures over named sites.

    Usage:
        plan = FaultPlan(seed=0xC0FFEE, sites={
            "engine.dispatch": FaultSpec(kind="raise", exc="xla", rate=0.3),
            "engine.aux_readout": FaultSpec(kind="corrupt", at_calls=(2,)),
        })
        with plan.active():
            ... run the workload ...
        plan.events  # what actually fired, in order

    Thread-safe: seams may be called from several threads.
    """

    def __init__(self, seed: int, sites: dict):
        self.seed = int(seed)
        self.sites = dict(sites)
        self.events: list[FaultEvent] = []
        self._lock = threading.Lock()
        self._calls: dict[str, int] = {}
        self._fires: dict[str, int] = {}
        self._rngs = {site: Random(f"{self.seed}:{site}") for site in self.sites}

    def calls(self, site: str) -> int:
        return self._calls.get(site, 0)

    def fires(self, site: str) -> int:
        return self._fires.get(site, 0)

    def fired_sites(self) -> set:
        return {e.site for e in self.events}

    def _decide(self, site: str, kind: str):
        """Count the call; return (spec, call_index) when the site fires."""
        spec = self.sites.get(site)
        if spec is None or spec.kind != kind:
            return None, 0
        with self._lock:
            ix = self._calls.get(site, 0) + 1
            self._calls[site] = ix
            hit = ix in spec.at_calls
            if not hit and spec.rate > 0.0:
                # always draw so max_fires never shifts later indices
                draw = self._rngs[site].random() < spec.rate
                hit = draw
            if hit and spec.max_fires is not None \
                    and self._fires.get(site, 0) >= spec.max_fires:
                hit = False
            if hit:
                self._fires[site] = self._fires.get(site, 0) + 1
            return (spec if hit else None), ix

    def _log(self, site: str, ix: int, action: str) -> None:
        with self._lock:
            self.events.append(FaultEvent(site, ix, action))
        # Observability mirror: every fire is a counter tick (reconciled
        # 1:1 against plan.fires(site) by the chaos lane) and an attribute
        # on the innermost active span, so a trace shows WHERE each
        # injected failure landed, not just that one did.
        _obs_metrics.REGISTRY.counter("fault_fires_total", site=site).inc()
        _obs_trace.annotate(fault_sites=site)
        # ...and a flight-recorder event, so a black-box dump shows every
        # injected failure that preceded the trigger — reconciled 1:1
        # against plan.fires(site) by the chaos lane, same as the counter
        _flight.record("fault", site=site, call=ix, action=action)

    def install(self) -> "FaultPlan":
        global _PLAN
        _PLAN = self
        return self

    def uninstall(self) -> None:
        global _PLAN
        if _PLAN is self:
            _PLAN = None

    @contextmanager
    def active(self):
        self.install()
        try:
            yield self
        finally:
            self.uninstall()


_PLAN: Optional[FaultPlan] = None


def current_plan() -> Optional[FaultPlan]:
    return _PLAN


def uninstall() -> None:
    """Remove whatever plan is installed (test-teardown safety net)."""
    global _PLAN
    _PLAN = None


# --- seam entry points -------------------------------------------------------


def fire(site: str) -> None:
    """Raise-type seam: no-op unless the installed plan fires `site`."""
    plan = _PLAN
    if plan is None:
        return
    spec, ix = plan._decide(site, "raise")
    if spec is None:
        return
    plan._log(site, ix, f"raise:{spec.exc}")
    raise _make_exc(spec, site, ix)


def corrupt_array(site: str, arr):
    """Corrupt-type seam: return `arr` unchanged unless the site fires, in
    which case a structurally-broken copy comes back (dtype flipped to NaN
    floats, or the leading axis truncated) — the kind of damage a torn D2H
    copy produces and a structural validator can catch."""
    plan = _PLAN
    if plan is None:
        return arr
    spec, ix = plan._decide(site, "corrupt")
    if spec is None:
        return arr
    plan._log(site, ix, f"corrupt:{spec.corruption}")
    return _corrupt(np.asarray(arr), spec.corruption)


def mangle_bytes(site: str, data: bytes) -> bytes:
    """Byte-payload seam (gossip frames): truncate or garble the payload."""
    plan = _PLAN
    if plan is None:
        return data
    spec, ix = plan._decide(site, "mangle")
    if spec is None:
        return data
    plan._log(site, ix, f"mangle:{spec.corruption}")
    return _mangle(data, spec.corruption)


# --- failure construction ----------------------------------------------------


def _make_exc(spec: FaultSpec, site: str, ix: int) -> Exception:
    msg = f"injected {spec.exc} fault at {site} (call {ix})"
    if spec.exc == "fatal":
        return FatalFault(msg)
    return TransientFault(msg)  # "transient" and "xla"


def _corrupt(arr: np.ndarray, kind: str):
    if kind == "truncate":
        if arr.ndim == 0 or arr.shape[0] == 0:
            return np.float64(np.nan)
        return np.array(arr[:-1])
    # "nan": same shape, dtype flipped to float64 — detectable structurally
    return np.full(arr.shape if arr.ndim else (), np.nan, dtype=np.float64)


def _mangle(data: bytes, kind: str) -> bytes:
    if not data:
        return data
    if kind == "garble":
        # blow up the snappy length preamble: declared size > MAX_MESSAGE_SIZE
        return bytes([data[0] | 0xF0, 0xFF, 0xFF, 0xFF]) + data[1:]
    return data[: len(data) // 2]
