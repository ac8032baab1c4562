"""Bounded retry with exponential backoff + deterministic jitter (the port's
copy of the JAX package's robustness/retry.py).

One policy surface for every seam that can fail transiently. Classification
is centralized here so "what is worth retrying" is one decision:

  retryable   injected TransientFaults, IntegrityErrors (the device source
              is intact — re-reading is safe), socket/OS timeouts, and
              anything carrying `retryable = True`.
  fatal       everything else — assertion failures, host-code bugs,
              `FatalFault` (the injected hard crash), and anything carrying
              `retryable = False`, which is read first: the port's
              `kernels/build.KernelError` (a kernel that does not build,
              load or launch; it wraps the OSError a failed library load
              raises) is never retried and never degraded to the host.

The JAX package also matches XlaRuntimeError by name; the port never sees
one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from random import Random
from typing import Callable, Optional

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from .faults import FaultInjected


def is_retryable(exc: BaseException) -> bool:
    """True when retrying the failed operation can plausibly succeed."""
    marked = getattr(exc, "retryable", None)
    if marked is not None:
        return bool(marked)
    return isinstance(exc, (TimeoutError, ConnectionError, OSError))


def is_device_failure(exc: BaseException) -> bool:
    """Failures eligible for device→host degradation (circuit-breaker
    accounting): anything retryable plus injected fatals — a crashed
    dispatch is a *device* problem, not a host-code bug, even when it is
    not worth re-issuing."""
    return is_retryable(exc) or isinstance(exc, FaultInjected)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with multiplicative jitter.

    max_attempts  total attempts including the first; 0 = unbounded.
    base_delay    delay after the first failure (seconds).
    backoff       delay multiplier per subsequent failure.
    max_delay     backoff ceiling (pre-jitter).
    jitter        fraction of the delay added uniformly at random, from a
                  stream seeded by `seed` — deterministic across runs.
    """

    max_attempts: int = 4
    base_delay: float = 0.02
    backoff: float = 2.0
    max_delay: float = 0.5
    jitter: float = 0.5
    seed: int = 0

    def delay(self, attempt: int, rng: Random) -> float:
        d = min(self.max_delay, self.base_delay * self.backoff ** (attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * rng.random()
        return d


# Shared defaults: device-boundary ops are cheap to re-issue, so short
# delays and a small budget; exhausting it falls through to degradation.
DEVICE_POLICY = RetryPolicy(max_attempts=4, base_delay=0.02, max_delay=0.5)
# The half-open probe gets exactly one attempt (see breaker.py).
PROBE_POLICY = RetryPolicy(max_attempts=1)


def call_with_retry(fn: Callable, policy: Optional[RetryPolicy] = None, *,
                    classify: Callable = is_retryable,
                    sleep: Callable = time.sleep,
                    on_retry: Optional[Callable] = None,
                    deadline: Optional[float] = None,
                    clock: Callable = time.monotonic):
    """Run `fn()` under `policy`; re-raise the final failure unchanged.

    `classify(exc)` decides retry-vs-raise; `on_retry(attempt, exc)` runs
    before each backoff sleep (logging / provenance hooks).

    `deadline` (absolute, in `clock`'s timebase) makes the retry loop
    deadline-aware: once the next backoff sleep would land at or past the
    deadline, the budget cannot fit another attempt and the LAST error is
    raised immediately instead of being burned on doomed backoff — this is
    how front-door deadlines propagate through every retried seam. The
    backoff delay is computed before the check, so the jitter RNG stream
    (and therefore every retried schedule) is identical with or without a
    deadline."""
    policy = policy or DEVICE_POLICY
    rng = Random(policy.seed)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as exc:
            exhausted = policy.max_attempts and attempt >= policy.max_attempts
            if exhausted or not classify(exc):
                if exhausted and classify(exc):
                    _obs_metrics.REGISTRY.counter(
                        "retries_exhausted_total",
                        error=type(exc).__name__).inc()
                raise
            delay = policy.delay(attempt, rng)
            if deadline is not None and clock() + delay >= deadline:
                _obs_metrics.REGISTRY.counter(
                    "retries_deadline_exhausted_total",
                    error=type(exc).__name__).inc()
                raise
            # One tick per absorbed failure, labeled by exception type: the
            # chaos lane reconciles these against the fault plan's per-site
            # fire counts (each retried fire is caught exactly once here).
            _obs_metrics.REGISTRY.counter(
                "retries_total", error=type(exc).__name__).inc()
            _obs_trace.annotate(retried_errors=type(exc).__name__)
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(delay)
