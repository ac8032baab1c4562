"""Fault tolerance around the device boundary (copies of the JAX package's
robustness/faults.py, retry.py and breaker.py; no torch at module level):

  faults.py      seeded `FaultPlan` — deterministic injection at the real
                 seams (`sched.dispatch`).
  retry.py       backoff-with-jitter policies + the retryable-vs-fatal
                 classification every seam shares.
  breaker.py     circuit breaker: device path → pure-Python degradation
                 after N consecutive failures, half-open probe to re-arm.

The JAX package's checkpoint.py is not copied yet (ROADMAP A5).
"""
from . import breaker, faults, retry  # noqa: F401
from .breaker import CircuitBreaker  # noqa: F401
from .faults import (  # noqa: F401
    CorruptAuxError,
    FatalFault,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    IntegrityError,
    TornWriteBackError,
    TransientFault,
)
from .retry import (  # noqa: F401
    DEVICE_POLICY,
    RetryPolicy,
    call_with_retry,
    is_device_failure,
    is_retryable,
)
