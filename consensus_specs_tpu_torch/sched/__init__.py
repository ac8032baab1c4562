"""The port's verification scheduler (counterpart of the JAX package's
sched/): one shape-bucketed device queue behind the `sched.dispatch` seam,
with retry, circuit breaker and metrics.

Public surface:
  * `Request` / `Handle` — the typed submit/future API (api.py)
  * `Scheduler`, `default_scheduler`, `reset_default_scheduler` — the
    admission + dispatch engine (scheduler.py)
  * `bucketing` — the pow2 bucket planner (utils/bucketing.py)
  * work classes (classes.py) — `MerkleWorkClass`, the read lane's
"""
from . import bucketing  # noqa: F401
from .api import Handle, Request  # noqa: F401
from .classes import MerkleWorkClass, WorkClass, default_classes  # noqa: F401
from .scheduler import (  # noqa: F401
    DISPATCH_RETRY_POLICY,
    EdfSealPolicy,
    SchedResultIntegrityError,
    SchedSelfCheckError,
    Scheduler,
    SealPolicy,
    default_scheduler,
    reset_default_scheduler,
)
