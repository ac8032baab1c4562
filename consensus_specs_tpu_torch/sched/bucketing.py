"""The scheduler's shape-bucket planning: `utils/bucketing.py`, re-exported
(the JAX package keeps it in sched/bucketing.py; the port keeps one copy)."""
from ..utils.bucketing import (  # noqa: F401
    MIN_BUCKET,
    GroupedPlan,
    PadPlan,
    grouped_plan,
    pad_plan,
    pow2_bucket,
)
