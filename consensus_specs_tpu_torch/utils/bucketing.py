"""Shape-bucket planning shared by the port's device lanes (a copy of the
JAX package's sched/bucketing.py: `pow2_bucket`, `pad_plan` and
`grouped_plan`, with their plan classes). `sched/bucketing.py` re-exports
this module: there is one copy of the planning code in the port.

Every device batch pads to a power-of-two bucket (the JAX package keeps one
jit cache entry per bucket; the port keeps the same shapes, so both
packages pad a flush identically). The BLS flush's grouped plan pads the
distinct messages to a power of two and seeds every pad group with a pad
item: an empty segment would sum to infinity and fail the batch closed.
"""
from __future__ import annotations

from dataclasses import dataclass

# Smallest item bucket. Matches the historical crypto/bls_jax._MIN_BATCH:
# below 8 items the pad overhead is noise next to kernel fixed costs, and
# a shared floor keeps the (class, bucket) compile-cache product small.
MIN_BUCKET = 8


def pow2_bucket(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power-of-two >= n, floored at min_bucket (which must itself
    be a power of two — 1 disables the floor)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class PadPlan:
    """Flat (ungrouped) batch plan: n live items padded to one bucket."""

    n: int
    bucket: int

    @property
    def pad(self) -> int:
        return self.bucket - self.n

    @property
    def occupancy(self) -> float:
        """Live fraction of the padded batch (1.0 = no waste)."""
        return self.n / self.bucket if self.bucket else 1.0

    @property
    def pad_waste(self) -> float:
        return 1.0 - self.occupancy


def pad_plan(n: int, min_bucket: int = MIN_BUCKET) -> PadPlan:
    return PadPlan(n=n, bucket=pow2_bucket(n, min_bucket))


@dataclass(frozen=True)
class GroupedPlan:
    """Segmented batch plan: n items in d groups, both padded to buckets.

    Shape contract (inherited verbatim from the RLC grouped flush, whose
    tests pin it): the group bucket b_d pads d to a power of two with no
    minimum; the item bucket b_n is computed over n + pad_groups so every
    pad GROUP is guaranteed at least one pad ITEM to seed it — an empty
    segment would reduce to the identity-less empty sum and fail closed
    (see ops/bls12_jax.g1_segment_sum). Pad items land at the tail in
    submission order: the first pad_groups pads seed groups d..b_d-1, and
    overflow riders join group d (or group 0 when d was already a power
    of two) — callers rely on this ordering so randomization scalars line
    up between grouped and ungrouped packings of the same batch.
    """

    n: int
    d: int
    b_n: int
    b_d: int
    seg: tuple  # group id per slot, len b_n (live items first, pads at tail)
    rep_index: tuple  # len d: index into the live batch of each group's
    # first-seen member (callers take pad values from it)
    pad_assignments: tuple  # len b_n - n: group id per pad item

    @property
    def pad_groups(self) -> int:
        return self.b_d - self.d

    @property
    def pad_items(self) -> int:
        return self.b_n - self.n

    @property
    def occupancy(self) -> float:
        return self.n / self.b_n if self.b_n else 1.0

    @property
    def pad_waste(self) -> float:
        return 1.0 - self.occupancy


def grouped_plan(keys, min_bucket: int = MIN_BUCKET) -> GroupedPlan:
    """Plan a segmented batch from per-item group keys (first-seen order).

    Keys are compared by VALUE — identity of interned keys is an
    optimization upstream, never a correctness input here.
    """
    keys = list(keys)
    n = len(keys)
    gid: dict = {}
    seg = []
    rep_index = []
    for i, k in enumerate(keys):
        g = gid.get(k)
        if g is None:
            g = gid[k] = len(rep_index)
            rep_index.append(i)
        seg.append(g)
    d = len(rep_index)
    b_d = pow2_bucket(d, 1)
    pad_groups = b_d - d
    b_n = pow2_bucket(n + pad_groups, min_bucket)

    pad_assignments = []
    for j in range(b_n - n):
        if j < pad_groups:
            g = d + j  # seed each pad group with one member
        else:
            g = d if pad_groups else 0  # overflow riders join an existing group
        pad_assignments.append(g)
        seg.append(g)

    return GroupedPlan(
        n=n, d=d, b_n=b_n, b_d=b_d, seg=tuple(seg),
        rep_index=tuple(rep_index), pad_assignments=tuple(pad_assignments))
