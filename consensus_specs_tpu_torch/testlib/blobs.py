"""Seeded inputs of the DAS lane: one slot's shard blobs and the samples a
reconstructing node holds.

A full blob is POINTS_PER_SAMPLE * MAX_SAMPLES_PER_BLOB points (8 * 2,048 =
16,384 at the mainnet preset, specs/sharding/beacon-chain.md:59, :142), a
slot carries INITIAL_ACTIVE_SHARDS of them (64 at mainnet), and the
extension doubles a blob to MAX_SAMPLES_PER_BLOCK samples (4,096,
specs/das/das-core.md:35). Points are 32 random bytes from
numpy.random.RandomState(seed), reduced mod r.
"""
from __future__ import annotations

import numpy as np

from ..ops.fr import words_to_ints
from ..ops.fr_host import R_MODULUS


def blob_points(spec) -> int:
    return int(spec.POINTS_PER_SAMPLE) * int(spec.MAX_SAMPLES_PER_BLOB)


def slot_blobs(spec, seed: int = 0, count: int | None = None) -> list[list[int]]:
    """`count` (default INITIAL_ACTIVE_SHARDS) full blobs of seeded points."""
    n = blob_points(spec)
    count = int(spec.INITIAL_ACTIVE_SHARDS) if count is None else count
    words = np.random.RandomState(seed).randint(0, 2**32, size=(count, n, 8), dtype=np.uint64)
    vals = [v % R_MODULUS for v in words_to_ints(words.astype(np.uint32))]
    return [vals[i * n:(i + 1) * n] for i in range(count)]


def withheld_samples(spec, published: list, missing: int, seed: int = 0) -> tuple:
    """The published extension of one blob as DASSamples (slot 0, shard 0,
    an empty proof: reconstruction reads only the data), `missing` of them,
    chosen by RandomState(seed), replaced by None. Returns (samples, the
    withheld indices)."""
    pps = int(spec.POINTS_PER_SAMPLE)
    count = len(published) // pps
    gone = set(np.random.RandomState(seed).choice(count, missing, replace=False).tolist())
    vec = spec.Vector[spec.BLSPoint, pps]
    samples = [None if i in gone else spec.DASSample(
        slot=spec.Slot(0), shard=spec.Shard(0), index=spec.SampleIndex(i),
        data=vec(*published[i * pps:(i + 1) * pps])) for i in range(count)]
    return samples, sorted(gone)
