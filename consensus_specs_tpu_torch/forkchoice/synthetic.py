"""Seeded contested block trees at registry scale, for the device head's
smoke run, tests and timings (the port's copy of the JAX package's
benches/forkchoice_bench.py `_build_storm`, rng seed 2302).

The tree is the bench's, draw for draw: a trunk of blocks // 8 blocks from
the anchor, then two lineages growing in turn, with a stray fork off a
lineage 15 % of the time; every block carries the genesis checkpoints, and
validator v votes for the tip of lineage v % 2. The balances are not the
bench's constant 32 ETH but the effective balances of the port's synthetic
altair-mainnet registry (engine/synthetic.py, seed 0: 16-32 ETH), so the two
lineages' weights differ and exact ties are rare while the root-word
tie-break still decides between siblings of equal (zero) weight.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from ..engine.state import EpochConfig
from ..engine.synthetic import synthetic_epoch_state_numpy
from .mirror import StoreMirror

STORM_SEED = 2302
PROPOSER_SCORE_BOOST = 70  # the mainnet config's percentage


def registry_balances(n: int, seed: int = 0) -> np.ndarray:
    """(n,) int64 effective balances of the synthetic altair-mainnet
    registry of n validators (all active at its epoch)."""
    d = synthetic_epoch_state_numpy(EpochConfig.altair_mainnet(), n, seed)
    return d["effective_balance"].astype(np.int64)


def boost_weight(balances: np.ndarray, slots_per_epoch: int = 32) -> int:
    """The proposer score as StoreMirror.sync computes it: a committee's
    share of the average balance, times PROPOSER_SCORE_BOOST percent."""
    num = int(balances.shape[0])
    avg = int(balances.sum()) // num
    return (num // slots_per_epoch) * avg * PROPOSER_SCORE_BOOST // 100


@dataclass
class Storm:
    mirror: StoreMirror
    lineage: list        # two lists of block roots, each lineage's chain order
    boost_weight: int

    @property
    def tips(self) -> list:
        return [self.mirror.index_of(side[-1]) for side in self.lineage]

    def perturbed(self, q: int, seed: int) -> list:
        """q snapshots of a vote storm on this mirror (which they change):
        before snapshot k a random slice of V / 8 consecutive validators
        (wrapping) swings to a random lineage's tip, as the bench's
        `one_batch` does; snapshots 1, 3, 5, ... carry a proposer boost on
        the other lineage's tip."""
        rng = random.Random(seed)
        n = self.mirror.n_validators
        out = []
        for k in range(q):
            side = rng.randrange(2)
            base = rng.randrange(n)
            self.mirror.set_votes((base + np.arange(max(1, n // 8))) % n,
                                  self.lineage[side][-1])
            self.mirror.set_boost(self.lineage[1 - side][-1] if k % 2 else None,
                                  self.boost_weight if k % 2 else 0)
            out.append(self.mirror.snapshot())
        return out


def build_storm(blocks: int, validators: int, balances: np.ndarray | None = None) -> Storm:
    """The bench's storm tree of `blocks` blocks with `validators` votes;
    balances default to `registry_balances(validators)`."""
    if balances is None:
        balances = registry_balances(validators)
    rng = random.Random(STORM_SEED)
    m = StoreMirror()
    anchor = bytes(32)
    ck = (0, anchor)
    m.add_block(anchor, anchor, 0, justified=ck, finalized=ck)
    slots = {anchor: 0}

    def add(parent):
        root = rng.randbytes(32)
        slots[root] = slots[parent] + 1
        m.add_block(root, parent, slots[root], justified=ck, finalized=ck)
        return root

    trunk = anchor
    n_trunk = max(2, blocks // 8)
    for _ in range(n_trunk):
        trunk = add(trunk)
    tips = [trunk, trunk]
    lineage: list = [[], []]
    for i in range(blocks - n_trunk - 1):
        side = i % 2
        if rng.random() < 0.15 and lineage[side]:
            add(rng.choice(lineage[side]))  # stray fork off the branch
        else:
            tips[side] = add(tips[side])
            lineage[side].append(tips[side])
    m.set_registry(balances)
    for side in (0, 1):
        m.set_votes(np.arange(side, validators, 2),
                    lineage[side][-1] if lineage[side] else trunk)
    m.set_checkpoints(ck, ck)
    return Storm(mirror=m, lineage=lineage, boost_weight=boost_weight(balances))
