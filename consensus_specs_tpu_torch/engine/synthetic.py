"""Synthetic epoch states for benchmarks, smoke runs and tests
(counterpart of engine/synthetic.py).

The numpy draws are those of the JAX package's synthetic_epoch_state, in
the same order, so one seed gives bit-identical arrays in both packages. Arrays are made in bulk on the host
and moved to the device once.
"""
from __future__ import annotations

import numpy as np

from .convert import epoch_state_from_numpy
from .state import EpochConfig, EpochState

FAR = 2**64 - 1


def synthetic_epoch_state_numpy(cfg: EpochConfig, n: int, seed: int = 0,
                                epoch: int = 100) -> dict:
    """The JAX package's synthetic registry as a dict of numpy arrays in its
    dtypes (uint64, uint32, uint8, bool): a plausible mid-life registry,
    mostly active, mixed participation, some slashed, some exiting."""
    rng = np.random.default_rng(seed)
    slot = epoch * cfg.slots_per_epoch + cfg.slots_per_epoch - 1
    slashed = rng.random(n) < 0.01
    exiting = rng.random(n) < 0.02
    far = np.uint64(FAR)
    exit_epoch = np.where(
        exiting, (epoch + rng.integers(1, 50, n)).astype(np.uint64), far
    )
    withdrawable = np.where(
        exiting, exit_epoch + np.uint64(cfg.min_validator_withdrawability_delay), far
    )
    withdrawable = np.where(
        slashed,
        (epoch + rng.integers(1, cfg.epochs_per_slashings_vector, n)).astype(np.uint64),
        withdrawable,
    )
    u64 = lambda x: np.asarray(x, dtype=np.uint64)  # noqa: E731
    return dict(
        slot=u64(slot),
        balances=rng.integers(31_000_000_000, 33_000_000_000, n, dtype=np.uint64),
        effective_balance=(rng.integers(16, 33, n, dtype=np.uint64))
        * np.uint64(cfg.effective_balance_increment),
        activation_eligibility_epoch=np.zeros(n, np.uint64),
        activation_epoch=np.zeros(n, np.uint64),
        exit_epoch=exit_epoch,
        withdrawable_epoch=withdrawable,
        slashed=slashed,
        prev_participation=rng.integers(0, 8, n).astype(np.uint8),
        curr_participation=rng.integers(0, 8, n).astype(np.uint8),
        inactivity_scores=rng.integers(0, 100, n, dtype=np.uint64),
        slashings=rng.integers(0, 10_000_000_000, cfg.epochs_per_slashings_vector,
                               dtype=np.uint64),
        randao_mixes=rng.integers(0, 2**32, (cfg.epochs_per_historical_vector, 8),
                                  dtype=np.uint64).astype(np.uint32),
        block_roots=rng.integers(0, 2**32, (cfg.slots_per_historical_root, 8),
                                 dtype=np.uint64).astype(np.uint32),
        state_roots=rng.integers(0, 2**32, (cfg.slots_per_historical_root, 8),
                                 dtype=np.uint64).astype(np.uint32),
        justification_bits=np.array([True, True, False, False]),
        prev_justified_epoch=u64(epoch - 2),
        prev_justified_root=np.zeros(8, np.uint32),
        curr_justified_epoch=u64(epoch - 1),
        curr_justified_root=np.zeros(8, np.uint32),
        finalized_epoch=u64(epoch - 2),
        finalized_root=np.zeros(8, np.uint32),
    )


def synthetic_epoch_state(cfg: EpochConfig, n: int, seed: int = 0, epoch: int = 100,
                          device="cuda") -> EpochState:
    """`synthetic_epoch_state_numpy` as an EpochState on `device`."""
    return epoch_state_from_numpy(synthetic_epoch_state_numpy(cfg, n, seed, epoch), device)


# ---------------------------------------------------------------------------
# Edge states: synthetic registries changed so that one epoch reaches a
# given branch of process_epoch. Shared by the tests and chip_smoke.py.


def _genesis(cfg: EpochConfig, n: int, seed: int) -> dict:
    """cur = 0: justification, inactivity and rewards are all gated off."""
    d = synthetic_epoch_state_numpy(cfg, n, seed)
    d["slot"] = np.uint64(cfg.slots_per_epoch - 1)
    for k in ("prev_justified_epoch", "curr_justified_epoch", "finalized_epoch"):
        d[k] = np.uint64(0)
    d["exit_epoch"][:] = np.uint64(FAR)
    d["withdrawable_epoch"][:] = np.uint64(FAR)
    return d


def _epoch_one(cfg: EpochConfig, n: int, seed: int) -> dict:
    """cur = 1: rewards run, justification does not."""
    d = _genesis(cfg, n, seed)
    d["slot"] = np.uint64(2 * cfg.slots_per_epoch - 1)
    return d


def _leak(cfg: EpochConfig, n: int, seed: int) -> dict:
    """Ancient finality: no finalization rule can fire, so the leak holds."""
    d = synthetic_epoch_state_numpy(cfg, n, seed)
    d["prev_justified_epoch"] = np.uint64(10)
    d["curr_justified_epoch"] = np.uint64(10)
    d["finalized_epoch"] = np.uint64(5)
    d["justification_bits"][:] = False
    return d


def _full_participation(cfg: EpochConfig, n: int, seed: int) -> dict:
    """Every flag set: both justification branches and finalization fire,
    and block roots are gathered into the checkpoints."""
    d = synthetic_epoch_state_numpy(cfg, n, seed)
    d["prev_participation"][:] = 7
    d["curr_participation"][:] = 7
    d["justification_bits"][:] = [True, True, True, False]
    return d


def _add_ejections(cfg: EpochConfig, d: dict, rng) -> None:
    """A third of the registry falls to the ejection balance with no exit,
    and some validators already sit on the exit frontier."""
    n = len(d["balances"])
    low = rng.random(n) < 0.33
    d["effective_balance"][low] = np.uint64(cfg.ejection_balance)
    d["exit_epoch"][low] = np.uint64(FAR)
    d["withdrawable_epoch"][low & ~d["slashed"]] = np.uint64(FAR)
    front = np.flatnonzero(~low)[:3]
    d["exit_epoch"][front] = np.uint64(100 + 1 + cfg.max_seed_lookahead + 60)


def _add_activation_queue(cfg: EpochConfig, d: dict, rng) -> None:
    """A third of the registry waits for activation with eligibility epochs
    (many tied) at or below finality, and some become eligible this epoch."""
    n = len(d["balances"])
    queued = rng.random(n) < 0.33
    d["activation_epoch"][queued] = np.uint64(FAR)
    d["exit_epoch"][queued] = np.uint64(FAR)
    d["withdrawable_epoch"][queued] = np.uint64(FAR)
    d["activation_eligibility_epoch"][queued] = rng.integers(90, 99, queued.sum()).astype(np.uint64)
    fresh = queued & (rng.random(n) < 0.3)
    d["activation_eligibility_epoch"][fresh] = np.uint64(FAR)
    d["effective_balance"][fresh] = np.uint64(cfg.max_effective_balance)


def _ejections_beyond_churn(cfg: EpochConfig, n: int, seed: int) -> dict:
    d = synthetic_epoch_state_numpy(cfg, n, seed)
    _add_ejections(cfg, d, np.random.default_rng(seed + 100))
    return d


def _activation_queue_beyond_churn(cfg: EpochConfig, n: int, seed: int) -> dict:
    d = synthetic_epoch_state_numpy(cfg, n, seed)
    _add_activation_queue(cfg, d, np.random.default_rng(seed + 200))
    return d


def _ejections_and_queue(cfg: EpochConfig, n: int, seed: int) -> dict:
    """Ejections and an activation queue in one epoch, both beyond churn."""
    d = _ejections_beyond_churn(cfg, n, seed)
    _add_activation_queue(cfg, d, np.random.default_rng(seed + 200))
    return d


def _slashing_hit(cfg: EpochConfig, n: int, seed: int) -> dict:
    """Slashed validators whose withdrawable epoch is cur + EPSV/2, with a
    large slashings sum, so process_slashings takes balance."""
    d = synthetic_epoch_state_numpy(cfg, n, seed)
    hit = np.random.default_rng(seed + 300).random(n) < 0.1
    d["slashed"][hit] = True
    d["withdrawable_epoch"][hit] = np.uint64(100 + cfg.epochs_per_slashings_vector // 2)
    d["slashings"][:] = np.uint64(4_000_000_000_000)
    return d


def _boundary(cfg: EpochConfig, n: int, seed: int) -> dict:
    """The next epoch is a multiple of the historical batch, the eth1 voting
    period and the sync-committee period: all three aux flags fire."""
    return synthetic_epoch_state_numpy(cfg, n, seed, epoch=cfg.epochs_per_sync_committee_period - 1)


EDGE_STATES = {
    "genesis": _genesis, "epoch_one": _epoch_one, "leak": _leak,
    "full_participation": _full_participation,
    "ejections_beyond_churn": _ejections_beyond_churn,
    "activation_queue_beyond_churn": _activation_queue_beyond_churn,
    "ejections_and_queue": _ejections_and_queue,
    "slashing_hit": _slashing_hit, "boundary": _boundary,
}


def edge_epoch_state_numpy(cfg: EpochConfig, case: str, n: int, seed: int = 0) -> dict:
    """The edge state `case` (a key of EDGE_STATES) as numpy arrays in the
    JAX leaf dtypes, at start epoch 100 unless the case sets its own."""
    return EDGE_STATES[case](cfg, n, seed)
