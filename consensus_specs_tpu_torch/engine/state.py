"""Struct-of-arrays epoch state as tensors (counterpart of engine/state.py).

Layout, names and meaning follow the JAX package's `EpochState`: one flat
tensor per registry field, (N,) each, plus small replicated vectors and
scalars. Types:
- uint64 columns and scalars are int64 tensors holding the uint64 bit
  pattern (FAR_FUTURE_EPOCH reads as -1; see utils/u64.py);
- 32-byte roots are (..., 8) int32 tensors of big-endian sha word bit
  patterns, the lane format of kernel K1;
- participation flags are uint8, `slashed` and `justification_bits` bool.

`EpochConfig` carries the static constants of one (fork, preset):
`from_spec` reads them from a compiled spec module (the port's own
compiler's), and the four supported configurations are also literals here;
tests hold both equal to the JAX `EpochConfig.from_spec`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EpochConfig:
    slots_per_epoch: int
    epochs_per_slashings_vector: int
    epochs_per_historical_vector: int
    slots_per_historical_root: int
    max_effective_balance: int
    effective_balance_increment: int
    base_reward_factor: int
    hysteresis_quotient: int
    hysteresis_downward_multiplier: int
    hysteresis_upward_multiplier: int
    min_epochs_to_inactivity_penalty: int
    proportional_slashing_multiplier: int
    inactivity_penalty_quotient: int
    max_seed_lookahead: int
    min_seed_lookahead: int
    epochs_per_sync_committee_period: int
    sync_committee_size: int
    shuffle_round_count: int
    weight_denominator: int
    participation_flag_weights: Tuple[int, ...]
    timely_head_flag_index: int
    timely_target_flag_index: int
    inactivity_score_bias: int
    inactivity_score_recovery_rate: int
    min_per_epoch_churn_limit: int
    churn_limit_quotient: int
    ejection_balance: int
    min_validator_withdrawability_delay: int
    epochs_per_eth1_voting_period: int
    genesis_epoch: int = 0
    far_future_epoch: int = 2**64 - 1

    @classmethod
    def from_spec(cls, spec) -> "EpochConfig":
        """From a compiled spec module, altair or later (engine/state.py:78):
        bellatrix and later forks take its punitive slashing multiplier and
        inactivity penalty quotient."""
        from ..compiler.spec_compiler import FORK_ORDER

        bellatrix_plus = FORK_ORDER.index(spec.fork) >= FORK_ORDER.index("bellatrix")
        return cls(
            slots_per_epoch=int(spec.SLOTS_PER_EPOCH),
            epochs_per_slashings_vector=int(spec.EPOCHS_PER_SLASHINGS_VECTOR),
            epochs_per_historical_vector=int(spec.EPOCHS_PER_HISTORICAL_VECTOR),
            slots_per_historical_root=int(spec.SLOTS_PER_HISTORICAL_ROOT),
            max_effective_balance=int(spec.MAX_EFFECTIVE_BALANCE),
            effective_balance_increment=int(spec.EFFECTIVE_BALANCE_INCREMENT),
            base_reward_factor=int(spec.BASE_REWARD_FACTOR),
            hysteresis_quotient=int(spec.HYSTERESIS_QUOTIENT),
            hysteresis_downward_multiplier=int(spec.HYSTERESIS_DOWNWARD_MULTIPLIER),
            hysteresis_upward_multiplier=int(spec.HYSTERESIS_UPWARD_MULTIPLIER),
            min_epochs_to_inactivity_penalty=int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY),
            proportional_slashing_multiplier=int(
                spec.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX if bellatrix_plus
                else spec.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR),
            inactivity_penalty_quotient=int(
                spec.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX if bellatrix_plus
                else spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR),
            max_seed_lookahead=int(spec.MAX_SEED_LOOKAHEAD),
            min_seed_lookahead=int(spec.MIN_SEED_LOOKAHEAD),
            epochs_per_sync_committee_period=int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD),
            sync_committee_size=int(spec.SYNC_COMMITTEE_SIZE),
            shuffle_round_count=int(spec.SHUFFLE_ROUND_COUNT),
            weight_denominator=int(spec.WEIGHT_DENOMINATOR),
            participation_flag_weights=tuple(int(w) for w in spec.PARTICIPATION_FLAG_WEIGHTS),
            timely_head_flag_index=int(spec.TIMELY_HEAD_FLAG_INDEX),
            timely_target_flag_index=int(spec.TIMELY_TARGET_FLAG_INDEX),
            inactivity_score_bias=int(spec.config.INACTIVITY_SCORE_BIAS),
            inactivity_score_recovery_rate=int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE),
            min_per_epoch_churn_limit=int(spec.config.MIN_PER_EPOCH_CHURN_LIMIT),
            churn_limit_quotient=int(spec.config.CHURN_LIMIT_QUOTIENT),
            ejection_balance=int(spec.config.EJECTION_BALANCE),
            min_validator_withdrawability_delay=int(spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY),
            epochs_per_eth1_voting_period=int(spec.EPOCHS_PER_ETH1_VOTING_PERIOD),
            genesis_epoch=int(spec.GENESIS_EPOCH),
        )

    @classmethod
    def altair_mainnet(cls) -> "EpochConfig":
        return cls(**_ALTAIR_MAINNET)

    @classmethod
    def altair_minimal(cls) -> "EpochConfig":
        return cls(**_ALTAIR_MINIMAL)

    @classmethod
    def bellatrix_mainnet(cls) -> "EpochConfig":
        # bellatrix finalizes the punitive parameters
        return cls(**{**_ALTAIR_MAINNET, **_BELLATRIX})

    @classmethod
    def bellatrix_minimal(cls) -> "EpochConfig":
        return cls(**{**_ALTAIR_MINIMAL, **_BELLATRIX})


_ALTAIR_MAINNET = dict(
    slots_per_epoch=32,
    epochs_per_slashings_vector=8192,
    epochs_per_historical_vector=65536,
    slots_per_historical_root=8192,
    max_effective_balance=32_000_000_000,
    effective_balance_increment=1_000_000_000,
    base_reward_factor=64,
    hysteresis_quotient=4,
    hysteresis_downward_multiplier=1,
    hysteresis_upward_multiplier=5,
    min_epochs_to_inactivity_penalty=4,
    proportional_slashing_multiplier=2,
    inactivity_penalty_quotient=3 * 2**24,
    max_seed_lookahead=4,
    min_seed_lookahead=1,
    epochs_per_sync_committee_period=256,
    sync_committee_size=512,
    shuffle_round_count=90,
    weight_denominator=64,
    participation_flag_weights=(14, 26, 14),
    timely_head_flag_index=2,
    timely_target_flag_index=1,
    inactivity_score_bias=4,
    inactivity_score_recovery_rate=16,
    min_per_epoch_churn_limit=4,
    churn_limit_quotient=65536,
    ejection_balance=16_000_000_000,
    min_validator_withdrawability_delay=256,
    epochs_per_eth1_voting_period=64,
)

_ALTAIR_MINIMAL = dict(
    _ALTAIR_MAINNET,
    slots_per_epoch=8,
    epochs_per_slashings_vector=64,
    epochs_per_historical_vector=64,
    slots_per_historical_root=64,
    epochs_per_sync_committee_period=8,
    sync_committee_size=32,
    shuffle_round_count=10,
    churn_limit_quotient=32,
    epochs_per_eth1_voting_period=4,
)

_BELLATRIX = dict(proportional_slashing_multiplier=3, inactivity_penalty_quotient=2**24)


@dataclasses.dataclass
class EpochState:
    """Everything `process_epoch` reads or writes, as tensors on one device."""

    slot: torch.Tensor  # () int64 (uint64)

    # Per-validator registry, (N,) each.
    balances: torch.Tensor  # int64 (uint64)
    effective_balance: torch.Tensor  # int64
    activation_eligibility_epoch: torch.Tensor  # int64
    activation_epoch: torch.Tensor  # int64
    exit_epoch: torch.Tensor  # int64
    withdrawable_epoch: torch.Tensor  # int64
    slashed: torch.Tensor  # bool
    prev_participation: torch.Tensor  # uint8 flag bits
    curr_participation: torch.Tensor  # uint8
    inactivity_scores: torch.Tensor  # int64

    # Small replicated vectors.
    slashings: torch.Tensor  # (EPOCHS_PER_SLASHINGS_VECTOR,) int64
    randao_mixes: torch.Tensor  # (EPOCHS_PER_HISTORICAL_VECTOR, 8) int32
    block_roots: torch.Tensor  # (SLOTS_PER_HISTORICAL_ROOT, 8) int32
    state_roots: torch.Tensor  # (SLOTS_PER_HISTORICAL_ROOT, 8) int32
    justification_bits: torch.Tensor  # (4,) bool

    # Checkpoints: epoch scalar + 8-word root.
    prev_justified_epoch: torch.Tensor  # () int64
    prev_justified_root: torch.Tensor  # (8,) int32
    curr_justified_epoch: torch.Tensor  # () int64
    curr_justified_root: torch.Tensor  # (8,) int32
    finalized_epoch: torch.Tensor  # () int64
    finalized_root: torch.Tensor  # (8,) int32

    @property
    def num_validators(self) -> int:
        return self.balances.shape[0]

    @property
    def device(self) -> torch.device:
        return self.balances.device

    def items(self):
        return ((f.name, getattr(self, f.name)) for f in dataclasses.fields(self))

    def clone(self) -> "EpochState":
        return EpochState(**{k: v.clone() for k, v in self.items()})

    def copy_(self, other: "EpochState") -> "EpochState":
        """Overwrite every tensor of self in place with other's values."""
        for k, v in self.items():
            v.copy_(getattr(other, k))
        return self


# Columns the dirty tracking watches, in flag order (engine/state.py
# DIRTY_TRACKED of the JAX package): every registry-scale field the epoch
# program can mutate. block_roots/state_roots are absent on purpose: the
# epoch program never writes them.
DIRTY_TRACKED: tuple = (
    "balances",
    "effective_balance",
    "activation_eligibility_epoch",
    "activation_epoch",
    "exit_epoch",
    "withdrawable_epoch",
    "slashed",
    "prev_participation",
    "curr_participation",
    "inactivity_scores",
    "slashings",
    "randao_mixes",
)


@dataclasses.dataclass
class EpochAux:
    """Side outputs of the epoch step: three () bool flags and the
    (len(DIRTY_TRACKED),) bool dirty_cols, where dirty_cols[i] is True iff
    the transition changed some element of DIRTY_TRACKED[i] (final value
    against pre value)."""

    historical_append: torch.Tensor
    eth1_votes_reset: torch.Tensor
    sync_committee_update: torch.Tensor
    dirty_cols: torch.Tensor

    @classmethod
    def from_flat(cls, flat: torch.Tensor) -> "EpochAux":
        """Views of one (3 + len(DIRTY_TRACKED),) bool tensor laid out as
        [historical_append, eth1_votes_reset, sync_committee_update,
        dirty_cols...] — the layout the epoch kernel writes."""
        return cls(flat[0], flat[1], flat[2], flat[3:])

    def flat(self) -> torch.Tensor:
        return torch.cat([torch.stack([self.historical_append, self.eth1_votes_reset,
                                       self.sync_committee_update]), self.dirty_cols])
