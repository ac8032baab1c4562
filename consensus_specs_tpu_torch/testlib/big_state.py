"""Registry-scale synthetic BeaconState with real keys (copy of the JAX
package's testlib/big_state.py `synthetic_beacon_state`).

Fills the state's columns directly, fast enough for N = 2^20. What differs
from the JAX package's builder:
- the keys are real: validator i's public key is that of secret key i + 1
  (`testlib/keys`), so the first 512 equal `keys.get_pubkeys()`. The JAX
  builder's fake keys are not curve points, so altair's sync-committee
  rotation (`eth_aggregate_pubkeys` asserts `KeyValidate`) fails on them.
  Keys are made as `crypto/msm_synthetic.py` makes them: one scalar
  multiplication and then one point addition a key, affine in one inversion
  a chunk, chunks in worker processes for large N;
- the sync committees' `aggregate_pubkey` is the real aggregate of their
  keys;
- `eth1_data.deposit_count` is N (it equals `eth1_deposit_index`), so that
  blocks pass `process_operations`' deposit count.
"""
from __future__ import annotations

import os

from ..crypto import bls12_381 as oracle
from ..crypto.msm_synthetic import _affine_all
from . import keys as test_keys

_CHUNK = 1 << 15  # keys a worker task makes


def _pubkey_chunk(first: int, count: int) -> list[bytes]:
    """Public keys of secret keys first + 1 ... first + count."""
    F1 = oracle.FP_FIELD
    pt = oracle.pt_mul(F1, oracle.G1_GEN, first + 1)
    jac = []
    for _ in range(count):
        jac.append(pt)
        pt = oracle.pt_add(F1, pt, oracle.G1_GEN)
    return [oracle.g1_to_bytes(a) for a in _affine_all(jac)]


def real_pubkeys(n: int, workers: int | None = None) -> list[bytes]:
    """[SkToPk(i + 1) for i < n], in chunks of 2^15 keys spread over
    `workers` processes (default: the CPU count; one chunk runs here)."""
    spans = [(a, min(_CHUNK, n - a)) for a in range(0, n, _CHUNK)]
    workers = min(workers or os.cpu_count() or 1, len(spans))
    if workers <= 1:
        return [pk for a, c in spans for pk in _pubkey_chunk(a, c)]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = list(ex.map(_pubkey_chunk, *zip(*spans)))
    return [pk for part in parts for pk in part]


def aggregate_pubkey_of(indices) -> bytes:
    """The aggregate public key of validators `indices`: [sum(i + 1)]·G1."""
    F1 = oracle.FP_FIELD
    sk = sum(int(i) + 1 for i in indices) % oracle.R
    return oracle.g1_to_bytes(oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, sk)))


def synthetic_beacon_state(spec, n: int, slot: int = 3200, pubkeys=None):
    """A `spec.BeaconState` with `n` active max-balance validators with real
    keys (`pubkeys`, made here if None), filled historical vectors, and
    (post-phase0) participation and sync-committee fields; the keys are
    registered with `testlib/keys`."""
    if pubkeys is None:
        pubkeys = real_pubkeys(n)
    if len(pubkeys) != n:
        raise ValueError(f"{len(pubkeys)} pubkeys for {n} validators")
    test_keys.register(pubkeys)
    far_future = spec.FAR_FUTURE_EPOCH
    epoch = slot // spec.SLOTS_PER_EPOCH
    V = spec.Validator
    validators = [
        V(
            pubkey=pubkeys[i],
            withdrawal_credentials=bytes(spec.BLS_WITHDRAWAL_PREFIX) + i.to_bytes(31, "little"),
            effective_balance=spec.MAX_EFFECTIVE_BALANCE,
            activation_eligibility_epoch=0,
            activation_epoch=0,
            exit_epoch=far_future,
            withdrawable_epoch=far_future,
        )
        for i in range(n)
    ]
    state = spec.BeaconState(
        genesis_time=1_600_000_000,
        slot=slot,
        fork=spec.Fork(current_version=spec.config.GENESIS_FORK_VERSION),
        latest_block_header=spec.BeaconBlockHeader(slot=slot - 1),
        validators=validators,
        eth1_data=spec.Eth1Data(deposit_count=n),
        eth1_deposit_index=n,
        previous_justified_checkpoint=spec.Checkpoint(epoch=epoch - 2),
        current_justified_checkpoint=spec.Checkpoint(epoch=epoch - 1),
        finalized_checkpoint=spec.Checkpoint(epoch=epoch - 2),
    )
    state.balances = type(state.balances).from_values(
        [int(spec.MAX_EFFECTIVE_BALANCE)] * n)
    for i in range(len(state.block_roots)):
        state.block_roots[i] = spec.Root((i % 251 + 1).to_bytes(32, "little"))
        state.state_roots[i] = spec.Root((i % 241 + 1).to_bytes(32, "big"))
    for i in range(len(state.randao_mixes)):
        state.randao_mixes[i] = spec.Bytes32((i % 253 + 1).to_bytes(32, "little"))
    fields = spec.BeaconState.fields()
    if "previous_epoch_participation" in fields:  # altair+
        part_t = type(state.previous_epoch_participation)
        state.previous_epoch_participation = part_t.from_values([7] * n)
        state.current_epoch_participation = part_t.from_values([3] * n)
        state.inactivity_scores = type(state.inactivity_scores).from_values([0] * n)
        members = [i % n for i in range(spec.SYNC_COMMITTEE_SIZE)]
        committee = spec.SyncCommittee(
            pubkeys=[pubkeys[i] for i in members],
            aggregate_pubkey=aggregate_pubkey_of(members),
        )
        state.current_sync_committee = committee
        state.next_sync_committee = committee.copy()
    return state
