"""The port's SSZ (consensus_specs_tpu_torch/ssz) against the JAX package's:
tests/test_ssz.py's cases run over the port (tests/test_ssz.py itself runs
them over the JAX package), and `hash_tree_root` and
`serialize` equal, byte for byte, on seeded BeaconStates and containers."""
import random
import types
from pathlib import Path

import numpy as np
import pytest

import consensus_specs_tpu.ssz as jssz
import consensus_specs_tpu_torch.ssz as tssz
from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.testlib.genesis import create_valid_beacon_state
from consensus_specs_tpu.testlib.state import next_epoch
from consensus_specs_tpu_torch.compiler import build_spec
from consensus_specs_tpu_torch.native import hashtree

_SSZ_TESTS = Path(__file__).with_name("test_ssz.py")
# cases that build states through the JAX package's compiler and testlib:
# the cross-package state tests below cover them for the port
_JAX_ONLY = {"test_multiproof_roundtrip_beacon_state_fields"}


def _port_ssz_suite() -> types.ModuleType:
    """tests/test_ssz.py with its SSZ imports pointed at the port."""
    src = (_SSZ_TESTS.read_text()
           .replace("consensus_specs_tpu.ssz", "consensus_specs_tpu_torch.ssz")
           .replace("consensus_specs_tpu.utils.hash", "consensus_specs_tpu_torch.utils.hash"))
    mod = types.ModuleType("ssz_suite_port")
    mod.__file__ = str(_SSZ_TESTS)
    exec(compile(src, str(_SSZ_TESTS), "exec"), mod.__dict__)  # noqa: S102
    return mod


_SUITE = _port_ssz_suite()
_CASES = sorted(n for n in vars(_SUITE) if n.startswith("test_") and n not in _JAX_ONLY)


@pytest.mark.parametrize("name", _CASES)
def test_ssz_suite_case(name):
    getattr(_SUITE, name)()


def test_port_suite_uses_the_port_types():
    assert _SUITE.List is tssz.List
    assert _SUITE.List is not jssz.List


def test_native_hasher_matches_hashlib():
    import hashlib

    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 64, 1000):
        blob = rng.integers(0, 256, 64 * n, dtype=np.uint8).tobytes()
        want = b"".join(hashlib.sha256(blob[64 * i:64 * i + 64]).digest() for i in range(n))
        assert hashtree.hash_pairs(blob) == want
    assert hashtree.hash_pairs(b"") == b""
    assert hashtree.library_path().exists()


def _seeded_state(spec, seed: int):
    """A minimal altair BeaconState after a few epochs, with seeded balances,
    participation flags, inactivity scores, slashings and validator fields."""
    was = jbls.bls_active
    jbls.bls_active = False
    try:
        state = create_valid_beacon_state(spec, num_validators=64)
        for _ in range(2):
            next_epoch(spec, state)
    finally:
        jbls.bls_active = was
    rng = random.Random(seed)
    for i in range(len(state.validators)):
        v = state.validators[i]
        state.balances[i] = spec.Gwei(rng.randrange(0, 40_000_000_000))
        v.effective_balance = spec.Gwei(rng.randrange(0, 33) * 10**9)
        v.slashed = rng.random() < 0.1
        state.inactivity_scores[i] = spec.uint64(rng.randrange(0, 2**40))
        state.previous_epoch_participation[i] = spec.ParticipationFlags(rng.randrange(8))
        state.current_epoch_participation[i] = spec.ParticipationFlags(rng.randrange(8))
    for i in range(len(state.slashings)):
        state.slashings[i] = spec.Gwei(rng.randrange(0, 2**50))
    state.eth1_data_votes.append(spec.Eth1Data(deposit_count=seed, block_hash=b"\x07" * 32))
    state.historical_roots.append(spec.Root(bytes([seed]) * 32))
    return state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beacon_state_roots_and_bytes_match_jax(seed):
    jspec = get_spec("altair", "minimal")
    tspec = build_spec("altair", "minimal", device="cpu")
    state = _seeded_state(jspec, seed)
    data = jspec.serialize(state)
    ours = tspec.BeaconState.decode_bytes(data)
    assert tspec.serialize(ours) == data
    assert bytes(tspec.hash_tree_root(ours)) == bytes(jspec.hash_tree_root(state))
    # edit both, rehash incrementally, compare again
    rng = np.random.default_rng(seed)
    for i in rng.integers(0, 64, 5).tolist():
        state.balances[i] = jspec.Gwei(int(i) * 7)
        ours.balances[i] = tspec.Gwei(int(i) * 7)
        state.validators[i].exit_epoch = jspec.Epoch(i + 3)
        ours.validators[i].exit_epoch = tspec.Epoch(i + 3)
    assert bytes(tspec.hash_tree_root(ours)) == bytes(jspec.hash_tree_root(state))
    assert tspec.serialize(ours) == jspec.serialize(state)
    # the columnar backing the bridge's write-back adopts
    bal = ours.balances.to_numpy()
    ours.balances = type(ours.balances).from_numpy(bal[::-1].copy())
    state.balances = type(state.balances).from_numpy(bal[::-1].copy())
    assert bytes(tspec.hash_tree_root(ours)) == bytes(jspec.hash_tree_root(state))


@pytest.mark.parametrize("seed", [3, 4])
def test_seeded_containers_match_jax(seed):
    def build(ssz):
        class Inner(ssz.Container):
            a: ssz.uint64
            b: ssz.Bytes32
            flags: ssz.Bitvector[10]

        class Outer(ssz.Container):
            xs: ssz.List[ssz.uint64, 1 << 20]
            ys: ssz.Vector[ssz.uint16, 33]
            bits: ssz.Bitlist[300]
            blob: ssz.ByteList[500]
            inner: ssz.List[Inner, 64]
            pk: ssz.Bytes48
            big: ssz.uint256

        r = np.random.default_rng(seed)
        return Outer(
            xs=[int(x) for x in r.integers(0, 2**63, int(r.integers(0, 700)))],
            ys=[int(x) for x in r.integers(0, 2**16, 33)],
            bits=[bool(x) for x in r.integers(0, 2, int(r.integers(0, 300)))],
            blob=r.bytes(int(r.integers(0, 500))),
            inner=[Inner(a=int(r.integers(0, 2**63)), b=r.bytes(32),
                         flags=[bool(x) for x in r.integers(0, 2, 10)])
                   for _ in range(int(r.integers(0, 64)))],
            pk=r.bytes(48),
            big=int.from_bytes(r.bytes(32), "little"),
        )

    ours, ref = build(tssz), build(jssz)
    assert tssz.serialize(ours) == jssz.serialize(ref)
    assert bytes(tssz.hash_tree_root(ours)) == bytes(jssz.hash_tree_root(ref))
    assert bytes(tssz.hash_tree_root(type(ours).decode_bytes(jssz.serialize(ref)))) == bytes(
        jssz.hash_tree_root(ref))
