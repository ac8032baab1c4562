"""The port's bridge (consensus_specs_tpu_torch/engine/bridge.py) on the CPU
against the JAX package's bridge and the pure spec: the same randomized
states as tests/test_epoch_engine.py (seeds 0-2, genesis, inactivity leak,
activation churn, full participation, bellatrix) go through the three
paths, and the post-states' hash_tree_root must be equal (bit-exact). The
JAX states cross to the port as SSZ bytes (`serialize` / `decode_bytes`).
Also tests/test_dirty_writeback.py's two cases: the dirty-aware write-back
against the full one across every epilogue, and at 65,536 validators on
mainnet."""
import random

import pytest
import torch

from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.engine import bridge as jbridge
from consensus_specs_tpu.testlib.genesis import create_valid_beacon_state
from consensus_specs_tpu.testlib.state import next_epoch, prepared_epoch_state, transition_to
from consensus_specs_tpu_torch.compiler import build_spec
from consensus_specs_tpu_torch.crypto import bls as tbls
from consensus_specs_tpu_torch.engine import bridge as tbridge
from consensus_specs_tpu_torch.engine import epoch as tepoch
from test_epoch_engine import randomize_state

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' tensors are small, so one
    thread is faster, and parallel test workers do not oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _bls_off_port_on_cpu():
    """The JAX spec's checks off; the port shim's aggregates (the rotation's
    AggregatePKs) on the CPU."""
    was, dev = jbls.bls_active, tbls.device
    jbls.bls_active = False
    tbls.use_device("cpu")
    yield
    jbls.bls_active = was
    tbls.use_device(dev)


@pytest.fixture(scope="module")
def specs():
    return {(f, p): (get_spec(f, p), build_spec(f, p, device="cpu"))
            for f in ("altair", "bellatrix") for p in ("minimal",)}


def _port_state(tspec, jspec, state):
    return tspec.BeaconState.decode_bytes(jspec.serialize(state))


def _three_ways(jspec, tspec, state, **port_kwargs):
    ours = _port_state(tspec, jspec, state)
    ref = state.copy()
    jspec.process_epoch(ref)
    eng = state.copy()
    jbridge.apply_epoch_via_engine(jspec, eng)
    tbridge.apply_epoch_via_engine(tspec, ours, device=CPU, **port_kwargs)
    want = bytes(jspec.hash_tree_root(ref))
    assert bytes(jspec.hash_tree_root(eng)) == want
    assert bytes(tspec.hash_tree_root(ours)) == want
    return ours


def _random_state(jspec, seed):
    state = create_valid_beacon_state(jspec, num_validators=64)
    for _ in range(3 + seed):
        next_epoch(jspec, state)
    randomize_state(jspec, state, random.Random(seed))
    transition_to(jspec, state, state.slot + jspec.SLOTS_PER_EPOCH - 1)
    return state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bridge_random(specs, seed):
    jspec, tspec = specs[("altair", "minimal")]
    _three_ways(jspec, tspec, _random_state(jspec, seed))


def test_bridge_genesis_epoch(specs):
    jspec, tspec = specs[("altair", "minimal")]
    state = create_valid_beacon_state(jspec, num_validators=32)
    transition_to(jspec, state, jspec.SLOTS_PER_EPOCH - 1)
    _three_ways(jspec, tspec, state)


def test_bridge_inactivity_leak(specs):
    jspec, tspec = specs[("altair", "minimal")]
    state = create_valid_beacon_state(jspec, num_validators=64)
    for _ in range(8):
        next_epoch(jspec, state)
    randomize_state(jspec, state, random.Random(7), leak=True)
    state.finalized_checkpoint = jspec.Checkpoint(epoch=jspec.Epoch(0),
                                                  root=state.finalized_checkpoint.root)
    transition_to(jspec, state, state.slot + jspec.SLOTS_PER_EPOCH - 1)
    _three_ways(jspec, tspec, state)


def test_bridge_full_participation_justifies(specs):
    jspec, tspec = specs[("altair", "minimal")]
    state = create_valid_beacon_state(jspec, num_validators=64)
    for _ in range(3):
        next_epoch(jspec, state)
    flags = jspec.ParticipationFlags(0b111)
    for i in range(len(state.validators)):
        state.previous_epoch_participation[i] = flags
        state.current_epoch_participation[i] = flags
    transition_to(jspec, state, state.slot + jspec.SLOTS_PER_EPOCH - 1)
    ours = _three_ways(jspec, tspec, state)
    assert int(ours.current_justified_checkpoint.epoch) > int(
        state.current_justified_checkpoint.epoch)


def test_bridge_activation_queue_churn(specs):
    jspec, tspec = specs[("altair", "minimal")]
    rng = random.Random(11)
    state = create_valid_beacon_state(jspec, num_validators=64)
    for _ in range(4):
        next_epoch(jspec, state)
    state.finalized_checkpoint = jspec.Checkpoint(
        epoch=jspec.Epoch(jspec.get_current_epoch(state) - 1),
        root=state.finalized_checkpoint.root)
    for i in range(0, 40):
        v = state.validators[i]
        v.activation_epoch = jspec.FAR_FUTURE_EPOCH
        v.activation_eligibility_epoch = jspec.Epoch(rng.randrange(0, 3))
    for i in range(40, 60):
        state.validators[i].effective_balance = jspec.Gwei(int(jspec.config.EJECTION_BALANCE) // 2)
    transition_to(jspec, state, state.slot + jspec.SLOTS_PER_EPOCH - 1)
    _three_ways(jspec, tspec, state)


@pytest.mark.parametrize("seed", [21, 22])
def test_bridge_bellatrix(specs, seed):
    jspec, tspec = specs[("bellatrix", "minimal")]
    rng = random.Random(seed)
    state = create_valid_beacon_state(jspec, 64)
    next_epoch(jspec, state)
    next_epoch(jspec, state)
    randomize_state(jspec, state, rng, leak=bool(seed % 2))
    current = jspec.get_current_epoch(state)
    half_vector = int(jspec.EPOCHS_PER_SLASHINGS_VECTOR) // 2
    for i in range(0, len(state.validators), 3):
        v = state.validators[i]
        v.slashed = True
        v.withdrawable_epoch = jspec.Epoch(int(current) + half_vector)
        row = int(current) % int(jspec.EPOCHS_PER_SLASHINGS_VECTOR)
        state.slashings[row] += v.effective_balance
    transition_to(jspec, state, state.slot + jspec.SLOTS_PER_EPOCH - 1)
    _three_ways(jspec, tspec, state)


def test_bridge_capture_and_stage_timer(specs):
    """The bridge's capture holds the device epoch's input and output (the
    output equals the plain epoch of the input) and its stage timer sees
    the three stages in order."""
    jspec, tspec = specs[("altair", "minimal")]
    ours = _port_state(tspec, jspec, _random_state(jspec, 1))
    capture, names = {}, []
    tbridge.apply_epoch_via_engine(tspec, ours, device=CPU, capture=capture,
                                   stage_timer=names.append)
    assert names == ["start", "bridge_in", "device", "write_back"]
    ref, aux = tepoch.process_epoch_plain(capture["cfg"], capture["pre"])
    assert all(torch.equal(t, getattr(ref, k)) for k, t in capture["post"].items())
    assert torch.equal(aux.flat(), capture["aux"].flat())


def test_dirty_writeback_minimal_across_period_boundaries(specs):
    """9 epochs from epoch 6 on minimal cross the eth1 reset (period 4), the
    historical append (every 8 epochs) and the sync-committee rotation
    (period 8). The port's dirty-aware write-back and the JAX bridge's full
    write-back agree after every epoch, and the port moves fewer bytes than
    a full write-back would."""
    jspec, tspec = specs[("altair", "minimal")]
    oracle = prepared_epoch_state(jspec, start_epoch=6, seed=17)
    dirty = _port_state(tspec, jspec, oracle)
    for _ in range(9):
        jbridge.apply_epoch_via_engine(jspec, oracle, dirty_aware=False)
        oracle.slot += jspec.SLOTS_PER_EPOCH
        dirty_wb = {}
        tbridge.apply_epoch_via_engine(tspec, dirty, device=CPU, stats=dirty_wb)
        dirty.slot += tspec.SLOTS_PER_EPOCH
        assert bytes(tspec.hash_tree_root(dirty)) == bytes(jspec.hash_tree_root(oracle))
        assert dirty_wb["moved_bytes"] < dirty_wb["full_bytes"]
    assert len(dirty.historical_roots) == 1


def test_dirty_writeback_synthetic_64k():
    """65,536 synthetic validators on mainnet, 4 epochs from epoch 62 across
    the eth1 reset into epoch 64: the port's dirty-aware write-back equals
    the JAX bridge after every epoch and moves at least 5x fewer bytes
    than a full write-back would."""
    from consensus_specs_tpu.testlib.big_state import synthetic_beacon_state

    jspec = get_spec("altair", "mainnet")
    tspec = build_spec("altair", "mainnet", device="cpu")
    base = synthetic_beacon_state(jspec, 65536, slot=63 * int(jspec.SLOTS_PER_EPOCH) - 1)
    dirty = _port_state(tspec, jspec, base)
    for _ in range(4):
        jbridge.apply_epoch_via_engine(jspec, base)
        base.slot += jspec.SLOTS_PER_EPOCH
        dirty_wb = {}
        tbridge.apply_epoch_via_engine(tspec, dirty, device=CPU, stats=dirty_wb)
        dirty.slot += tspec.SLOTS_PER_EPOCH
        assert bytes(tspec.hash_tree_root(dirty)) == bytes(jspec.hash_tree_root(base))
        assert dirty_wb["full_bytes"] >= 5 * dirty_wb["moved_bytes"]
