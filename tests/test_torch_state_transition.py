"""The routed altair `state_transition` of the port against the JAX
package's unrouted spec, on the minimal preset.

The port's proposer (`testlib/block.propose_block`) builds and signs blocks
on a 64-validator state with real keys (`testlib/big_state`); the port's
compiled spec applies them inside `engine/routing.routed_spec` (epochs
through the port's bridge, the shuffle hook on the plain K4 + K5) with
`memoized_total_active_balance`, and the
JAX package's compiled spec applies the same blocks, crossed as SSZ bytes,
to the same pre-state on its pure path. The blocks cross two epoch
boundaries, epoch 8 with the sync-committee rotation
(EPOCHS_PER_SYNC_COMMITTEE_PERIOD = 8) and the historical append, and
epoch 9; after every block both post-states' roots are equal (bit-exact).
The port checks signatures (on the CPU's plain pairing) for one block and
its tampered twin."""
import pytest
import torch

from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.testlib import keys as jkeys
from consensus_specs_tpu_torch.compiler import build_spec
from consensus_specs_tpu_torch.crypto import bls as tbls
from consensus_specs_tpu_torch.engine.routing import memoized_total_active_balance, routed_spec
from consensus_specs_tpu_torch.testlib import big_state, keys as tkeys
from consensus_specs_tpu_torch.testlib import block as tblock

SLOTS = (62, 64, 67, 71, 72, 73)
BLS_SLOT = 67


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' tensors are small, so one
    thread is faster, and parallel test workers do not oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def port_bls_on_cpu():
    was, dev = tbls.bls_active, tbls.device
    jwas = jbls.bls_active
    tbls.use_device("cpu")
    jbls.bls_active = False
    yield
    tbls.bls_active = was
    tbls.use_device(dev)
    jbls.bls_active = jwas


def test_big_state_keys_are_the_test_keys():
    keys = big_state.real_pubkeys(600, workers=1)
    assert keys[:512] == list(jkeys.get_pubkeys())
    assert keys[:512] == tkeys.get_pubkeys()
    assert big_state.real_pubkeys(600, workers=2) == keys


def test_routed_state_transition_matches_jax(port_bls_on_cpu):
    tspec = build_spec("altair", "minimal", device="cpu")
    jspec = get_spec("altair", "minimal")
    pre = big_state.synthetic_beacon_state(tspec, 64, slot=SLOTS[0] - 1)
    jstate = jspec.BeaconState.decode_bytes(tspec.serialize(pre))
    assert bytes(jspec.hash_tree_root(jstate)) == bytes(tspec.hash_tree_root(pre))
    prop = pre.copy()
    next_committee = bytes(pre.next_sync_committee.hash_tree_root())
    with routed_spec(tspec, device="cpu"), memoized_total_active_balance(tspec):
        assert tspec.process_epoch.__name__ == "routed"
        assert tspec.get_total_active_balance.__name__ == "total_active_balance"
        for slot in SLOTS:
            signed = tblock.propose_block(tspec, prop, slot, committees=(0,))
            tbls.bls_active = slot == BLS_SLOT
            flushes = tbls.flush_count
            with tbls.deferred_verification():
                tspec.state_transition(pre, signed, validate_result=True)
            assert tbls.flush_count == flushes + (slot == BLS_SLOT)
            tbls.bls_active = True
            jspec.state_transition(jstate, jspec.SignedBeaconBlock.decode_bytes(
                tspec.serialize(signed)), validate_result=True)
            assert bytes(tspec.hash_tree_root(pre)) == bytes(jspec.hash_tree_root(jstate))
            if slot == 64:  # epoch 8: rotation and historical append
                assert bytes(pre.current_sync_committee.hash_tree_root()) == next_committee
                assert len(pre.historical_roots) == 1
        # a twin of the next block with its sync-aggregate signature altered
        def tamper(block):
            block.body.sync_aggregate.sync_committee_signature = tbls.Sign(3, b"tampered")

        signed = tblock.propose_block(tspec, prop, SLOTS[-1] + 1, committees=(0,), edit=tamper)
        tbls.bls_active = True
        with pytest.raises(tbls.BLSVerificationError):
            with tbls.deferred_verification():
                tspec.state_transition(pre, signed, validate_result=True)
    assert tspec.process_epoch.__name__ == "process_epoch"
    assert tspec.get_total_active_balance.__name__ == "get_total_active_balance"


def test_routing_leaves_phase0_on_the_pure_path(port_bls_on_cpu):
    tspec = build_spec("phase0", "minimal", device="cpu")
    jspec = get_spec("phase0", "minimal")
    pre = big_state.synthetic_beacon_state(tspec, 64, slot=31)
    jstate = jspec.BeaconState.decode_bytes(tspec.serialize(pre))
    with routed_spec(tspec, device="cpu"):
        tspec.process_slots(pre, tspec.Slot(41))
    jspec.process_slots(jstate, jspec.Slot(41))
    assert bytes(tspec.hash_tree_root(pre)) == bytes(jspec.hash_tree_root(jstate))


def test_routed_spec_restores_names_when_the_body_raises():
    tspec = build_spec("altair", "minimal", device="cpu")
    epoch_fn, tab_fn = tspec.process_epoch, tspec.get_total_active_balance
    with pytest.raises(KeyError):
        with routed_spec(tspec, device="cpu"), memoized_total_active_balance(tspec):
            raise KeyError("body")
    assert tspec.process_epoch is epoch_fn and tspec.get_total_active_balance is tab_fn


def test_memoized_total_active_balance_follows_the_registry_and_epoch():
    tspec = build_spec("altair", "minimal", device="cpu")
    state = big_state.synthetic_beacon_state(tspec, 64, slot=31)
    want = tspec.get_total_active_balance
    with memoized_total_active_balance(tspec):
        first = tspec.get_total_active_balance(state)
        assert first == want(state)
        state.validators[5].effective_balance -= tspec.EFFECTIVE_BALANCE_INCREMENT
        assert tspec.get_total_active_balance(state) == want(state) == first - int(
            tspec.EFFECTIVE_BALANCE_INCREMENT)
        state.validators[9].exit_epoch = tspec.Epoch(2)
        state.slot = tspec.Slot(2 * int(tspec.SLOTS_PER_EPOCH))
        assert tspec.get_total_active_balance(state) == want(state)
    assert tspec.get_total_active_balance is want


def test_routed_spec_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    tspec = build_spec("altair", "minimal", device="cpu")
    pre = big_state.synthetic_beacon_state(tspec, 64, slot=31)
    with routed_spec(tspec):  # device defaults to "cuda"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tspec.process_slots(pre, tspec.Slot(32))
