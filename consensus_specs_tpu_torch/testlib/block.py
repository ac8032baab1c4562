"""Block construction (copy of what the spec path needs from the JAX
package's testlib/block.py, attestations.py and sync_committee.py).

Signatures are made with the port shim's `bls.Sign` and the secret keys of
`testlib/keys`. An aggregate signature over one message is computed
directly, as a deployment's aggregate is, [sum sk]·H(m): one signing with
the summed secret key instead of one a member and a point sum
(`crypto/bls_synthetic.py` makes its aggregates the same way).
"""
from __future__ import annotations

from ..crypto import bls
from .keys import pubkey_to_privkey


def get_proposer_privkey(spec, state, proposer_index=None):
    if proposer_index is None:
        proposer_index = spec.get_beacon_proposer_index(state)
    return pubkey_to_privkey(state.validators[proposer_index].pubkey)


def apply_randao_reveal(spec, state, block):
    assert state.slot <= block.slot
    proposer_state = state
    if state.slot < block.slot:
        proposer_state = state.copy()
        spec.process_slots(proposer_state, block.slot)
    privkey = get_proposer_privkey(spec, proposer_state, block.proposer_index)
    epoch = spec.get_current_epoch(proposer_state)
    domain = spec.get_domain(proposer_state, spec.DOMAIN_RANDAO, epoch)
    signing_root = spec.compute_signing_root(spec.Epoch(epoch), domain)
    block.body.randao_reveal = bls.Sign(privkey, signing_root)


def build_empty_block(spec, state, slot=None):
    """An empty block for `slot` (default: the state's); a state behind
    `slot` is advanced on a copy. Altair and later carry an empty sync
    aggregate (valid with the infinity signature)."""
    if spec.fork not in ("phase0", "altair"):
        raise NotImplementedError(f"block building for {spec.fork} is not ported")
    if slot is None:
        slot = state.slot
    if slot < state.slot:
        raise ValueError("cannot build a block for a past slot")
    if state.slot < slot:
        state = state.copy()
        spec.process_slots(state, slot)
    block = spec.BeaconBlock()
    block.slot = slot
    block.proposer_index = spec.get_beacon_proposer_index(state)
    block.parent_root = spec.hash_tree_root(state.latest_block_header)
    block.body.eth1_data.deposit_count = state.eth1_deposit_index
    if spec.fork != "phase0":
        block.body.sync_aggregate.sync_committee_signature = spec.G2_POINT_AT_INFINITY
    apply_randao_reveal(spec, state, block)
    return block


def build_empty_block_for_next_slot(spec, state):
    return build_empty_block(spec, state, state.slot + 1)


def sign_block(spec, state, block, proposer_index=None):
    if proposer_index is None:
        proposer_index = block.proposer_index
    privkey = pubkey_to_privkey(state.validators[proposer_index].pubkey)
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER,
                             spec.compute_epoch_at_slot(block.slot))
    signing_root = spec.compute_signing_root(block, domain)
    return spec.SignedBeaconBlock(message=block, signature=bls.Sign(privkey, signing_root))


def aggregate_sign(spec, state, indices, signing_root) -> bytes:
    """[sum of the validators' secret keys]·H(signing_root): their aggregate
    signature over one message (duplicates count each time)."""
    sk = sum(pubkey_to_privkey(state.validators[i].pubkey) for i in indices)
    from ..crypto.bls12_381 import R

    return bls.Sign(sk % R, signing_root)


def full_sync_aggregate(spec, state):
    """Every member of the current sync committee signs the block root of
    the slot before `state.slot` (the state is at the block's slot)."""
    previous_slot = max(int(state.slot), 1) - 1
    domain = spec.get_domain(state, spec.DOMAIN_SYNC_COMMITTEE,
                             spec.compute_epoch_at_slot(previous_slot))
    signing_root = spec.compute_signing_root(
        spec.get_block_root_at_slot(state, previous_slot), domain)
    members = [pubkey_to_privkey(pk) - 1 for pk in state.current_sync_committee.pubkeys]
    return spec.SyncAggregate(
        sync_committee_bits=[True] * len(members),
        sync_committee_signature=aggregate_sign(spec, state, members, signing_root))


def build_attestation_data(spec, state, slot, index):
    """AttestationData for a committee of a past slot, as seen from
    `state` (JAX package's testlib/attestations.py)."""
    assert state.slot > slot
    block_root = spec.get_block_root_at_slot(state, slot)
    current_epoch_start_slot = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))
    if slot < current_epoch_start_slot:
        epoch_boundary_root = spec.get_block_root(state, spec.get_previous_epoch(state))
        source = state.previous_justified_checkpoint.copy()
    else:
        epoch_boundary_root = (block_root if slot == current_epoch_start_slot
                               else spec.get_block_root(state, spec.get_current_epoch(state)))
        source = state.current_justified_checkpoint.copy()
    return spec.AttestationData(
        slot=slot, index=index, beacon_block_root=block_root, source=source,
        target=spec.Checkpoint(epoch=spec.compute_epoch_at_slot(slot), root=epoch_boundary_root))


def full_committee_attestation(spec, state, slot, index):
    """A signed attestation of every member of committee `index` at `slot`."""
    data = build_attestation_data(spec, state, spec.Slot(slot), spec.CommitteeIndex(index))
    committee = spec.get_beacon_committee(state, data.slot, data.index)
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_ATTESTER, data.target.epoch)
    return spec.Attestation(
        aggregation_bits=spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](*([1] * len(committee))),
        data=data,
        signature=aggregate_sign(spec, state, committee,
                                 spec.compute_signing_root(data, domain)))


def propose_block(spec, state, slot, committees=(), timings=None, edit=None):
    """The proposer's side of a block at `slot`: advance `state` (IN PLACE)
    to the slot, fill the block (RANDAO reveal, full sync aggregate on
    altair and later, one full attestation of each committee index in
    `committees` from the slot before), apply it to `state` with BLS off,
    set its state root and sign it. Returns the SignedBeaconBlock; `state`
    is the post-block state. `timings`, a dict, receives "root_s", the
    host seconds of the post-block `hash_tree_root`; `edit(block)`, if
    given, changes the filled block before it is applied (a tampered
    twin keeps a consistent state root)."""
    import time

    if state.slot < slot:
        spec.process_slots(state, spec.Slot(slot))
    block = build_empty_block(spec, state, slot)
    if spec.fork != "phase0":
        block.body.sync_aggregate = full_sync_aggregate(spec, state)
    block.body.attestations = [full_committee_attestation(spec, state, slot - 1, c)
                               for c in committees]
    if edit is not None:
        edit(block)
    was = bls.bls_active
    bls.bls_active = False
    try:
        spec.process_block(state, block)
    finally:
        bls.bls_active = was
    t0 = time.perf_counter()
    block.state_root = spec.hash_tree_root(state)
    if timings is not None:
        timings["root_s"] = time.perf_counter() - t0
    return sign_block(spec, state, block)
