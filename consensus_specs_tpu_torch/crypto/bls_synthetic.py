"""Seeded BLS flush inputs at mainnet size, made on the host with the port's
copied pure-Python oracle (no key files, no network).

Aggregates are computed directly, as a deployment sees them: a committee's
key is [sum sk]·G1 and its aggregate signature [sum sk]·H(m), so the card
gets exactly the points a real flush gets while the host does one scalar
multiplication per aggregate instead of one per member.
- `block`: the signature checks of one altair block at N = 2^20 validators
  (32 slots, 64 committees of 512): MAX_ATTESTATIONS = 128 attestation
  aggregates, the proposer signature, the RANDAO reveal and the sync
  aggregate of SYNC_COMMITTEE_SIZE = 512 members; 131 distinct messages.
- `gossip`: one slot's aggregate attestations, 64 committees x
  TARGET_AGGREGATORS_PER_COMMITTEE = 16 aggregators signing their
  committee's root (specs/phase0/validator.md:22); aggregator j + 1's key
  and signature are aggregator j's plus G1 and plus H(m), point additions
  that keep the host's part to a few seconds.
- `shim`: keys, messages and byte-level signatures for the shim's Verify /
  FastAggregateVerify / AggregateVerify calls.
"""
from __future__ import annotations

import numpy as np

from . import bls12_381 as oracle
from . import bls_sig, bls_torch

# The mainnet preset at N = 2^20 active validators.
MAX_ATTESTATIONS = 128
COMMITTEES_PER_SLOT = 64
COMMITTEE_SIZE = 2**20 // 32 // COMMITTEES_PER_SLOT  # 512
SYNC_COMMITTEE_SIZE = 512
TARGET_AGGREGATORS_PER_COMMITTEE = 16
SHIM_KEYS = 20  # the shim's byte-level calls


def flush_inputs(seed: int):
    """(block checks, gossip checks, shim dict) from `seed`, at the sizes of
    the module docstring."""
    F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
    rng = np.random.default_rng(seed)

    def committee_sk(size):
        return sum(int(k) for k in rng.integers(1, 2**63, size, dtype=np.int64)) % oracle.R

    def check(sk, msg):
        h = bls_torch.hash_to_curve_g2(msg)
        pk = oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, sk))
        sig = oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), sk))
        return bls_torch.QueuedCheck(pk, h, bls_torch._NEG_G1, sig)

    block = [check(committee_sk(COMMITTEE_SIZE), b"attestation " + rng.bytes(32))
             for _ in range(MAX_ATTESTATIONS)]
    block += [check(committee_sk(1), b"proposer " + rng.bytes(32)),
              check(committee_sk(1), b"randao " + rng.bytes(32)),
              check(committee_sk(SYNC_COMMITTEE_SIZE), b"sync aggregate " + rng.bytes(32))]
    gossip = []
    for _ in range(COMMITTEES_PER_SLOT):
        first = check(committee_sk(TARGET_AGGREGATORS_PER_COMMITTEE),
                      b"slot aggregate " + rng.bytes(32))
        pk = oracle.pt_from_affine(F1, first.p1)
        sig = oracle.pt_from_affine(F2, first.q2)
        h = oracle.pt_from_affine(F2, first.q1)
        for _ in range(TARGET_AGGREGATORS_PER_COMMITTEE):
            gossip.append(bls_torch.QueuedCheck(oracle.pt_to_affine(F1, pk), first.q1,
                                                bls_torch._NEG_G1, oracle.pt_to_affine(F2, sig)))
            pk, sig = oracle.pt_add(F1, pk, oracle.G1_GEN), oracle.pt_add(F2, sig, h)
    sks = [int(k) for k in rng.integers(1, 2**62, SHIM_KEYS, dtype=np.int64)]
    msgs = [rng.bytes(32) for _ in range(SHIM_KEYS)]
    sigs = [bls_sig.Sign(k, m) for k, m in zip(sks, msgs)]
    shim = dict(sks=sks, msgs=msgs, pks=[bls_sig.SkToPk(k) for k in sks], sigs=sigs,
                committee_sig=bls_sig.Aggregate([bls_sig.Sign(k, msgs[0]) for k in sks[:4]]),
                multi_sig=bls_sig.Aggregate(sigs[:2]))
    return block, gossip, shim
