"""The port's fork choice held against the JAX package on the CPU: the plain
versions of K15-K18 (consensus_specs_tpu_torch/ops/forkchoice.py) against
JAX's `ghost_head_bucket` on the same padded inputs, the stage outputs
against the host oracle, the port's `ghost_head_batch` against JAX's over
mixed buckets, the port's StoreMirror against the JAX mirror and the compiled
spec's `get_head`, and the copied helpers and storm tree against their
originals. Every comparison is exact.
"""
import random

import numpy as np
import pytest
import torch

from benches import forkchoice_bench
from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.crypto import bls
from consensus_specs_tpu.engine import fork_choice as jax_engine
from consensus_specs_tpu.forkchoice import StoreMirror as JaxMirror
from consensus_specs_tpu.forkchoice import reference as jax_ref
from consensus_specs_tpu.ops.forkchoice_jax import ghost_head_bucket
from consensus_specs_tpu.testlib import fork_choice as jax_tl
from consensus_specs_tpu.testlib.attestations import get_valid_attestation
from consensus_specs_tpu.testlib.block import build_empty_block, state_transition_and_sign_block
from consensus_specs_tpu.testlib.genesis import create_valid_beacon_state
from consensus_specs_tpu.testlib.state import next_slots
from consensus_specs_tpu_torch import forkchoice as tfc
from consensus_specs_tpu_torch.engine import fork_choice as t_engine
from consensus_specs_tpu_torch.engine.convert import snapshot_from_jax
from consensus_specs_tpu_torch.forkchoice import synthetic
from consensus_specs_tpu_torch.ops import forkchoice as tops
from consensus_specs_tpu_torch.utils.device import resolve_device

GWEI_32 = 32_000_000_000
# (blocks, validators) ranges that pad to the buckets (8, 64), (64, 1024) and
# (256, 8192); 6,000 validators is not a multiple of JAX's V_CHUNK = 4096
BUCKETS = {(8, 64): ((2, 8), (1, 64)), (64, 1024): ((33, 64), (513, 1024)),
           (256, 8192): ((129, 256), (6000, 6000))}


def _root(rng) -> bytes:
    return bytes(rng.randrange(256) for _ in range(32))


def _rand_mirror(cls, seed, nb, nv):
    """tests/test_forkchoice.py's seeded contested tree, built with either
    package's StoreMirror: random branching, mixed per-block checkpoints,
    partial participation, sometimes a boost or a non-genesis justification;
    odd seeds draw 16-32 ETH balances, even seeds 32 ETH (ties)."""
    rng = random.Random(seed)
    m = cls()
    anchor = _root(rng)
    anchor_ck = (0, anchor)
    m.add_block(anchor, anchor, 0, justified=anchor_ck, finalized=anchor_ck)
    roots, slots = [anchor], {anchor: 0}
    for _ in range(nb - 1):
        parent = roots[rng.randrange(len(roots))]
        root = _root(rng)
        slot = slots[parent] + rng.randrange(1, 3)
        jc = anchor_ck if rng.random() < 0.8 else (1, roots[0])
        fc = anchor_ck if rng.random() < 0.9 else (1, anchor)
        m.add_block(root, parent, slot, justified=jc, finalized=fc)
        roots.append(root)
        slots[root] = slot
    if seed % 2:
        m.set_registry(np.asarray([rng.randrange(16, 33) * 10**9 for _ in range(nv)],
                                  dtype=np.int64))
    else:
        m.set_registry(np.full(nv, GWEI_32, dtype=np.int64))
    for v in range(nv):
        if rng.random() < 0.7:
            m.set_vote(v, roots[rng.randrange(len(roots))])
    if rng.random() < 0.5:
        m.set_checkpoints((0, anchor), (0, anchor))
    else:
        m.set_checkpoints((1, anchor), (0, anchor))
    if rng.random() < 0.5:
        m.set_boost(roots[rng.randrange(len(roots))], 2 * GWEI_32)
    return m


def _bucket_snaps(bucket, q=4, base=0):
    (b_lo, b_hi), (v_lo, v_hi) = BUCKETS[bucket]
    out = []
    for k in range(q):
        rng = random.Random(7000 + 31 * base + k)
        out.append(_rand_mirror(JaxMirror, 100 * base + k, rng.randint(b_lo, b_hi),
                                rng.randint(v_lo, v_hi)).snapshot())
    return out


def _jax_heads(snaps, b, v):
    rows = [jax_engine._padded_member(s, b, v) for s in snaps]
    batch = [np.stack(arrs) for arrs in zip(*rows)]
    return np.asarray(ghost_head_bucket(*batch), dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_plain_matches_jax_random_trees(bucket):
    snaps = _bucket_snaps(bucket, base=list(BUCKETS).index(bucket))
    ports = [snapshot_from_jax(s) for s in snaps]
    [(key, members, batch)] = t_engine.group_tensors(ports, "cpu")
    assert key == bucket and members == [0, 1, 2, 3]
    jax_rows = [np.stack(a) for a in zip(*(jax_engine._padded_member(s, *bucket) for s in snaps))]
    for ours, theirs in zip(batch, jax_rows):  # the same padded values
        np.testing.assert_array_equal(ours.numpy(), theirs.astype(ours.numpy().dtype))
    want = _jax_heads(snaps, *bucket)
    assert tops.ghost_head_plain(*batch).tolist() == want.tolist()
    assert tops.ghost_head(*batch).tolist() == want.tolist()
    assert want.tolist() == [jax_ref.host_head(s) for s in snaps]


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_parts_match_host_oracle(bucket):
    """weight = reference.subtree_weights, filtered = filtered_mask on every
    real block; pads carry no weight and are never filtered in."""
    base = 7 + list(BUCKETS).index(bucket)
    snaps = [snapshot_from_jax(s) for s in _bucket_snaps(bucket, base=base)]
    [(_, _, batch)] = t_engine.group_tensors(snaps, "cpu")
    parts = tops.ghost_head_parts(*batch)
    for q, snap in enumerate(snaps):
        n = snap.n_blocks
        np.testing.assert_array_equal(parts["weight"][q, :n].numpy(), tfc.subtree_weights(snap))
        np.testing.assert_array_equal(parts["filtered"][q, :n].numpy(), tfc.filtered_mask(snap))
        assert not parts["filtered"][q, n:].any() and not parts["weight"][q, n:].any()
        assert int(parts["head"][q]) == tfc.host_head(snap)
    anc = tops.unpack_bits(parts["anc"], bucket[0])
    for q, snap in enumerate(snaps):  # row i holds exactly i and its ancestors
        for i in range(snap.n_blocks):
            chain, j = {i}, i
            while int(snap.parent[j]) != j:
                j = int(snap.parent[j])
                chain.add(j)
            assert set(torch.nonzero(anc[q, i]).flatten().tolist()) == chain


def test_ancestors_need_no_parent_order():
    """Parents after their children, and a 2-cycle: the plain doubling gives
    JAX's reach (2**ceil(log2 B) - 1 steps) without assuming parent <= i."""
    parent = torch.tensor([[0, 3, 1, 0, 5, 4, 6, 6]], dtype=torch.int32)
    anc = tops.unpack_bits(tops.ancestors_plain(parent), 8)[0]
    assert set(torch.nonzero(anc[2]).flatten().tolist()) == {2, 1, 3, 0}
    assert set(torch.nonzero(anc[4]).flatten().tolist()) == {4, 5}
    assert set(torch.nonzero(anc[7]).flatten().tolist()) == {7, 6}


def _two_fork(a, b, weights, boost=None):
    m = tfc.StoreMirror()
    anchor = b"\x10" * 32
    ck = (0, anchor)
    m.add_block(anchor, anchor, 0, justified=ck, finalized=ck)
    m.add_block(a, anchor, 1, justified=ck, finalized=ck)
    m.add_block(b, anchor, 1, justified=ck, finalized=ck)
    nv = max(sum(weights), 1)
    m.set_registry(np.full(nv, GWEI_32, dtype=np.int64))
    v = 0
    for root, count in zip((a, b), weights):
        for _ in range(count):
            m.set_vote(v, root)
            v += 1
    m.set_checkpoints(ck, ck)
    if boost is not None:
        m.set_boost(boost, 2 * GWEI_32)
    return m


def _ffg_mirrors():
    anchor, good, bad = b"\x01" * 32, b"\x02" * 32, b"\x03" * 32
    just_ck = (1, anchor)
    pruned = tfc.StoreMirror()
    pruned.add_block(anchor, anchor, 0, justified=just_ck, finalized=(0, anchor))
    pruned.add_block(good, anchor, 1, justified=just_ck, finalized=(0, anchor))
    pruned.add_block(bad, anchor, 1, justified=(0, anchor), finalized=(0, anchor))
    pruned.set_registry(np.full(4, GWEI_32, dtype=np.int64))
    pruned.set_votes(range(4), bad)
    pruned.set_checkpoints(just_ck, (0, anchor))
    escaped = tfc.StoreMirror()  # the store's justified epoch is GENESIS_EPOCH
    escaped.add_block(anchor, anchor, 0, justified=(0, anchor), finalized=(0, anchor))
    escaped.add_block(good, anchor, 1, justified=(0, good), finalized=(0, anchor))
    escaped.add_block(bad, anchor, 1, justified=(0, bad), finalized=(0, anchor))
    escaped.set_registry(np.full(4, GWEI_32, dtype=np.int64))
    escaped.set_votes(range(3), bad)
    escaped.set_checkpoints((0, anchor), (0, anchor))
    none_viable = tfc.StoreMirror()
    none_viable.add_block(anchor, anchor, 0, justified=just_ck, finalized=(0, anchor))
    none_viable.add_block(bad, anchor, 1, justified=(0, anchor), finalized=(0, anchor))
    none_viable.set_registry(np.full(2, GWEI_32, dtype=np.int64))
    none_viable.set_vote(0, bad)
    none_viable.set_checkpoints(just_ck, (0, anchor))
    return {"ffg_pruned": (pruned, good), "genesis_escape": (escaped, bad),
            "none_viable": (none_viable, anchor)}


def _edge_cases():
    """{name: (mirror, the expected head root)}."""
    hi, lo = b"\xaa" * 32, b"\x0b" * 32
    top = b"\x80" + b"\x00" * 31      # word 0 = 2**31: a signed compare puts it last
    low = b"\x7f" + b"\xff" * 31
    late_hi = b"\x10" * 8 + b"\xf0" + b"\x00" * 23  # equal to word 1, then 2**31 above
    late_lo = b"\x10" * 8 + b"\x70" + b"\xff" * 23
    cases = {
        "boost_off": (_two_fork(hi, lo, (3, 2)), hi),
        "boost_on": (_two_fork(hi, lo, (3, 2), boost=lo), lo),
        "tie_bytes": (_two_fork(hi, lo, (2, 2)), hi),
        "tie_word0_top_bit": (_two_fork(low, top, (1, 1)), top),
        "tie_word2_top_bit": (_two_fork(late_lo, late_hi, (0, 0)), late_hi),
        "all_votes_none": (_two_fork(lo, hi, (0, 0)), hi),
    }
    cases.update(_ffg_mirrors())
    single = tfc.StoreMirror()
    anchor = b"\x42" * 32
    single.add_block(anchor, anchor, 0)
    single.set_registry(np.full(5, GWEI_32, dtype=np.int64))
    single.set_checkpoints((0, anchor), (0, anchor))
    cases["single_block"] = (single, anchor)
    leaf = _two_fork(hi, lo, (1, 4))  # the justified root is a childless leaf
    leaf.set_checkpoints((0, hi), (0, b"\x10" * 32))
    cases["childless_justified"] = (leaf, hi)
    return cases


def test_edges_match_jax():
    cases = _edge_cases()
    names = sorted(cases)
    snaps = [cases[n][0].snapshot() for n in names]
    assert all(t_engine.bucket_of(s) == (8, 64) for s in snaps)
    ours = t_engine.ghost_head_batch(snaps, device="cpu")
    for k in range(0, len(snaps), 4):  # groups of 4: JAX's (4, 8, 64) program
        chunk = snaps[k:k + 4]
        chunk += chunk[:1] * (4 - len(chunk))
        want = _jax_heads(chunk, 8, 64)[:len(snaps[k:k + 4])]
        assert ours[k:k + 4].tolist() == want.tolist(), names[k:k + 4]
    for name, snap, head in zip(names, snaps, ours):
        mirror, root = cases[name]
        assert mirror.root_at(int(head)) == root, name
        assert int(head) == tfc.host_head(snap), name


def test_ghost_head_batch_matches_jax_mixed_buckets():
    """Three snapshots a bucket, interleaved: order is kept, each group pads
    Q from 3 to 4 by replicating its first member."""
    per = {key: _bucket_snaps(key, q=3, base=20 + i) for i, key in enumerate(BUCKETS)}
    snaps = [per[key][k] for k in range(3) for key in BUCKETS]
    want = jax_engine.ghost_head_batch(snaps)
    ours = t_engine.ghost_head_batch([snapshot_from_jax(s) for s in snaps], device="cpu")
    assert ours.dtype == np.int32 and ours.tolist() == want.tolist()
    assert ours.tolist() == [jax_ref.host_head(s) for s in snaps]


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    snap = _edge_cases()["boost_on"][0].snapshot()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.ghost_head_batch([snap])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        tops.ancestors(torch.zeros((1, 8), dtype=torch.int32, device="meta"))


def _snapshot_fields_equal(a, b):
    for name in ("parent", "slots", "root_words", "ck_epochs", "ck_rids", "votes", "balances"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    for name in ("justified_idx", "boost_idx", "boost_weight", "store_justified",
                 "store_finalized", "genesis_epoch"):
        assert getattr(a, name) == getattr(b, name), name


def test_mirror_sync_matches_jax_and_spec_get_head():
    """Both mirrors synced over one compiled-spec store (two competing slot-1
    blocks, the first one timely: proposer boost; then an attestation for the
    loser of the tie-break and the next slot) give equal snapshots, and the
    port's head is the spec's `get_head` at every step."""
    spec = get_spec("phase0", "minimal")
    prev = bls.bls_active
    bls.bls_active = False
    try:
        state = create_valid_beacon_state(spec, 64)
        store, _ = jax_tl.get_genesis_forkchoice_store_and_block(spec, state)
        mirrors = (JaxMirror(), tfc.StoreMirror())

        def check(label):
            for m in mirrors:
                m.sync(spec, store)
            theirs, ours = (m.snapshot() for m in mirrors)
            _snapshot_fields_equal(theirs, ours)
            _snapshot_fields_equal(snapshot_from_jax(theirs), ours)
            head = int(t_engine.ghost_head_batch([ours], device="cpu")[0])
            assert mirrors[1].root_at(head) == bytes(spec.get_head(store)), label
            assert head == tfc.host_head(ours) == jax_ref.host_head(theirs), label
            return ours

        check("genesis")
        branches = []
        for graffiti in (b"\x00" * 32, b"\x01" * 32):
            st = state.copy()
            block = build_empty_block(spec, st, 1)
            block.body.graffiti = graffiti
            branches.append((st, state_transition_and_sign_block(spec, st, block),
                             spec.hash_tree_root(block)))
        spec.on_tick(store, store.genesis_time + spec.config.SECONDS_PER_SLOT)
        for _, signed, _ in branches:
            spec.on_block(store, signed)
        snap = check("two timely blocks")
        assert snap.boost_idx >= 0 and snap.boost_weight > 0
        loser = min(branches, key=lambda b: bytes(b[2]))
        next_slots(spec, loser[0], 1)
        att = get_valid_attestation(spec, loser[0], slot=1)
        spec.on_tick(store, store.genesis_time + 2 * spec.config.SECONDS_PER_SLOT)
        spec.on_attestation(store, att)
        snap = check("attested loser")
        assert snap.boost_idx == -1
        assert bytes(spec.get_head(store)) == bytes(loser[2])
    finally:
        bls.bls_active = prev


class _Msg:
    def __init__(self, epoch):
        self.epoch = epoch


class _Blk:
    def __init__(self, slot, parent_root):
        self.slot = slot
        self.parent_root = parent_root


def test_copied_helpers_match_jax():
    rng = random.Random(5)
    for _ in range(50):
        lm = {i: _Msg(rng.randrange(6)) for i in rng.sample(range(20), 10)}
        idx = rng.sample(range(25), 12)
        ep = rng.randrange(7)
        assert tfc.latest_message_updates(lm, idx, ep) == jax_tl.latest_message_updates(lm, idx, ep)
    blocks = {0: _Blk(0, 0)}
    for r in range(1, 40):
        p = rng.randrange(r)
        blocks[r] = _Blk(blocks[p].slot + rng.randrange(1, 3), p)
    blocks[40] = _Blk(3, 99)  # parent outside the mapping
    for r in blocks:
        for slot in range(0, 30, 3):
            assert tfc.ancestor_at_slot(blocks, r, slot) == jax_tl.ancestor_at_slot(blocks, r, slot)
    for seed in range(6):
        snap = _rand_mirror(JaxMirror, 300 + seed, 3 + 5 * seed, 40).snapshot()
        port = snapshot_from_jax(snap)
        assert tfc.host_head(port) == jax_ref.host_head(snap)
        np.testing.assert_array_equal(tfc.subtree_weights(port), jax_ref.subtree_weights(snap))
        np.testing.assert_array_equal(tfc.filtered_mask(port), jax_ref.filtered_mask(snap))


@pytest.mark.parametrize("blocks,validators", [(64, 100), (512, 1000)])
def test_storm_tree_matches_bench(blocks, validators):
    """The port's storm is the bench's tree, draw for draw (balances are the
    synthetic registry's by design), and its V/8 swings move the head."""
    theirs, lineage, _ = forkchoice_bench._build_storm(
        {"blocks": blocks, "validators": validators})
    storm = synthetic.build_storm(blocks, validators)
    a, b = theirs.snapshot(), storm.mirror.snapshot()
    for name in ("parent", "slots", "root_words", "ck_epochs", "ck_rids", "votes"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert storm.lineage == lineage
    np.testing.assert_array_equal(b.balances, synthetic.registry_balances(validators))
    assert b.balances.min() >= 16 * 10**9 and b.balances.max() <= 32 * 10**9
    snaps = storm.perturbed(8, 1)
    heads = t_engine.ghost_head_batch(snaps, device="cpu")
    assert heads.tolist() == [tfc.host_head(s) for s in snaps]
    assert [s.boost_idx >= 0 for s in snaps] == [k % 2 == 1 for k in range(8)]
    assert set(heads.tolist()) <= set(storm.tips)
