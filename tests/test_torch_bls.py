"""The port's BLS flush (consensus_specs_tpu_torch/crypto/bls_torch.py) and
shim (crypto/bls.py) on the CPU, where every kernel runs its plain version:
- the copied oracle modules and bucketing plans give the JAX package's
  outputs on seeded inputs;
- the flush's packing equals the JAX package's (limb backend), its
  randomizers come from the CSPRNG, and `run_checks` attributes a bad check
  to its index on both the ungrouped and the grouped path;
- the shim's deferral semantics: one flush at the outermost exit, inner
  bodies that raise drop their checks, per-thread queues, the kill-switch;
- committee-key aggregation from DEVICE_AGGREGATE_MIN keys: the markers of
  `_aggregate_pubkeys_device_impl` equal the JAX package's on the same keys,
  cold keys are checked once and cached, and AggregatePKs /
  FastAggregateVerify give the host oracle's results.
Tolerance: exact (points, bytes, markers and verdicts compared for
equality).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls12_381 as jax_oracle
from consensus_specs_tpu.crypto import bls_jax
from consensus_specs_tpu.crypto import bls_sig as jax_sig
from consensus_specs_tpu.crypto import hash_to_curve as jax_h2c
from consensus_specs_tpu.crypto import isogeny as jax_iso
from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu.sched import bucketing as jax_bucketing
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto import bls_sig, bls_torch, hash_to_curve, isogeny
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.utils import bucketing


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain field's tensors are small, so one
    thread is faster, and parallel test workers do not oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cpu_shim():
    saved = (bls.device, bls.bls_active)
    bls.use_device("cpu")
    bls.bls_active = True
    yield bls
    bls.device, bls.bls_active = saved


@pytest.fixture
def limb_backend():
    K.set_field_backend("limb")
    yield
    K.set_field_backend("rns")


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(1, 2**62, n, dtype=np.int64)]


def _messages(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


# --- the copied oracle ----------------------------------------------------------------


def test_copied_oracle_modules_match_jax_package():
    sks = _keys(1, 3)
    msgs = _messages(2, 3)
    for sk, msg in zip(sks, msgs):
        assert bls_sig.SkToPk(sk) == jax_sig.SkToPk(sk)
        assert bls_sig.Sign(sk, msg) == jax_sig.Sign(sk, msg)
        assert hash_to_curve.hash_to_curve_g2(msg) == jax_h2c.hash_to_curve_g2(msg)
        assert hash_to_curve.hash_to_field_fp2(msg, 2) == jax_h2c.hash_to_field_fp2(msg, 2)
        pk = bls_sig.SkToPk(sk)
        assert oracle.g1_from_bytes(pk) == jax_oracle.g1_from_bytes(pk)
        sig = bls_sig.Sign(sk, msg)
        assert oracle.g2_from_bytes(sig) == jax_oracle.g2_from_bytes(sig)
    assert hash_to_curve.MAP_TO_CURVE_RFC_COMPLIANT == jax_h2c.MAP_TO_CURVE_RFC_COMPLIANT
    u = hash_to_curve.hash_to_field_fp2(msgs[0], 2)[0]
    iso_pt = hash_to_curve.map_to_curve_sswu_iso(u)
    assert isogeny.iso3_map(iso_pt) == jax_iso.iso3_map(iso_pt)
    assert oracle._FROB_GAMMA == jax_oracle._FROB_GAMMA
    assert (oracle.P, oracle.R, oracle.X_PARAM) == (jax_oracle.P, jax_oracle.R, jax_oracle.X_PARAM)
    assert (oracle.G1_GEN_AFF, oracle.G2_GEN_AFF) == (jax_oracle.G1_GEN_AFF, jax_oracle.G2_GEN_AFF)
    q, p = oracle.G2_GEN_AFF, bls_torch.g1_from_bytes(bls_sig.SkToPk(sks[0]))
    assert oracle.pairing(q, p) == jax_oracle.pairing(q, p)
    pks = [bls_sig.SkToPk(sk) for sk in sks]
    sigs = [bls_sig.Sign(sk, msgs[0]) for sk in sks]
    assert bls_sig.AggregatePKs(pks) == jax_sig.AggregatePKs(pks)
    assert bls_sig.Aggregate(sigs) == jax_sig.Aggregate(sigs)
    agg = bls_sig.Aggregate(sigs)
    assert bls_sig.FastAggregateVerify(pks, msgs[0], agg) is jax_sig.FastAggregateVerify(
        pks, msgs[0], agg) is True


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bucketing_plans_match_jax_package(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    keys = [int(k) for k in rng.integers(0, max(1, n // int(rng.integers(1, 9))), n)]
    mine, theirs = bucketing.grouped_plan(keys), jax_bucketing.grouped_plan(keys)
    assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)
    assert (mine.pad_groups, mine.pad_items) == (theirs.pad_groups, theirs.pad_items)
    assert bucketing.pow2_bucket(n) == jax_bucketing.pow2_bucket(n)
    assert bucketing.pow2_bucket(n, 1) == jax_bucketing.pow2_bucket(n, 1)
    assert dataclasses.astuple(bucketing.pad_plan(n)) == dataclasses.astuple(
        jax_bucketing.pad_plan(n))


# --- the flush ------------------------------------------------------------------------


def _triples(n, distinct, seed):
    """n valid (pk, H(m), sig) affine triples over `distinct` messages."""
    sks = _keys(seed, n)
    msgs = _messages(seed + 1, distinct)
    hs = [bls_torch.hash_to_curve_g2(msgs[i % distinct]) for i in range(n)]
    pks = [oracle.pt_to_affine(oracle.FP_FIELD, oracle.pt_mul(oracle.FP_FIELD, oracle.G1_GEN, k))
           for k in sks]
    sigs = [oracle.pt_to_affine(oracle.FP2_FIELD, oracle.pt_mul(
        oracle.FP2_FIELD, oracle.pt_from_affine(oracle.FP2_FIELD, h), k))
        for h, k in zip(hs, sks)]
    return pks, hs, sigs


def test_pack_pairing_args_match_jax(limb_backend):
    pks, hs, sigs = _triples(5, 5, 3)
    neg = [bls_torch._NEG_G1] * 5
    b, mine = bls_torch._pack_pairing_args(pks, hs, neg, sigs, "cpu")
    jb, (qx, qy, px, py, q2x, q2y, p2x, p2y) = bls_jax._pack_pairing_args(pks, hs, neg, sigs)
    assert b == jb == 8
    q1, p1, q2, p2 = mine
    assert torch.equal(q1, torch.stack([convert.f2_from_jax(qx), convert.f2_from_jax(qy)], 1))
    assert torch.equal(p1, torch.stack([convert.fp_from_jax_limbs(px),
                                        convert.fp_from_jax_limbs(py)], 1))
    assert torch.equal(q2, torch.stack([convert.f2_from_jax(q2x), convert.f2_from_jax(q2y)], 1))
    assert torch.equal(p2, torch.stack([convert.fp_from_jax_limbs(p2x),
                                        convert.fp_from_jax_limbs(p2y)], 1))


def test_pack_grouped_args_match_jax(limb_backend):
    pks, hs, sigs = _triples(6, 3, 4)
    b_n, b_d, (q1, p1, q2), seg = bls_torch._pack_grouped_args(pks, hs, sigs, "cpu")
    jb_n, jb_d, (qx, qy, px, py, q2x, q2y), jseg = bls_jax._pack_grouped_args(pks, hs, sigs)
    assert (b_n, b_d) == (jb_n, jb_d) == (8, 4)
    assert seg.tolist() == np.asarray(jseg).tolist()
    assert torch.equal(q1, torch.stack([convert.f2_from_jax(qx), convert.f2_from_jax(qy)], 1))
    assert torch.equal(p1, torch.stack([convert.fp_from_jax_limbs(px),
                                        convert.fp_from_jax_limbs(py)], 1))
    assert torch.equal(q2, torch.stack([convert.f2_from_jax(q2x), convert.f2_from_jax(q2y)], 1))


def test_random_zbits_come_from_the_csprng(monkeypatch):
    """The flush's scalars are the CSPRNG's bytes, low word first; a zero
    scalar is drawn again."""
    draws = [bytes(8) + (5).to_bytes(8, "little") + (2**64 - 1).to_bytes(8, "little"),
             (7 << 32).to_bytes(8, "little")]
    calls = []

    def fake(k):
        calls.append(k)
        return draws.pop(0)

    monkeypatch.setattr(bls_torch.secrets, "token_bytes", fake)
    z = bls_torch.random_zbits(3, "cpu")
    assert calls == [24, 8]
    assert z.dtype == torch.int32 and z.tolist() == [[0, 7], [5, 0], [-1, -1]]
    monkeypatch.undo()
    z = bls_torch.random_zbits(64, "cpu")
    assert z.shape == (64, 2) and bool(((z[:, 0] != 0) | (z[:, 1] != 0)).all())
    assert len({tuple(r) for r in z.tolist()}) == 64


def _checks(pks, hs, sigs):
    return [bls_torch.QueuedCheck(p, h, bls_torch._NEG_G1, s) for p, h, s in zip(pks, hs, sigs)]


@pytest.mark.parametrize("path", ["rlc", "rlc_grouped"])
def test_run_checks_attributes_the_bad_check(path):
    """16 checks take the randomized path (distinct messages: N + 1 Miller
    loops; repeated: D + 1); one bad signature fails it, and the per-item
    pass flags exactly that index. A None check is False."""
    distinct = 16 if path == "rlc" else 4
    pks, hs, sigs = _triples(16, distinct, 5)
    checks = _checks(pks, hs, sigs)
    before = B.miller_loop_items
    assert bls_torch.run_checks(checks, "cpu").tolist() == [True] * 16
    assert bls_torch.LAST_FLUSH["path"] == path
    loops = bls_torch.LAST_FLUSH["miller_loops"]
    assert loops == (17 if path == "rlc" else 5)
    assert B.miller_loop_items - before == loops
    checks[9] = bls_torch.QueuedCheck(pks[9], hs[9], bls_torch._NEG_G1, sigs[8])
    checks[3] = None
    got = bls_torch.run_checks(checks, "cpu")
    assert got.tolist() == [i not in (3, 9) for i in range(16)]


def test_run_checks_small_batch_goes_per_item():
    pks, hs, sigs = _triples(3, 3, 6)
    sigs[0] = sigs[1]
    bls_torch.LAST_FLUSH.clear()
    assert bls_torch.run_checks(_checks(pks, hs, sigs), "cpu").tolist() == [False, True, True]
    assert bls_torch.LAST_FLUSH == {}
    assert bls_torch.run_checks([None, None], "cpu").tolist() == [False, False]


def test_make_checks_reject_invalid_inputs():
    sk = _keys(7, 1)[0]
    msg = b"m"
    pk, sig = bls_sig.SkToPk(sk), bls_sig.Sign(sk, msg)
    good = bls_torch.make_verify_check(pk, msg, sig)
    assert good.p1 == oracle.g1_from_bytes(pk) and good.p2 == bls_torch._NEG_G1
    assert bls_torch.make_verify_check(b"\x00" * 48, msg, sig) is None
    assert bls_torch.make_verify_check(oracle.g1_to_bytes(None), msg, sig) is None
    assert bls_torch.make_fast_aggregate_check([], msg, sig) is None
    assert bls_torch.make_fast_aggregate_check([pk, b"\x01" * 48], msg, sig) is None
    agg = bls_torch.make_fast_aggregate_check([pk, pk], msg, sig)
    assert agg.p1 == oracle.pt_to_affine(oracle.FP_FIELD, oracle.pt_double(
        oracle.FP_FIELD, oracle.pt_from_affine(oracle.FP_FIELD, oracle.g1_from_bytes(pk))))


# --- the shim --------------------------------------------------------------------------


def _signed_bytes(seed, n):
    sks = _keys(seed, n)
    msgs = _messages(seed + 1, n)
    return [(bls_sig.SkToPk(k), m, bls_sig.Sign(k, m)) for k, m in zip(sks, msgs)]


def test_shim_defers_and_flushes_once(cpu_shim):
    items = _signed_bytes(8, 3)
    flushes = bls.flush_count
    with bls.deferred_verification():
        for pk, m, s in items:
            assert bls.Verify(pk, m, s) is True
        with bls.deferred_verification():  # reentrant: queues into the outer batch
            assert bls.FastAggregateVerify([items[0][0]], items[0][1], items[0][2])
        assert len(bls._deferral.queue) == 4
    assert bls.flush_count == flushes + 1
    assert bls._deferral.queue is None and bls._deferral.depth == 0


def test_shim_raises_on_a_bad_check_and_resets(cpu_shim):
    (pk, m, s), (pk2, m2, s2) = _signed_bytes(9, 2)
    with pytest.raises(bls.BLSVerificationError, match=r"\[1\]"):
        with bls.deferred_verification():
            bls.Verify(pk, m, s)
            bls.Verify(pk2, m2, s)
    assert bls._deferral.queue is None
    assert issubclass(bls.BLSVerificationError, AssertionError)


def test_shim_inner_raise_drops_its_checks(cpu_shim):
    (pk, m, s), (pk2, m2, _) = _signed_bytes(10, 2)
    with bls.deferred_verification():
        bls.Verify(pk, m, s)
        with pytest.raises(KeyError):
            with bls.deferred_verification():
                bls.Verify(pk2, m2, s)  # bad, but its block fails first
                raise KeyError("block rejected")
        assert len(bls._deferral.queue) == 1
    # no BLSVerificationError: the bad check went with its block


def test_shim_inline_checks_and_aggregate_verify(cpu_shim):
    (pk, m, s), (pk2, m2, s2) = _signed_bytes(11, 2)
    inline = bls.inline_check_count
    assert bls.Verify(pk, m, s) is True
    assert bls.Verify(pk, m2, s) is False
    assert bls.inline_check_count == inline + 2
    agg = bls.Aggregate([s, s2])
    assert bls.AggregateVerify([pk, pk2], [m, m2], agg) is True
    assert bls.AggregateVerify([pk, pk2], [m2, m], agg) is False
    with bls.deferred_verification():
        with bls.inline_verification():
            assert bls.Verify(pk, m2, s) is False  # resolved at once
        assert bls._deferral.queue == []


def test_shim_queues_are_per_thread(cpu_shim):
    (pk, m, s), = _signed_bytes(12, 1)
    seen = {}

    def other():
        seen["queue"] = bls._deferral.queue

    with bls.deferred_verification():
        bls.Verify(pk, m, s)
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen["queue"] is None


def test_shim_kill_switch_returns_stubs(cpu_shim):
    bls.bls_active = False
    assert bls.Verify(b"", b"", b"") is True
    assert bls.FastAggregateVerify([], b"", b"") is True
    assert bls.Sign(1, b"m") == bls.STUB_SIGNATURE
    assert bls.SkToPk(1) == bls.STUB_SIGNATURE
    bls.bls_active = True
    assert bls.SkToPk(5) == bls_sig.SkToPk(5)
    assert bls.AggregatePKs([bls.SkToPk(5)]) == bls.SkToPk(5)


# --- committee-key aggregation on the device path ------------------------------------


@pytest.fixture
def fresh_key_caches():
    def clear():
        bls_torch.clear_caches()
        bls_jax._AGG_CACHE.clear()
        bls_jax._PK_VALIDATED.clear()

    clear()
    yield
    clear()


def _committee(seed, n):
    sks = _keys(seed, n)
    return sks, [bls_sig.SkToPk(k) for k in sks]


def _g1_mul(k):
    return oracle.pt_to_affine(oracle.FP_FIELD, oracle.pt_mul(oracle.FP_FIELD, oracle.G1_GEN,
                                                              k % oracle.R))


@pytest.mark.parametrize("case", ["valid", "inf_member", "non_subgroup", "bad_encoding"])
def test_device_aggregation_markers_match_jax(case, fresh_key_caches):
    """40 keys (a 64-item bucket): a valid committee, one with the point at
    infinity, one with the on-curve (0, 2) outside the subgroup, one with a
    bad encoding; the port's marker equals the JAX shim's."""
    sks, pks = _committee(20, 40)
    bad = {"inf_member": oracle.g1_to_bytes(None), "non_subgroup": oracle.g1_to_bytes((0, 2)),
           "bad_encoding": b"\x01" * 48}.get(case)
    if bad is not None:
        pks[7] = bad
    got = bls_torch._aggregate_pubkeys_device_impl(pks, "cpu")
    assert got == bls_jax._aggregate_pubkeys_device_impl(pks)
    if case == "valid":
        assert got == ("point", *_g1_mul(sum(sks)))
    assert got[0] == {"valid": "point", "inf_member": "inf_member",
                      "non_subgroup": "bad_encoding", "bad_encoding": "bad_encoding"}[case]


def _counters():
    return (bls_torch.pubkey_aggregate_device_total,
            bls_torch.pubkey_aggregate_device_keys_total,
            bls_torch.pubkey_subgroup_device_total)


def test_cold_then_cached_routing_by_counters(fresh_key_caches):
    """First sighting: one aggregation, every key checked; again: the
    committee cache, nothing on the device; a committee with one new key
    checks only that key; fewer than 32 keys stay on the host."""
    sks, pks = _committee(21, 40)
    c0 = _counters()
    assert bls_torch._aggregate_pubkeys_affine(pks, "cpu") == _g1_mul(sum(sks))
    assert np.subtract(_counters(), c0).tolist() == [1, 40, 40]
    assert len(bls_torch._PK_VALIDATED) == 40
    assert bls_torch._aggregate_pubkeys_affine(pks, "cpu") == _g1_mul(sum(sks))
    assert np.subtract(_counters(), c0).tolist() == [1, 40, 40]
    new_sk = _keys(22, 1)[0]
    pks2 = pks[1:] + [bls_sig.SkToPk(new_sk)]
    assert bls_torch._aggregate_pubkeys_affine(pks2, "cpu") == _g1_mul(sum(sks[1:]) + new_sk)
    assert np.subtract(_counters(), c0).tolist() == [2, 80, 41]
    assert bls_torch._aggregate_pubkeys_affine(pks[:31], "cpu") == _g1_mul(sum(sks[:31]))
    assert np.subtract(_counters(), c0).tolist() == [2, 80, 41]
    bls_torch.clear_caches()
    assert not bls_torch._AGG_CACHE and not bls_torch._PK_VALIDATED


def test_pk_validated_is_a_bounded_fifo(fresh_key_caches, monkeypatch):
    monkeypatch.setattr(bls_torch, "_PK_VALIDATED_MAX", 40)
    _, pks = _committee(23, 40)
    _, pks2 = _committee(24, 32)
    bls_torch._aggregate_pubkeys_affine(pks, "cpu")
    bls_torch._aggregate_pubkeys_affine(pks2, "cpu")
    assert list(bls_torch._PK_VALIDATED) == pks[32:] + pks2


def test_aggregate_pks_on_device_match_host(cpu_shim, fresh_key_caches):
    _, pks = _committee(25, 33)
    c0 = _counters()
    assert bls.AggregatePKs(pks) == bls_sig.AggregatePKs(pks)
    assert np.subtract(_counters(), c0).tolist() == [1, 33, 33]
    cancel = pks[:16] + [oracle.g1_to_bytes(_neg_aff(oracle.g1_from_bytes(pk)))
                         for pk in pks[:16]]
    assert bls.AggregatePKs(cancel) == bls_sig.AggregatePKs(cancel) == oracle.g1_to_bytes(None)
    with pytest.raises(ValueError, match="infinity"):
        bls.AggregatePKs(pks[:32] + [oracle.g1_to_bytes(None)])
    with pytest.raises(ValueError, match="subgroup"):
        bls.AggregatePKs(pks[:32] + [oracle.g1_to_bytes((0, 2))])
    with pytest.raises(ValueError):
        bls_torch.aggregate_pubkeys_device([], "cpu")


def _neg_aff(p):
    return (p[0], (-p[1]) % oracle.P)


def test_fast_aggregate_verify_sums_on_the_device(cpu_shim, fresh_key_caches):
    """A 40-key FastAggregateVerify: the aggregate on the device path, then
    the check; a key outside the subgroup makes the check fail."""
    sks, pks = _committee(26, 40)
    msg = b"committee root"
    sig = bls_sig.Sign(sum(sks) % oracle.R, msg)
    c0 = _counters()
    check = bls_torch.make_fast_aggregate_check(pks, msg, sig, device="cpu")
    assert check.p1 == _g1_mul(sum(sks))
    assert np.subtract(_counters(), c0).tolist() == [1, 40, 40]
    assert bls.FastAggregateVerify(pks, msg, sig) is True
    assert bls.FastAggregateVerify(pks[:39] + [oracle.g1_to_bytes((0, 2))], msg, sig) is False
