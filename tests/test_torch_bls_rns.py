"""The port's BLS flush under the "rns" field backend
(ops/bls12.set_field_backend("rns"): crypto/bls_torch.py packs RNS residues
and runs ops/bls12.py's checks, on the CPU their plain version over the
plain version of K24):
- its packing equals the JAX package's under JAX's default (RNS) field, and
  the limb packing carried across (`engine/convert.rns_from_words`);
- `run_checks` and the shim give the "limb" backend's verdicts on the same
  checks, a bad one named;
- the randomized grouped path records the flush as the limb path does
  (path, items, distinct, D + 1 Miller loops, counted by ops/bls12.py) and
  never runs ops/bls12_field.py (JAX's towers line for line, kept as their
  mirror).
Inputs come from numpy seeds; comparisons are exact.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls_jax
from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu_torch.crypto import bls, bls_sig, bls_torch
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import bls12_field as BF
from consensus_specs_tpu_torch.utils import bucketing

F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def field():
    """Select the port's flush field; the default ("limb") is restored."""
    yield B.set_field_backend
    B.set_field_backend("limb")


@pytest.fixture
def cpu_shim():
    saved = (bls.device, bls.bls_active)
    bls.use_device("cpu")
    bls.bls_active = True
    yield bls
    bls.device, bls.bls_active = saved


def _checks(n, messages, seed):
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)]
    out = []
    for i, k in enumerate(ks):
        h = hash_to_curve_g2(b"rns flush %d %d" % (seed, i % messages))
        pk = oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k))
        sig = oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
        out.append(bls_torch.QueuedCheck(pk, h, bls_torch._NEG_G1, sig))
    return out


def _cols(checks):
    return tuple([getattr(c, k) for c in checks] for k in ("p1", "q1", "p2", "q2"))


def test_rns_packing_matches_jax_and_the_limb_packing(field):
    checks = _checks(5, 5, 1)
    saved = K.field_backend()
    K.set_field_backend("rns")
    try:
        b_j, args_j = bls_jax._pack_pairing_args(*_cols(checks))
    finally:
        K.set_field_backend(saved)
    b_l, limb = bls_torch._pack_pairing_args(*_cols(checks), "cpu")
    field("rns")
    b, (q1, p1, q2, p2) = bls_torch._pack_pairing_args(*_cols(checks), "cpu")
    assert b == b_j == b_l == 8 and q1.shape == (8, 2, 2, 64) and p1.shape == (8, 2, 64)
    qx, qy, px, py, q2x, q2y, p2x, p2y = args_j
    mine = (*BF.g2_pair(q1), *BF.g1_pair(p1), *BF.g2_pair(q2), *BF.g1_pair(p2))
    theirs = (qx, qy, px, py, q2x, q2y, p2x, p2y)

    def flat(v):
        return [t for c in v for t in flat(c)] if isinstance(v, tuple) else [v]

    for m, t in zip(flat(mine), flat(theirs)):
        assert np.array_equal(convert.rns_to_jax(m), np.asarray(t))
    for m, w in zip((q1, p1, q2, p2), limb):
        assert torch.equal(convert.rns_from_words(w), m)


def test_zbits_to_bits_is_jax_form():
    zs = [1, 2**64 - 1, 0x8000000000000001, 0x0123456789ABCDEF]
    got = BF.zbits_to_bits(bls_torch.zbits_from_ints(zs))
    assert got.dtype == torch.bool and got.shape == (4, 64)
    assert got.tolist() == [[bool((z >> i) & 1) for i in range(64)] for z in zs]


def test_grouped_rns_check_fails_an_empty_segment(monkeypatch):
    """The grouped check on the "rns" backend's 64-residue values decides
    C2's rule as on limbs: a segment without a member fails the batch whatever the pairing
    product says (the product is stubbed to pass here, so only the rule
    decides), and full segments leave the product's verdict."""
    calls = []

    def product_passes(m1, m2_single):
        calls.append(m1.shape[0])
        return torch.tensor(True)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    # the stages stubbed with zeros of their shapes: only the rule decides
    monkeypatch.setattr(B, "rlc_ladders", lambda p, q, z, affine_g1=True: (
        zeros(p.shape[0], 3, 64), zeros(q.shape[0], 3, 2, 64)))
    monkeypatch.setattr(B, "point_sums", lambda pts, off: zeros(off.shape[0] - 1, 2,
                                                                *pts.shape[2:]))
    monkeypatch.setattr(B, "miller_loop", lambda q, p: zeros(q.shape[0], 12, 64))
    monkeypatch.setattr(B, "rlc_tail", product_passes)
    q1, p1, q2 = zeros(3, 2, 2, 64), zeros(4, 2, 64), zeros(4, 2, 2, 64)
    zbits = torch.ones(4, 2, dtype=torch.int32)
    assert bool(B.pairing_check_rlc(q1, p1, q2, zbits, torch.tensor([0, 1, 2, 0])))
    assert not bool(B.pairing_check_rlc(q1, p1, q2, zbits, torch.tensor([0, 1, 1, 0])))
    assert calls == [3, 3]


def test_run_checks_gives_the_limb_verdicts(field):
    """The per-item path (fewer than RLC_MIN_BATCH checks) on both fields."""
    checks = _checks(4, 4, 2)
    checks[1] = bls_torch.QueuedCheck(checks[1].p1, checks[1].q1, checks[1].p2, checks[2].q2)
    checks.append(None)
    limb = bls_torch.run_checks(checks, "cpu")
    field("rns")
    loops, mirror_loops = B.miller_loop_items, BF.miller_loop_items
    got = bls_torch.run_checks(checks, "cpu")
    assert got.tolist() == limb.tolist() == [True, False, True, True, False]
    assert B.miller_loop_items - loops == 16 and BF.miller_loop_items == mirror_loops


def test_grouped_flush_records_as_the_limb_path(field):
    field("rns")
    checks = _checks(16, 4, 3)
    plan = bucketing.grouped_plan([c.q1 for c in checks], 8)
    loops, mirror_loops = B.miller_loop_items, BF.miller_loop_items
    assert bls_torch.run_checks(checks, "cpu").all()
    assert dict(bls_torch.LAST_FLUSH) == dict(path="rlc_grouped", items=plan.b_n,
                                              distinct=plan.b_d, miller_loops=plan.b_d + 1)
    assert B.miller_loop_items - loops == plan.b_d + 1 and BF.miller_loop_items == mirror_loops


def test_shim_under_rns_flushes_once_and_names_the_bad_call(cpu_shim, field):
    field("rns")
    sks = [7, 8, 9]
    msgs = [b"shim rns %d" % i for i in range(3)]
    pks = [bls_sig.SkToPk(k) for k in sks]
    sigs = [bls_sig.Sign(k, m) for k, m in zip(sks, msgs)]
    flushes = bls.flush_count
    with pytest.raises(bls.BLSVerificationError, match=r"\[1\]"):
        with bls.deferred_verification():
            assert bls.Verify(pks[0], msgs[0], sigs[0])
            bls.Verify(pks[1], msgs[1], sigs[2])
            assert bls.FastAggregateVerify([pks[2]], msgs[2], sigs[2])
    assert bls.flush_count == flushes + 1
