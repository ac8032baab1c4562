"""The randomized batch check of the port's "rns" field backend
(consensus_specs_tpu_torch/ops/bls12_field.py `pairing_check_rlc`, on the CPU
over the plain version of K24) on its three shapes: plain (a general second
pairing), collapsed (every P2 is -G1: one G2 sum) and grouped by message
(D + 1 Miller loops), each on valid checks and with one bad item, with fixed
scalars. The verdicts are the oracle's: a batch of valid signatures passes,
a batch with a wrong signature fails.

The scalars are 16 bits wide but in one case (the flush's 64): a plain
window ladder costs seconds on the CPU, and its windows do not depend on the
width. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch.ops import bls12_field as BF
from consensus_specs_tpu_torch.ops import fp_rns as R

P = R.P
F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
NEG_G1 = (oracle.G1_GEN_AFF[0], (-oracle.G1_GEN_AFF[1]) % P)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _fp(values):
    return torch.from_numpy(R.ints_to_mont_batch(values))


def _g1(pts):
    return _fp([p[0] for p in pts]), _fp([p[1] for p in pts])


def _g2(pts):
    return ((_fp([p[0][0] for p in pts]), _fp([p[0][1] for p in pts])),
            (_fp([p[1][0] for p in pts]), _fp([p[1][1] for p in pts])))


def _signed(seed, n, messages):
    """n (pk, H(m), sig) over `messages` distinct messages, item i signing
    message i % messages."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)]
    hs = [hash_to_curve_g2(b"rlc %d %d" % (seed, i % messages)) for i in range(n)]
    pks = [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k)) for k in ks]
    sigs = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
            for h, k in zip(hs, ks)]
    return pks, hs, sigs


def _zbits(zs, nbits):
    return torch.tensor([[(z >> i) & 1 for i in range(nbits)] for z in zs], dtype=torch.bool)


@pytest.mark.parametrize("case", ["valid", "bad"])
@pytest.mark.parametrize("shape", ["plain", "collapsed", "grouped"])
def test_pairing_check_rlc_shapes(shape, case):
    n = 4
    messages = 2 if shape == "grouped" else n
    pks, hs, sigs = _signed({"plain": 1, "collapsed": 2, "grouped": 3}[shape], n, messages)
    if case == "bad":
        sigs[2] = sigs[3]  # item 2 carries another key's signature
    if shape == "collapsed" and case == "valid":  # the flush's width
        zb = _zbits([1, 2**64 - 1, 0x9E3779B97F4A7C15, 0x0123456789ABCDEF], 64)
    else:
        zb = _zbits([1, 0xFFFF, 0x9E37, 0x1234], 16)
    q2, p2 = _g2(sigs), _g1([NEG_G1] * n)
    loops = BF.miller_loop_items
    if shape == "grouped":
        q1 = _g2(hs[:messages])
        seg = torch.tensor([i % messages for i in range(n)])
        ok = BF.pairing_check_rlc(*q1, *_g1(pks), *q2, None, None, zb, p2_is_neg_g1=True,
                                  seg_ids=seg)
        want_loops = messages + 1
    else:
        ok = BF.pairing_check_rlc(*_g2(hs), *_g1(pks), *q2, *p2, zb,
                                  p2_is_neg_g1=shape == "collapsed")
        want_loops = n + 1 if shape == "collapsed" else 2 * n
    assert ok.shape == () and bool(ok) == (case == "valid")
    assert BF.miller_loop_items - loops == want_loops


def test_stages_against_the_oracle():
    """Stage 1 ([z]·P affine) and stage 2 (sum of [z]·Q affine) equal the
    oracle's points."""
    pks, hs, sigs = _signed(4, 2, 2)
    zs = [0x1234, 0xBEEF]
    zb = _zbits(zs, 16)
    ax, ay = BF.rlc_randomize_g1(*_g1(pks), zb)
    for i, (pk, z) in enumerate(zip(pks, zs)):
        want = oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.pt_from_affine(F1, pk), z))
        assert (R.mont_batch_to_ints(ax[i])[0], R.mont_batch_to_ints(ay[i])[0]) == want
    qx, qy = BF.rlc_collapse_g2(*_g2(sigs), zb)
    acc = None
    for sig, z in zip(sigs, zs):
        acc = oracle.pt_add(F2, acc, oracle.pt_mul(F2, oracle.pt_from_affine(F2, sig), z))
    got = tuple(tuple(R.mont_batch_to_ints(c)[0] for c in coord) for coord in (qx, qy))
    assert got == oracle.pt_to_affine(F2, acc)
