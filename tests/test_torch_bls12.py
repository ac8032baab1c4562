"""The port's BLS12-381 towers, curves, pairing and randomized batch check
(consensus_specs_tpu_torch/ops/bls12.py; on the CPU the plain versions of
kernels K9-K12).

- Towers and the Miller loop's steps: bit-equal to the JAX package's
  (consensus_specs_tpu/ops/bls12_jax.py) on its limb field backend, set in a
  fixture that restores the default "rns" (the backend is module state, and a
  worker keeps its process across files).
- Curves, ladders, pairings and both randomized-check paths: against the
  pure-Python oracle the JAX kernels are themselves tested against
  (compiling JAX's pairing programs on the CPU takes minutes), with fixed
  zbits, bad items, the complete add's degenerate cases and an empty
  segment. A `slow` test holds the port against the JAX functions directly.
Inputs are made from numpy seeds; every comparison is exact.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto.bls_torch import zbits_from_ints
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import fp

P = fp.P
F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
CSRC = Path(__file__).resolve().parent.parent / "consensus_specs_tpu_torch" / "csrc"


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
def limb_backend():
    K.set_field_backend("limb")
    yield
    K.set_field_backend("rns")


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _mont_words(values, shape):
    return torch.from_numpy(fp.ints_to_mont_words(values)).reshape(*shape, fp.NWORDS)


def _f12(seed, n):
    return _mont_words(_ints(seed, 12 * n), (n, 12))


def _f2(seed, n):
    return _mont_words(_ints(seed, 2 * n), (n, 2))


def _scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % oracle.R or 1 for _ in range(n)]


def _g1(k):
    return oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k))


def _g2_mul(q, k):
    return oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, q), k))


def _limbs12(w):
    return B._f12_limbs(w)


# --- towers against JAX's limb backend -------------------------------------------


F2_OPS = {
    "add": (lambda x, y: B.f2_add(x, y), lambda x, y: K.f2_add(x, y)),
    "sub": (lambda x, y: B.f2_sub(x, y), lambda x, y: K.f2_sub(x, y)),
    "mul": (lambda x, y: B.f2_mul(x, y), lambda x, y: K.f2_mul(x, y)),
    "sqr": (lambda x, y: B.f2_sqr(x), lambda x, y: K.f2_sqr(x)),
    "mul_xi": (lambda x, y: B.f2_mul_xi(x), lambda x, y: K.f2_mul_xi(x)),
    "inv": (lambda x, y: B.f2_inv(x), lambda x, y: K.f2_inv(x)),
    "conj": (lambda x, y: B.f2_conj(x), lambda x, y: K.f2_conj(x)),
    "neg": (lambda x, y: B.f2_neg(x), lambda x, y: K.f2_neg(x)),
}


@pytest.mark.parametrize("op", sorted(F2_OPS))
def test_f2_ops_match_jax(limb_backend, op):
    x, y = _f2(1, 6), _f2(2, 6)
    x[0] = 0  # zero (inv maps it to zero)
    x[1, 1] = 0  # a real element
    mine, theirs = F2_OPS[op]
    got = fp.to_words(mine(fp.to_limbs(x), fp.to_limbs(y)))
    want = convert.f2_from_jax(theirs(convert.f2_to_jax(x), convert.f2_to_jax(y)))
    assert torch.equal(got, want)


def _unitary(seed, n):
    """Easy-part outputs f^((p^6 - 1)(p^2 + 1)) of random f (oracle)."""
    out = []
    for f in B.f12_from_words(_f12(seed, n)):
        f = oracle.f12_mul(oracle.f12_conj(f), oracle.f12_inv(f))
        out.append(oracle.f12_mul(oracle.f12_frobenius(f, 2), f))
    return B.f12_to_words(out)


F12_OPS = {
    "mul": (lambda x, y: B.f12_mul(x, y), lambda x, y: K.f12_mul(x, y)),
    "sqr": (lambda x, y: B.f12_sqr(x), lambda x, y: K.f12_sqr(x)),
    "inv": (lambda x, y: B.f12_inv(x), lambda x, y: K.f12_inv(x)),
    "conj": (lambda x, y: B.f12_conj(x), lambda x, y: K.f12_conj(x)),
    "frobenius": (lambda x, y: B.f12_frobenius(x), lambda x, y: K.f12_frobenius(x)),
    "frobenius2": (lambda x, y: B.f12_frobenius2(x), lambda x, y: K.f12_frobenius2(x)),
    "cyclotomic_sqr": (lambda x, y: B.f12_cyclotomic_sqr(x),
                       lambda x, y: K.f12_cyclotomic_sqr(x)),
    "sparse035": (lambda x, y: B.f12_mul_sparse035(x, y[..., 0, :, :], y[..., 3, :, :],
                                                   y[..., 5, :, :]),
                  lambda x, y: K.f12_mul_sparse035(x, y[0], y[3], y[5])),
}


@pytest.mark.parametrize("op", sorted(F12_OPS))
def test_f12_ops_match_jax(limb_backend, op):
    x = _unitary(3, 3) if op == "cyclotomic_sqr" else _f12(3, 3)
    y = _f12(4, 3)
    mine, theirs = F12_OPS[op]
    got = B._f12_words(mine(_limbs12(x), _limbs12(y)))
    want = convert.f12_from_jax(theirs(convert.f12_to_jax(x), convert.f12_to_jax(y)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["mul", "inv"])
def test_f6_ops_match_jax(limb_backend, op):
    x, y = _f2(5, 6).reshape(2, 3, 2, 12), _f2(6, 6).reshape(2, 3, 2, 12)

    def jax6(w):
        return tuple(convert.f2_to_jax(w[:, k]) for k in range(3))

    if op == "mul":
        got = B.f6_mul(fp.to_limbs(x), fp.to_limbs(y))
        want = K._f6_mul(jax6(x), jax6(y))
    else:
        got = B.f6_inv(fp.to_limbs(x))
        want = K._f6_inv(jax6(x))
    assert torch.equal(fp.to_words(got), torch.stack([convert.f2_from_jax(c) for c in want], 1))


def test_f12_is_one_matches_jax(limb_backend):
    x = _f12(7, 3)
    x[1] = B.f12_to_words([oracle.F12_ONE])[0]
    got = B.f12_is_one(_limbs12(x))
    assert got.tolist() == np.asarray(K.f12_is_one(convert.f12_to_jax(x))).tolist()
    assert got.tolist() == [False, True, False]


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_steps_match_jax(limb_backend, step):
    """The Jacobian T and the scaled line of one Miller doubling / mixed
    addition, bit-equal to JAX's: what makes the Miller output equal."""
    T = _f2(8, 9).reshape(3, 3, 2, 12)  # three random Jacobian points on no curve
    Q = _f2(9, 6).reshape(3, 2, 2, 12)
    Pt = _mont_words(_ints(10, 6), (3, 2))
    jT = tuple(convert.f2_to_jax(T[:, k]) for k in range(3))
    jQ = tuple(convert.f2_to_jax(Q[:, k]) for k in range(2))
    xp, yp = fp.to_limbs(Pt[:, 0]), fp.to_limbs(Pt[:, 1])
    jxp, jyp = convert.fp_to_jax_limbs(Pt[:, 0]), convert.fp_to_jax_limbs(Pt[:, 1])
    if step == "dbl":
        T3, lines = B._dbl_step(fp.to_limbs(T), xp, yp)
        jT3, jlines = K._dbl_step(jT, jxp, jyp)
    else:
        T3, lines = B._add_step(fp.to_limbs(T), fp.to_limbs(Q), xp, yp)
        jT3, jlines = K._add_step(jT, jQ, jxp, jyp)
    assert torch.equal(fp.to_words(T3), torch.stack([convert.f2_from_jax(c) for c in jT3], 1))
    for mine, theirs in zip(lines, jlines):
        assert torch.equal(fp.to_words(mine), convert.f2_from_jax(theirs))


def test_constants_header_is_generated():
    assert (CSRC / "bls_constants.cuh").read_text() == B.cuda_constants_header()


# --- curves against the oracle ------------------------------------------------------


def _jac_words(points, g2):
    """Oracle Jacobian points (None = infinity) -> Jacobian words."""
    out = []
    for pt in points:
        if pt is None:
            out.append(torch.zeros((3, 2, 12) if g2 else (3, 12), dtype=torch.int32))
            continue
        coords = [c for coord in pt for c in (coord if g2 else (coord,))]
        out.append(torch.from_numpy(fp.ints_to_mont_words(coords)).reshape(
            (3, 2, 12) if g2 else (3, 12)))
    return torch.stack(out)


def _affine(words_jac, g2):
    F = B._Fp2 if g2 else B._Fp
    return B.affine_from_words(fp.to_words(B.jac_to_affine(F, fp.to_limbs(words_jac))), g2)


def _rescale(F, pt, lam):
    """The same point with Z scaled by lam: (X lam^2, Y lam^3, Z lam)."""
    x, y, z = pt
    l2 = F.mul(lam, lam)
    return (F.mul(x, l2), F.mul(y, F.mul(l2, lam)), F.mul(z, lam))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_complete_add_cases_match_oracle(group):
    g2 = group == "g2"
    F = F2 if g2 else F1
    gen = oracle.G2_GEN if g2 else oracle.G1_GEN
    lam = (5, 7) if g2 else 5
    a, b = oracle.pt_mul(F, gen, 11), oracle.pt_mul(F, gen, 29)
    cases = [  # (p1, p2): generic, inf + p, p + inf, inf + inf, equal (other Z), opposite
        (a, b), (None, b), (a, None), (None, None), (a, _rescale(F, a, lam)),
        (a, oracle.pt_neg(F, a))]
    p1 = _jac_words([c[0] for c in cases], g2)
    p2 = _jac_words([c[1] for c in cases], g2)
    fn = B.g2_add if g2 else B.g1_add
    out = fp.to_words(fn(fp.to_limbs(p1), fp.to_limbs(p2)))
    want = [oracle.pt_to_affine(F, oracle.pt_add(F, x, y)) for x, y in cases]
    got = _affine(out, g2)
    zero = (0, 0) if not g2 else ((0, 0), (0, 0))
    assert got == [w if w is not None else zero for w in want]
    assert torch.equal(out[1], p2[1]) and torch.equal(out[2], p1[2])  # infinity passes through
    assert int(out[5, 2].abs().sum()) == 0  # opposite points: Z = 0
    dbl = B.g2_double if g2 else B.g1_double
    d = fp.to_words(dbl(fp.to_limbs(p1[:1])))
    assert _affine(d, g2) == [oracle.pt_to_affine(F, oracle.pt_double(F, a))]


def test_ladders_match_oracle():
    """K9's plain version on z = 0, 1, 2, 2^64 - 1 and seeded z: G1 affine
    and Jacobian, G2 Jacobian, against the oracle's scalar multiples."""
    ks = _scalars(11, 6)
    pks = [_g1(k) for k in ks]
    sigs = [_g2_mul(hash_to_curve_g2(b"ladder %d" % i), k) for i, k in enumerate(ks)]
    rng = np.random.default_rng(12)
    zs = [0, 1, 2, 2**64 - 1] + [int(v) for v in rng.integers(1, 2**63, 2, dtype=np.int64)]
    zb = zbits_from_ints(zs)
    a1, j2 = B.rlc_ladders(B.g1_to_words(pks), B.g2_to_words(sigs), zb, affine_g1=True)
    j1, j2b = B.rlc_ladders(B.g1_to_words(pks), None, zb, affine_g1=False)
    assert j2b is None and torch.equal(B.rlc_ladders(None, B.g2_to_words(sigs), zb)[1], j2)
    want1 = [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.pt_from_affine(F1, p), z))
             for p, z in zip(pks, zs)]
    want2 = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, s), z))
             for s, z in zip(sigs, zs)]
    assert B.affine_from_words(a1, False)[1:] == want1[1:]
    assert B.affine_from_words(a1, False)[0] == (0, 0)  # z = 0: infinity
    assert _affine(j1, False) == B.affine_from_words(a1, False)
    assert _affine(j2, True)[1:] == want2[1:]


def test_point_sums_match_oracle():
    """K10's plain version: G1 segments of 3, 0 (empty), 1 and 2 points (a
    point and its negation: infinity); G2 one segment."""
    ks = _scalars(13, 6)
    pts = [oracle.pt_mul(F1, oracle.G1_GEN, k) for k in ks]
    pts[5] = oracle.pt_neg(F1, pts[4])
    off = torch.tensor([0, 3, 3, 4, 6])
    got = B.affine_from_words(B.point_sums(_jac_words(pts, False), off), False)

    def total(seg):
        acc = None
        for p in seg:
            acc = oracle.pt_add(F1, acc, p)
        return oracle.pt_to_affine(F1, acc) or (0, 0)

    assert got == [total(pts[0:3]), (0, 0), total(pts[3:4]), (0, 0)]
    qs = [oracle.pt_mul(F2, oracle.G2_GEN, k) for k in ks[:3]]
    acc = None
    for q in qs:
        acc = oracle.pt_add(F2, acc, q)
    got2 = B.point_sums(_jac_words(qs, True), torch.tensor([0, 3]))
    assert B.affine_from_words(got2, True) == [oracle.pt_to_affine(F2, acc)]


# --- pairings and the randomized check against the oracle ---------------------------


def _signed(n, seed, messages):
    """n (pk, H(m), sig) with message i % messages."""
    ks = _scalars(seed, n)
    hs = [hash_to_curve_g2(b"message %d" % (i % messages)) for i in range(n)]
    return [_g1(k) for k in ks], hs, [_g2_mul(h, k) for h, k in zip(hs, ks)]


def test_pairing_cube_batch_matches_oracle():
    ps = [oracle.G1_GEN_AFF, _g1(_scalars(14, 1)[0])]
    qs = [oracle.G2_GEN_AFF, hash_to_curve_g2(b"cube")]
    got = B.f12_from_words(B.pairing_cube_batch(B.g2_to_words(qs), B.g1_to_words(ps)))
    for g, p, q in zip(got, ps, qs):
        e = oracle.pairing(q, p)
        assert g == oracle.f12_mul(oracle.f12_sqr(e), e)


def test_pairing_check_batch_flags_the_bad_item():
    pks, hs, sigs = _signed(4, 15, 4)
    sigs[2] = sigs[1]  # a valid signature of another message
    neg = B.neg_g1_words("cpu")[None].expand(4, 2, 12)
    ok = B.pairing_check_batch(B.g2_to_words(hs), B.g1_to_words(pks), B.g2_to_words(sigs), neg)
    assert ok.tolist() == [True, True, False, True]


@pytest.mark.parametrize("case", ["valid", "bad"])
def test_rlc_ungrouped_matches_oracle(case):
    pks, hs, sigs = _signed(4, 16, 4)
    if case == "bad":
        sigs[3] = _g2_mul(hs[3], 2)
    zb = zbits_from_ints([3, 2**64 - 1, 12345678901234567, 2**40 + 1])
    before = B.miller_loop_items
    ok = B.pairing_check_rlc(B.g2_to_words(hs), B.g1_to_words(pks), B.g2_to_words(sigs), zb)
    assert bool(ok) == (case == "valid")
    assert B.miller_loop_items - before == 4 + 1


@pytest.mark.parametrize("case", ["valid", "bad", "empty_segment"])
def test_rlc_grouped_matches_oracle(case):
    """D = 3 messages over 6 items: D + 1 Miller loops; a bad signature
    fails, and so does a batch with an empty segment (valid items, a fourth
    message with no member: infinity, failing closed)."""
    pks, hs, sigs = _signed(6, 17, 3)
    seg = torch.tensor([0, 1, 2, 0, 1, 2])
    reps = hs[:3]
    if case == "bad":
        sigs[4] = sigs[3]
    if case == "empty_segment":
        reps = reps + [hash_to_curve_g2(b"no member")]
    zb = zbits_from_ints([5, 7, 2**63, 99, 2**64 - 2, 1])
    before = B.miller_loop_items
    ok = B.pairing_check_rlc(B.g2_to_words(reps), B.g1_to_words(pks), B.g2_to_words(sigs),
                             zb, seg)
    assert bool(ok) == (case == "valid")
    assert B.miller_loop_items - before == len(reps) + 1


def test_affine_infinity_operands():
    """Why the grouped check counts its segments: P = (0, 0), the affine
    image of an empty segment's sum, pairs to 1 with any Q (every line is
    l3·w^3, so the Miller value lies in Fp4 and the easy part kills it),
    while Q = (0, 0) (a collapsed signature sum at infinity) gives 0."""
    q = B.g2_to_words([hash_to_curve_g2(b"any")])
    zero_p = torch.zeros((1, 2, 12), dtype=torch.int32)
    zero_q = torch.zeros((1, 2, 2, 12), dtype=torch.int32)
    cube, ok = B.final_exp_batch(B.miller_loop(torch.cat([q, zero_q]),
                                               torch.cat([zero_p, B.g1_to_words([_g1(5)])])))
    assert ok.tolist() == [True, False]
    assert int(cube[1].abs().sum()) == 0


def test_rlc_stage_helpers_and_miller_count():
    pks, hs, sigs = _signed(3, 18, 3)
    zb = zbits_from_ints([2, 3, 4])
    a1 = B.rlc_randomize_g1(B.g1_to_words(pks), zb)
    assert B.affine_from_words(a1, False) == [
        oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.pt_from_affine(F1, p), z))
        for p, z in zip(pks, (2, 3, 4))]
    acc = None
    for s, z in zip(sigs, (2, 3, 4)):
        acc = oracle.pt_add(F2, acc, oracle.pt_mul(F2, oracle.pt_from_affine(F2, s), z))
    aq = B.rlc_collapse_g2(B.g2_to_words(sigs), zb)
    assert B.affine_from_words(aq, True) == [oracle.pt_to_affine(F2, acc)]
    by_msg = B.rlc_collapse_g1_by_message(B.g1_to_words(pks), zb, torch.tensor([1, 0, 1]), 2)
    want = [oracle.pt_mul(F1, oracle.pt_from_affine(F1, p), z) for p, z in zip(pks, (2, 3, 4))]
    assert B.affine_from_words(by_msg, False) == [
        oracle.pt_to_affine(F1, want[1]), oracle.pt_to_affine(F1, oracle.pt_add(F1, want[0],
                                                                             want[2]))]
    m = torch.zeros((5, 12, 12), dtype=torch.int32)
    assert B.rlc_miller_loop_count(m, m[0]) == 6


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        B.miller_loop(torch.zeros((2, 2, 2, 12), dtype=torch.int32),
                      torch.zeros((3, 2, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        B.rlc_ladders(torch.zeros((2, 2, 12), dtype=torch.int32), None,
                      torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        B.point_sums(torch.zeros((2, 3, 12), dtype=torch.int32), torch.tensor([0, 2.0]))
    with pytest.raises(ValueError):
        B.final_exp_tail(torch.zeros((2, 12, 12), dtype=torch.int32),
                         torch.zeros((12, 11), dtype=torch.int32))


# --- against the JAX functions directly (compiles JAX's pairing programs) -------------


@pytest.mark.slow
def test_pairing_programs_match_jax(limb_backend):
    """`miller_loop_batch`, `pairing_cube_batch` and both `pairing_check_rlc`
    paths of the JAX package (limb backend) against the port's, exactly."""
    pks, hs, sigs = _signed(4, 19, 2)
    q, p, s = B.g2_to_words(hs), B.g1_to_words(pks), B.g2_to_words(sigs)
    jq = tuple(convert.f2_to_jax(q[:, k]) for k in range(2))
    jp = tuple(convert.fp_to_jax_limbs(p[:, k]) for k in range(2))
    m = B.miller_loop(q, p)
    assert torch.equal(m, convert.f12_from_jax(K.miller_loop_batch(*jq, *jp)))
    assert torch.equal(B.pairing_cube_batch(q, p),
                       convert.f12_from_jax(K.pairing_cube_batch(*jq, *jp)))
    zs = [9, 2**64 - 1, 77, 2**33]
    zbits = np.array([[(z >> i) & 1 for i in range(64)] for z in zs], dtype=bool)
    ngx, ngy = K._neg_g1_affine_mont()
    n2x, n2y = np.broadcast_to(ngx, jp[0].shape), np.broadcast_to(ngy, jp[1].shape)
    for bad in (False, True):
        s2 = s.clone()
        if bad:
            s2[1] = s[0]
        js2 = tuple(convert.f2_to_jax(s2[:, k]) for k in range(2))
        want = bool(K.pairing_check_rlc(*jq, *jp, *js2, n2x, n2y, zbits, p2_is_neg_g1=True))
        assert bool(B.pairing_check_rlc(q, p, s2, zbits_from_ints(zs))) == want == (not bad)
        seg = np.array([0, 1, 0, 1], dtype=np.int32)
        jr = tuple((a[:2], b[:2]) for a, b in jq)
        want = bool(K.pairing_check_rlc(jr[0], jr[1], *jp, *js2, None, None, zbits,
                                        p2_is_neg_g1=True, seg_ids=seg))
        got = B.pairing_check_rlc(q[:2], p, s2, zbits_from_ints(zs), torch.from_numpy(seg))
        assert bool(got) == want == (not bad)
