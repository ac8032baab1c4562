"""The group programs of K9 and K11 (consensus_specs_tpu_torch/ops/
bls12_programs.py, run on the card by csrc/bls_group.cuh), played over the
plain fields on the CPU:
- the committed csrc/bls_programs.cuh is the generator's output, and every
  program keeps the rules the kernels rely on (a round reads only slots
  written before it and writes none it reads, at most G products a round,
  slots and terms within the job records);
- one Miller iteration (`miller_dbl`: the doubling step, f squared, the
  line product; `miller_add`: the mixed addition and its line product)
  equals ops/bls12.py's one-unit plain functions bit for bit, in limb words
  and in RNS residues, over 8 seeded pairs and the edge states, and the
  limb one equals the JAX package's functions;
- K9's curve double and complete add as their groups run them (the add's
  case selects included: infinity on either side, equal points, opposite
  points) equal `jac_double` and `jac_add`, over G2 in both fields and G1
  under RNS, and so do a whole ladder and (RNS) a whole Miller loop.
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
from consensus_specs_tpu_torch.ops import bls12_programs as G
from consensus_specs_tpu_torch.ops import fp

CSRC = Path(__file__).resolve().parent.parent / "consensus_specs_tpu_torch" / "csrc"
F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % fp.P for _ in range(n)]


def _mont(rng, shape):
    n = int(np.prod(shape))
    return torch.from_numpy(fp.ints_to_mont_words(_ints(rng, n))).reshape(*shape, fp.NWORDS)


def _miller_state(seed):
    """8 seeded (f, T, Q, P) and 4 edge states: P = (0, 0), Q = (0, 0), T at
    Z = 0, f = 1 (the loop's start, T = (Q, 1))."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**62, 12, dtype=np.int64)]
    q = B.g2_to_words([hash_to_curve_g2(b"programs %d" % i) for i in range(12)])
    p = B.g1_to_words([oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k)) for k in ks])
    f, T = _mont(rng, (12, 12)), _mont(rng, (12, 3, 2))
    p[8] = 0
    q[9] = 0
    T[10, 2] = 0
    f[11] = B.f12_to_words([oracle.F12_ONE])[0]
    T[11, :2], T[11, 2] = q[11], B.g2_to_words([((1, 0), (1, 0))])[0, 0]
    return f, T, q, p


def _rns(*ts):
    return tuple(convert.rns_from_words(t) for t in ts)


def _plain_step(step, f, T, q, p):
    """ops/bls12.py's one-unit functions over the plain field of the
    words."""
    F = B.word_field(q.shape[-1])
    fl, Tl, ql, pl = (F.to_plain(t) for t in (f, T, q, p))
    f6 = fl.reshape(f.shape[0], 6, 2, -1)
    if step == "dbl":
        T3, (l0, l3, l5) = B._dbl_step(Tl, pl[:, 0], pl[:, 1])
        f6 = B.f12_sqr(f6)
    else:
        T3, (l0, l3, l5) = B._add_step(Tl, ql, pl[:, 0], pl[:, 1])
    out = B.f12_mul_sparse035(f6, l0, l3, l5)
    return F.from_plain(out).reshape(f.shape), F.from_plain(T3).reshape(T.shape)


def test_programs_header_is_generated():
    assert (CSRC / "bls_programs.cuh").read_text() == G.cuda_programs_header()


_FAMILIES = [(fam, field) for _, fam, field in G.FAMILIES]


@pytest.mark.parametrize("family,field", _FAMILIES)
@pytest.mark.parametrize("kind", ["dbl", "add"])
def test_program_rounds_keep_the_kernels_rules(family, field, kind):
    """What csrc/bls_group.cuh relies on: a round's jobs read slots written
    in earlier rounds (or the step's inputs) and write slots no job of the
    round reads; a product round holds at most G jobs; slots, terms and
    coefficients fit the job records; the layout's fixed slots come first."""
    prog = G.family_programs(family, field)[kind]
    layout = G.MILLER_LAYOUT if family == "miller" else G.curve_layout(family == "g2")
    assert prog.group == G.GROUPS[f"{family}_{field}"] and prog.slots <= 256
    written = set(range(len(layout)))
    for r in prog.rounds:
        reads, writes = set(), set()
        for job in r.jobs:
            terms = job[1] + job[2] if r.kind == G.MUL else job[1]
            reads |= {s for s, _ in terms}
            writes.add(job[0])
            if r.kind == G.LIN:
                assert all(0 < abs(c) <= G.MAX_COEFF for _, c in job[1])
            else:
                assert all(c in (1, -1) for _, c in terms) and job[1][0][1] == job[2][0][1] == 1
        assert reads <= written and not reads & writes and len(writes) == len(r.jobs)
        assert r.kind == G.LIN or len(r.jobs) <= prog.group
        assert r.nterms == max(len(t) for j in r.jobs for t in (j[1:] if r.kind == G.MUL
                                                                else j[1:2]))
        written |= writes
    products = {"miller": {"dbl": 114, "add": 83}, "g2": {"dbl": 18, "add": 44},
                "g1": {"dbl": 7, "add": 16}}
    assert prog.products == products[family][kind]


@pytest.mark.parametrize("field", ["limb", "rns"])
@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_iteration_equals_the_one_unit_functions(field, step):
    state = _miller_state(20 if step == "dbl" else 21)
    if field == "rns":
        state = _rns(*state)
    got = G.miller_step_mirror(step, *state)
    want = _plain_step(step, *state)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_miller_dbl_iteration_equals_jax():
    """The limb doubling iteration against the JAX package's `_dbl_step`,
    `f12_sqr` and `f12_mul_sparse035` on its limb backend."""
    f, T, q, p = _miller_state(22)
    K.set_field_backend("limb")
    try:
        jT = tuple(convert.f2_to_jax(T[:, k]) for k in range(3))
        jT3, (l0, l3, l5) = K._dbl_step(jT, convert.fp_to_jax_limbs(p[:, 0]),
                                        convert.fp_to_jax_limbs(p[:, 1]))
        jf = K.f12_mul_sparse035(K.f12_sqr(convert.f12_to_jax(f)), l0, l3, l5)
    finally:
        K.set_field_backend("rns")
    got_f, got_T = G.miller_step_mirror("dbl", f, T, q, p)
    assert torch.equal(got_f, convert.f12_from_jax(jf))
    assert torch.equal(got_T, torch.stack([convert.f2_from_jax(c) for c in jT3], 1))


def _points(g2, seed, n):
    """n seeded Jacobian points with Z != 1 (affine oracle points rescaled)
    as words."""
    rng = np.random.default_rng(seed)
    F = F2 if g2 else F1
    gen = oracle.G2_GEN if g2 else oracle.G1_GEN
    out = []
    for k in rng.integers(1, 2**62, n, dtype=np.int64):
        x, y = oracle.pt_to_affine(F, oracle.pt_mul(F, gen, int(k)))
        lam = (int(k) % 1000 + 2, 3) if g2 else int(k) % 1000 + 2
        l2 = F.mul(lam, lam)
        out.append((F.mul(x, l2), F.mul(y, F.mul(l2, lam)), lam))
    return out


def _jac_words(points, g2):
    flat = [c for pt in points for coord in pt for c in (coord if g2 else (coord,))]
    return torch.from_numpy(fp.ints_to_mont_words(flat)).reshape(
        len(points), 3, *((2,) if g2 else ()), fp.NWORDS)


_CURVES = [("g2", "limb"), ("g2", "rns"), ("g1", "rns")]


def _curve_words(curve, field, words):
    return _rns(words)[0] if field == "rns" else words


@pytest.mark.parametrize("curve,field", _CURVES)
def test_group_double_equals_jac_double(curve, field):
    g2 = curve == "g2"
    pts = _jac_words(_points(g2, 23, 8), g2)
    pts[7, 2] = 0  # infinity stays at Z = 0
    pts = _curve_words(curve, field, pts)
    F = B.word_field(pts.shape[-1])
    want = F.from_plain(B.jac_double(B._Fp2 if g2 else B._Fp, F.to_plain(pts)))
    assert torch.equal(G.jac_double_mirror(pts, g2), want.reshape(pts.shape))


@pytest.mark.parametrize("curve,field", _CURVES)
def test_group_complete_add_equals_jac_add(curve, field):
    """Generic pairs, infinity on either side and both, equal points with
    other coordinates (the add doubles), opposite points (Z = 0 with the
    add's X, Y), and a point plus itself."""
    g2 = curve == "g2"
    F = F2 if g2 else F1
    a, b, c, d = _points(g2, 24, 4)
    lam = (5, 7) if g2 else 5
    l2 = F.mul(lam, lam)
    a_scaled = (F.mul(a[0], l2), F.mul(a[1], F.mul(l2, lam)), F.mul(a[2], lam))
    neg_a = (a[0], F.neg(a[1]), a[2])
    zero = ((0, 0), (0, 0), (0, 0)) if g2 else (0, 0, 0)
    left = [a, c, zero, a, zero, a, a, a, b]
    right = [b, d, a, zero, zero, a_scaled, neg_a, a, c]
    p1, p2 = (_curve_words(curve, field, _jac_words(pts, g2)) for pts in (left, right))
    Fw = B.word_field(p1.shape[-1])
    want = Fw.from_plain(B.jac_add(B._Fp2 if g2 else B._Fp, Fw.to_plain(p1), Fw.to_plain(p2)))
    assert torch.equal(G.jac_add_mirror(p1, p2, g2), want.reshape(p1.shape))


def test_miller_loop_as_the_group_runs_it_equals_the_plain_loop():
    """K11's whole loop as its group runs it (the slots' start, the 63
    iterations' programs, the conjugate's rows), RNS residues, one pair."""
    _, _, q, p = _rns(*_miller_state(25))
    assert torch.equal(G.miller_loop_mirror(q[:1], p[:1]), B.miller_loop_plain(q[:1], p[:1]))


@pytest.mark.parametrize("curve,field", _CURVES)
def test_group_ladder_equals_the_plain_ladder(curve, field):
    """K9's ladder as its group runs it (the table, the top window, the
    windows' doubles and complete adds) against the plain ladder, at a z
    with a zero top window and every other digit 3."""
    g2 = curve == "g2"
    _, _, q, p = _miller_state(26)
    pts = _curve_words(curve, field, q[:1] if g2 else p[:1])
    zb = zbits_from_ints([(1 << 62) - 1])
    g1, g2j = B.rlc_ladders_plain(None if g2 else pts, pts if g2 else None, zb, affine_g1=False)
    assert torch.equal(G.ladder_mirror(pts, zb, g2), g2j if g2 else g1)
