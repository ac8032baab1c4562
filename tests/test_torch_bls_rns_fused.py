"""The BLS flush's "rns" configuration on fused kernels, on the CPU: the RNS
plain version of K9-K12 (ops/bls12.py's plain towers, curves and pairing
over the plain version of K24, ops/fp_rns.rns_ops_plain), which the
card-only tests (tests/test_torch_cuda.py) hold bit-equal to the kernels'
RNS instances:
- every Montgomery reduction of one Miller loop, one final exponentiation,
  one G1 and one G2 ladder and a 3-point segment sum, at a batch of 2, lies
  inside the windows csrc/fp_rns.cuh states (`fp_rns.check_windows`);
- the Miller loop's doubling and addition steps and the Fp12 operations
  equal JAX's on its default (RNS) field mod p, the ladders the oracle's
  points;
- the Miller loop and the final exponentiation give the oracle's pairing
  cube, and the final exponentiation of a random value the oracle's, cubed;
- `pairing_check_rlc` (ungrouped and grouped) and `pairing_check_batch` give
  the limb plain version's verdicts, valid and with a bad signature.
Equality with JAX and the oracle is mod p (the RNS values are redundant);
verdicts are exact. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto.bls_torch import zbits_from_ints
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import fp_rns as R

P = R.P
F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def rns_backend():
    """JAX's default field, whatever another test file left selected."""
    saved = K.field_backend()
    K.set_field_backend("rns")
    yield
    K.set_field_backend(saved)


def _items(n, messages, seed):
    """n (pk, H(m), sig) as oracle points over `messages` messages."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)]
    hs = [hash_to_curve_g2(b"rns fused %d %d" % (seed, i % messages)) for i in range(n)]
    pks = [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k)) for k in ks]
    sigs = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
            for h, k in zip(hs, ks)]
    return pks, hs, sigs


def _words(pks, hs, sigs):
    """Limb Montgomery words (pk (n, 2, 12), H(m) and sig (n, 2, 2, 12))."""
    return B.g1_to_words(pks), B.g2_to_words(hs), B.g2_to_words(sigs)


def _rns(*ts):
    return tuple(convert.rns_from_words(t) for t in ts)


def _ints(t) -> list:
    return R.mont_batch_to_ints(t)


def _cube(e):
    return oracle.f12_mul(oracle.f12_sqr(e), e)


def _f12_values(f) -> list:
    """(n, 6, 2, 64) residues -> oracle Fp12 tuples."""
    ints = _ints(f)
    return [tuple((ints[i + 2 * k], ints[i + 2 * k + 1]) for k in range(6))
            for i in range(0, len(ints), 12)]


def test_reductions_stay_inside_the_windows():
    """One Miller loop, one final exponentiation, a G1 and a G2 ladder and a
    3-point segment sum at a batch of 2, every reduction checked; the
    results are the oracle's."""
    pks, hs, sigs = _items(3, 3, 1)
    p, q, s = _rns(*_words(pks, hs, sigs))
    zb = zbits_from_ints([2**64 - 1, 12345678901])
    before = R.window_checks
    with R.check_windows():
        m = B.miller_loop_plain(q[:2], p[:2])
        cube, ok = B.final_exp_batch_plain(m[:1], m[1:])
        g1, g2 = B.rlc_ladders_plain(p[:2], s[:2], zb, affine_g1=False)
        total = B.point_sums_plain(torch.cat([g1, g1[:1]]), torch.tensor([0, 3]))
    assert R.window_checks - before > 2 * 7_000
    e0, e1 = (oracle.pairing(h, pk) for h, pk in zip(hs[:2], pks[:2]))
    assert _f12_values(cube) == [_cube(oracle.f12_mul(e0, e1))] and not bool(ok[0])
    z = [2**64 - 1, 12345678901]
    k = [int(v) for v in np.random.default_rng(1).integers(1, 2**62, 3, dtype=np.int64)]
    want = oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, (2 * z[0] * k[0]
                                                                     + z[1] * k[1]) % oracle.R))
    assert tuple(_ints(total[0])) == want
    zs = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, sg), zi))
          for sg, zi in zip(sigs[:2], z)]
    for i in range(2):
        X, Y, Z = (_ints(g2[i, c]) for c in range(3))
        zi = oracle.f2_inv(tuple(Z))
        zi2 = oracle.f2_mul(zi, zi)
        assert (oracle.f2_mul(tuple(X), zi2), oracle.f2_mul(tuple(Y), oracle.f2_mul(zi2, zi))) \
            == zs[i]


def test_the_window_check_catches_a_value_outside():
    """A product of two values near 2^470 leaves the result window."""
    big = torch.from_numpy(np.stack([R._residues(1 << 470, R._PRIMES)] * 2))
    with R.check_windows(), pytest.raises(AssertionError, match="outside"):
        R.rns_ops_plain(R.OP_MONT_MUL, big, big)


def _jax_f2(x):
    return convert.rns_to_jax(x[..., 0, :]), convert.rns_to_jax(x[..., 1, :])


def _from_jax_f2(x):
    return torch.stack([convert.rns_from_jax(np.asarray(c)) for c in x], -2)


def _jax_f12(x):
    return tuple(_jax_f2(x[..., k, :, :]) for k in range(6))


def _from_jax_f12(f):
    return torch.stack([_from_jax_f2(c) for c in f], -3)


def _f12(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(12 * n)]
    return torch.from_numpy(R.ints_to_mont_batch(vals)).reshape(n, 6, 2, R.NLIMBS)


def _unitary(seed, n):
    """Easy-part outputs f^((p^6 - 1)(p^2 + 1)) of random f (oracle)."""
    vals = []
    for f in _f12_values(_f12(seed, n)):
        f = oracle.f12_mul(oracle.f12_conj(f), oracle.f12_inv(f))
        vals.append(oracle.f12_mul(oracle.f12_frobenius(f, 2), f))
    flat = [c for f in vals for coeff in f for c in coeff]
    return torch.from_numpy(R.ints_to_mont_batch(flat)).reshape(n, 6, 2, R.NLIMBS)


F12_OPS = {
    "mul": (lambda x, y: B.f12_mul(x, y), lambda x, y: K.f12_mul(x, y)),
    "sqr": (lambda x, y: B.f12_sqr(x), lambda x, y: K.f12_sqr(x)),
    "conj": (lambda x, y: B.f12_conj(x), lambda x, y: K.f12_conj(x)),
    "inv": (lambda x, y: B.f12_inv(x), lambda x, y: K.f12_inv(x)),
    "frobenius": (lambda x, y: B.f12_frobenius(x), lambda x, y: K.f12_frobenius(x)),
    "frobenius2": (lambda x, y: B.f12_frobenius2(x), lambda x, y: K.f12_frobenius2(x)),
    "mul_sparse035": (lambda x, y: B.f12_mul_sparse035(x, y[:, 0], y[:, 3], y[:, 5]),
                      lambda x, y: K.f12_mul_sparse035(x, y[0], y[3], y[5])),
    "cyclotomic_sqr": (lambda x, y: B.f12_cyclotomic_sqr(x),
                       lambda x, y: K.f12_cyclotomic_sqr(x)),
    "pow_x": (lambda x, y: B._f12_pow_x(x), lambda x, y: K._f12_pow_x(x)),
}


@pytest.mark.parametrize("op", sorted(F12_OPS))
def test_f12_ops_equal_jax_mod_p(rns_backend, op):
    x = _unitary(3, 2) if op in ("cyclotomic_sqr", "pow_x") else _f12(3, 3)
    y = _f12(4, x.shape[0])
    mine, theirs = F12_OPS[op]
    got = mine(x, y)
    want = _from_jax_f12(theirs(_jax_f12(x), _jax_f12(y)))
    assert _ints(got) == _ints(want)


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_steps_equal_jax_mod_p(rns_backend, step):
    pks, hs, _ = _items(3, 3, 6)
    p, q = _rns(B.g1_to_words(pks), B.g2_to_words(hs))
    xp, yp = p[:, 0], p[:, 1]
    T = torch.stack([q[:, 0], q[:, 1], B.f2_one_like(q[:, 0])], 1)
    jT = tuple(_jax_f2(T[:, c]) for c in range(3))
    jp = (convert.rns_to_jax(xp), convert.rns_to_jax(yp))
    if step == "dbl":
        got = B._dbl_step(T, xp, yp)
        want = K._dbl_step(jT, *jp)
    else:
        T2 = B._dbl_step(T, xp, yp)[0]
        got = B._add_step(T2, q, xp, yp)
        want = K._add_step(tuple(_jax_f2(T2[:, c]) for c in range(3)),
                           (_jax_f2(q[:, 0]), _jax_f2(q[:, 1])), *jp)
    (T3, lines), (jT3, jlines) = got, want
    assert _ints(T3) == _ints(torch.stack([_from_jax_f2(c) for c in jT3], 1))
    assert _ints(torch.stack(lines, 1)) == _ints(torch.stack([_from_jax_f2(c) for c in jlines], 1))


def test_miller_loop_and_final_exponentiation_equal_the_oracle():
    """The RNS Miller loop equals the limb one mod p (the limb one is JAX's
    value, bit for bit); its final exponentiation is the oracle's pairing
    cube; the final exponentiation of a random value is the oracle's,
    cubed."""
    pks, hs, _ = _items(2, 2, 8)
    p, q = B.g1_to_words(pks), B.g2_to_words(hs)
    pr, qr = _rns(p, q)
    m = B.miller_loop_plain(qr, pr)
    assert _ints(m) == B.fp.mont_words_to_ints(B.miller_loop_plain(q, p))
    cube, ok = B.final_exp_batch_plain(m)
    assert _f12_values(cube) == [_cube(oracle.pairing(h, pk)) for h, pk in zip(hs, pks)]
    assert ok.tolist() == [False, False]
    f = _f12(9, 1)
    cube, _ = B.final_exp_batch_plain(f.reshape(1, 12, R.NLIMBS))
    assert _f12_values(cube) == [_cube(oracle.final_exponentiation(_f12_values(f)[0]))]


@pytest.mark.parametrize("shape", ["ungrouped", "grouped", "batch"])
def test_checks_give_the_limb_verdicts(shape):
    """The randomized check (ungrouped: 4 items; grouped: 4 items over 2
    messages) and the per-item check over the RNS field give the limb plain
    version's verdicts: valid passes, item 2 carrying item 3's signature
    fails (and is named by the per-item check)."""
    pks, hs, sigs = _items(4, 2 if shape == "grouped" else 4, 10)
    bad = list(sigs)
    bad[2] = sigs[3]
    zb = zbits_from_ints([int(z) for z in np.random.default_rng(10).integers(1, 2**63, 4)])
    seg = torch.tensor([0, 1, 0, 1]) if shape == "grouped" else None
    for s, valid in ((sigs, True), (bad, False)):
        limb = _words(pks, hs, s)
        for p, q, sg in (limb, _rns(*limb)):
            w = p.shape[-1]
            if shape == "batch":
                neg = B.neg_g1_words("cpu", w)[None].expand(4, 2, w)
                assert B.pairing_check_batch(q, p, sg, neg).tolist() \
                    == [valid or i != 2 for i in range(4)]
            else:
                reps = q[:2] if shape == "grouped" else q
                assert bool(B.pairing_check_rlc(reps, p, sg, zb, seg)) is valid
