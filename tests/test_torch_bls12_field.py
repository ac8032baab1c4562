"""The port's field-generic towers, curves and pairing over the RNS field
(consensus_specs_tpu_torch/ops/bls12_field.py; on the CPU over the plain
version of K24) against the JAX package's default path
(consensus_specs_tpu/ops/bls12_jax.py with its field backend "rns", set in a
fixture that restores the backend it found) and the copied oracle.

Equality is mod p (`from_mont_int` per coefficient): the two packages may
end one Montgomery reduction p apart (ops/fp_rns.py, ROADMAP C7); every
boolean is equal. Inputs come from numpy seeds. The randomized checks are in
tests/test_torch_bls12_field_rlc.py (a file of their own: each costs seconds
of plain arithmetic). A `slow` test holds `pairing_check_rlc` against JAX's
compiled program directly.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import bls12_field as BF
from consensus_specs_tpu_torch.ops import fp_rns as R

P = R.P
F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def rns_backend():
    """JAX's default field, whatever another test file left selected."""
    saved = K.field_backend()
    K.set_field_backend("rns")
    yield
    K.set_field_backend(saved)


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _fp(values, shape=None):
    t = torch.from_numpy(R.ints_to_mont_batch(values))
    return t if shape is None else t.reshape(*shape, R.NLIMBS)


def _f2(seed, n):
    v = _fp(_ints(seed, 2 * n), (n, 2))
    return (v[:, 0], v[:, 1])


def _f12(seed, n):
    v = _fp(_ints(seed, 12 * n), (n, 6, 2))
    return tuple((v[:, k, 0], v[:, k, 1]) for k in range(6))


def _jax(x):
    """A port value (tensor or nested tuple) as JAX takes it."""
    if isinstance(x, torch.Tensor):
        return convert.rns_to_jax(x)
    return tuple(_jax(c) for c in x)


def _ints_of(x) -> list:
    """Canonical ints of a value (tensor, JAX array or nested tuple)."""
    if isinstance(x, (tuple, list)):
        return [v for c in x for v in _ints_of(c)]
    if not isinstance(x, torch.Tensor):
        x = convert.rns_from_jax(np.asarray(x))
    return R.mont_batch_to_ints(x)


def _bools(x) -> list:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).tolist()


F2_OPS = {
    "add": lambda M, x, y: M.f2_add(x, y),
    "sub": lambda M, x, y: M.f2_sub(x, y),
    "neg": lambda M, x, y: M.f2_neg(x),
    "conj": lambda M, x, y: M.f2_conj(x),
    "mul": lambda M, x, y: M.f2_mul(x, y),
    "mul_wide": lambda M, x, y: M.f2_reduce(M.f2_mul_wide(x, y)),
    "sqr": lambda M, x, y: M.f2_sqr(x),
    "mul_xi": lambda M, x, y: M.f2_mul_xi(x),
    "mul_fp": lambda M, x, y: M.f2_mul_fp(x, y[0]),
    "inv": lambda M, x, y: M.f2_inv(x),
    "is_zero": lambda M, x, y: M.f2_is_zero(x),
}


@pytest.mark.parametrize("op", sorted(F2_OPS))
def test_f2_ops_match_jax(op):
    x, y = _f2(1, 5), _f2(2, 5)
    x = (x[0].clone(), x[1].clone())
    x[0][0] = 0  # zero (inv maps it to zero)
    x[1][0] = 0
    x[1][1] = 0  # a real element
    got = F2_OPS[op](BF, x, y)
    want = F2_OPS[op](K, _jax(x), _jax(y))
    if op == "is_zero":
        assert _bools(got) == _bools(want) == [True, False, False, False, False]
    else:
        assert _ints_of(got) == _ints_of(want)


def _unitary(seed, n):
    """Easy-part outputs f^((p^6 - 1)(p^2 + 1)) of random f (oracle)."""
    vals = []
    for f in BF.f12_from_tensors(_f12(seed, n)):
        f = oracle.f12_mul(oracle.f12_conj(f), oracle.f12_inv(f))
        vals.append(oracle.f12_mul(oracle.f12_frobenius(f, 2), f))
    flat = [c for f in vals for coeff in f for c in coeff]
    v = _fp(flat, (n, 6, 2))
    return tuple((v[:, k, 0], v[:, k, 1]) for k in range(6))


F12_OPS = {
    "mul": lambda M, x, y: M.f12_mul(x, y),
    "sqr": lambda M, x, y: M.f12_sqr(x),
    "conj": lambda M, x, y: M.f12_conj(x),
    "inv": lambda M, x, y: M.f12_inv(x),
    "frobenius": lambda M, x, y: M.f12_frobenius(x),
    "frobenius2": lambda M, x, y: M.f12_frobenius2(x),
    "mul_sparse035": lambda M, x, y: M.f12_mul_sparse035(x, y[0], y[3], y[5]),
    "cyclotomic_sqr": lambda M, x, y: M.f12_cyclotomic_sqr(x),
    "pow_x": lambda M, x, y: M._f12_pow_x(x),
    "prod_reduce": lambda M, x, y: M.f12_prod_reduce(x),
}


@pytest.mark.parametrize("op", sorted(F12_OPS))
def test_f12_ops_match_jax(op):
    unitary = op in ("cyclotomic_sqr", "pow_x")
    x = _unitary(3, 2) if unitary else _f12(3, 3)
    y = _f12(4, 3)
    got = F12_OPS[op](BF, x, y)
    want = F12_OPS[op](K, _jax(x), _jax(y))
    assert _ints_of(got) == _ints_of(want)
    if op == "cyclotomic_sqr":  # and it is the square on unitary inputs
        assert _ints_of(got) == _ints_of(BF.f12_sqr(x))


def test_f12_is_one_matches_jax():
    f = _f12(5, 3)
    one = BF.f12_one_like((f[0][0][0], f[0][1][0]))
    # 1 as R + p in one coefficient, a zero coefficient as 2p: the class
    # compares, not the residues, decide
    shifted = torch.from_numpy(R.int_to_limbs(P))
    f_one = tuple((R.fp_add(c[0], shifted), R.fp_add(R.fp_add(c[1], shifted), shifted))
                  for c in one)
    mixed = tuple((torch.stack([a0[0], b0[0], c0[0]]), torch.stack([a0[1], b0[1], c0[1]]))
                  for a0, b0, c0 in zip(one, f_one, tuple((c[0][0], c[1][0]) for c in f)))
    got = BF.f12_is_one(mixed)
    assert _bools(got) == _bools(K.f12_is_one(_jax(mixed))) == [True, True, False]


def _points(seed, n):
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)]
    hs = [hash_to_curve_g2(b"field %d %d" % (seed, i)) for i in range(n)]
    pks = [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k)) for k in ks]
    return ks, hs, pks


def _g1(pts):
    return _fp([p[0] for p in pts]), _fp([p[1] for p in pts])


def _g2(pts):
    return ((_fp([p[0][0] for p in pts]), _fp([p[0][1] for p in pts])),
            (_fp([p[1][0] for p in pts]), _fp([p[1][1] for p in pts])))


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_steps_match_jax(step):
    ks, hs, pks = _points(6, 3)
    (qx, qy), (px, py) = _g2(hs), _g1(pks)
    T = (qx, qy, BF.f2_one_like(qx))
    if step == "dbl":
        got = BF._dbl_step(T, px, py)
        want = K._dbl_step(_jax(T), _jax(px), _jax(py))
    else:
        T2 = BF._dbl_step(T, px, py)[0]
        got = BF._add_step(T2, (qx, qy), px, py)
        want = K._add_step(_jax(T2), (_jax(qx), _jax(qy)), _jax(px), _jax(py))
    assert _ints_of(got) == _ints_of(want)


def _jacobian(points, group, infinity=()):
    """Affine host points -> Jacobian (X, Y, Z) with Z = 1, or Z = 0 at the
    indices in `infinity`."""
    xy = _g1(points) if group == "g1" else _g2(points)
    inf = torch.tensor([i in infinity for i in range(len(points))])[:, None]
    if group == "g1":
        one = torch.where(inf, 0, BF._one(xy[0]))
        return (*xy, one)
    one = BF.f2_one_like(xy[0])
    return (*xy, (torch.where(inf, 0, one[0]), one[1]))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_complete_adds_and_ladders_match_jax(group):
    """g1_add / g2_add on a generic pair, equal points, opposite points and an
    infinity operand against JAX's functions; the window ladder over short
    scalars against the oracle (JAX's ladder is a compiled loop)."""
    ks, hs, pks = _points(7, 2)
    if group == "g1":
        pts = pks
        neg = [(x, (-y) % P) for x, y in pts]
    else:
        pts = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
               for h, k in zip(hs, ks)]
        neg = [(x, ((-y[0]) % P, (-y[1]) % P)) for x, y in pts]
    a = _jacobian([pts[0], pts[0], pts[0], pts[1]], group)
    b = _jacobian([pts[1], pts[0], neg[0], pts[0]], group, infinity=(3,))
    add = "g1_add" if group == "g1" else "g2_add"
    got = getattr(BF, add)(a, b)
    assert _ints_of(got) == _ints_of(getattr(K, add)(_jax(a), _jax(b)))
    zs = [0b1101101, 0b1111111]
    bits = torch.tensor([[(z >> i) & 1 for i in range(7)] for z in zs], dtype=torch.bool)
    mul = BF.g1_scalar_mul_batch if group == "g1" else BF.g2_scalar_mul_batch
    X, Y, Z = mul(_jacobian(pts, group), bits)
    field = F1 if group == "g1" else F2
    for i, (pt, z) in enumerate(zip(pts, zs)):
        want = oracle.pt_to_affine(field, oracle.pt_mul(field, oracle.pt_from_affine(field, pt), z))
        x, y, zz = (_ints_of(c[i] if group == "g1" else (c[0][i], c[1][i])) for c in (X, Y, Z))
        if group == "g1":
            zi = pow(zz[0], -1, P)
            assert (x[0] * zi**2 % P, y[0] * zi**3 % P) == want
        else:
            zi = oracle.f2_inv((zz[0], zz[1]))
            zi2 = oracle.f2_mul(zi, zi)
            assert (oracle.f2_mul((x[0], x[1]), zi2),
                    oracle.f2_mul((y[0], y[1]), oracle.f2_mul(zi2, zi))) == want


def test_miller_loop_and_final_exponentiation_match_oracle():
    ks, hs, pks = _points(8, 2)
    (qx, qy), (px, py) = _g2(hs), _g1(pks)
    loops = BF.miller_loop_items
    cube = BF.pairing_cube_batch(qx, qy, px, py)
    assert BF.miller_loop_items == loops + 2
    for got, h, pk in zip(BF.f12_from_tensors(cube), hs, pks):
        e = oracle.pairing(h, pk)
        assert got == oracle.f12_mul(oracle.f12_sqr(e), e)


def test_pairing_check_batch_flags_the_bad_item():
    ks, hs, pks = _points(9, 3)
    sigs = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
            for h, k in zip(hs, ks)]
    sigs[1] = sigs[2]  # item 1 signs with another message's signature
    neg = (oracle.G1_GEN_AFF[0], (-oracle.G1_GEN_AFF[1]) % P)
    ok = BF.pairing_check_batch(*_g2(hs), *_g1(pks), *_g2(sigs), *_g1([neg] * 3))
    assert ok.tolist() == [True, False, True]


def test_backend_switch_and_its_names():
    assert B.field_backend() == "limb" and sorted(B.FIELD_BACKENDS) == ["limb", "rns"]
    rns, limb = B.FIELD_BACKENDS["rns"], B.FIELD_BACKENDS["limb"]
    assert (rns.width, rns.pack) == (R.NLIMBS, BF.pack_mont)
    assert (limb.width, limb.pack) == (12, B.pack_mont)
    assert B.current_field() is limb
    B.set_field_backend("rns")
    try:
        assert B.field_backend() == "rns" and B.current_field() is rns
        with pytest.raises(KeyError):
            B.set_field_backend("montgomery")
        assert B.field_backend() == "rns"
    finally:
        B.set_field_backend("limb")


@pytest.mark.slow
def test_pairing_check_rlc_matches_jax_directly():
    """The grouped and ungrouped checks against JAX's compiled program on the
    same inputs and scalars (compiling it takes many minutes)."""
    ks, hs, pks = _points(10, 4)
    sigs = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
            for h, k in zip(hs, ks)]
    neg = (oracle.G1_GEN_AFF[0], (-oracle.G1_GEN_AFF[1]) % P)
    zb = torch.from_numpy(np.random.default_rng(10).integers(0, 2, (4, 64)).astype(bool))
    zb[:, 0] = True
    args = (*_g2(hs), *_g1(pks), *_g2(sigs), *_g1([neg] * 4))
    for bad in (False, True):
        a = list(args)
        if bad:
            a[4] = (a[4][0].flip(0), a[4][1].flip(0))  # q2x swapped between items
            a[5] = (a[5][0].flip(0), a[5][1].flip(0))
        got = BF.pairing_check_rlc(*a, zb, p2_is_neg_g1=True)
        want = K.pairing_check_rlc(*_jax(tuple(a)), zb.numpy(), p2_is_neg_g1=True)
        assert bool(got) == bool(want) == (not bad)
