"""The port's RNS field (consensus_specs_tpu_torch/ops/fp_rns.py; on the CPU
the plain version of kernel K24) against the JAX package's default field,
consensus_specs_tpu/ops/fp_rns.py, and against Python integers.

The contract (ops/fp_rns.py's docstring): add, sub, neg, mul_wide and
sum_stack are channel-equal to JAX's; mont_reduce, mont_mul and the power
ladders are equal mod p, and channel-equal or exactly p's residue vector
apart (JAX sums the first base extension's alpha in another order than
channel order 0..31, which can move a floor where q/M_A lies next to 1/4);
is_zero and is_one_mont are equal. Inputs come from numpy seeds.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fp_rns as J
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.kernels import build
from consensus_specs_tpu_torch.ops import fp
from consensus_specs_tpu_torch.ops import fp_rns as R

P = R.P
MA, MB = R.M_A, R.M_B
CSRC = Path(__file__).resolve().parent.parent / "consensus_specs_tpu_torch" / "csrc"
M64 = R._M_ALL.astype(np.int64)
P_RES = np.asarray([P % int(m) for m in M64], dtype=np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]


def _residues(values):
    """Residues of arbitrary (possibly negative, possibly > p) integers, the
    signed ones standing in the top half of [0, M_A·M_B)."""
    return torch.from_numpy(np.stack([R._residues(v % (MA * MB), R._PRIMES) for v in values]))


# Montgomery values, then the edges: 0, 1, p, 2p, values standing for
# negative integers, R and its class, 3p - 1
EDGES = [0, 1, P, 2 * P, P - 1, -1, -P, -(P // 3), R.R_MOD_P, R.R_MOD_P + 2 * P, 3 * P - 1]


def _operands(seed, n=24):
    a = [v * MA % P for v in _ints(seed, n)] + EDGES
    b = [v * MA % P for v in _ints(seed + 1, n)] + EDGES[::-1]
    return _residues(a), _residues(b)


def _same_or_p_apart(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """Per row: channel-equal, or every channel exactly p (or -p) apart."""
    d = (got.numpy().astype(np.int64) - np.asarray(want, np.int64)) % M64
    return (d == 0).all(-1) | (d == P_RES).all(-1) | (d == (-P_RES) % M64).all(-1)


def _from_mont(t) -> list:
    return R.mont_batch_to_ints(t)


def test_constants_match_jax():
    assert R._PRIMES == J._PRIMES and R.A_PRIMES == J.A_PRIMES and R.B_PRIMES == J.B_PRIMES
    assert (R.M_A, R.M_B, R.R_MOD_P) == (J.M_A, J.M_B, J.R_MOD_P)
    for mine, theirs in ((R._EXT_AB, J._EXT_AB), (R._EXT_BA, J._EXT_BA)):
        for name in ("w_inv", "C_hi", "C_lo", "m_src_prod_mod_dst", "inv_src_f32", "dst_m",
                     "dst_delta"):
            a, b = getattr(mine, name), getattr(theirs, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("_M_ALL", "_DELTA", "_NEG_PINV_A", "_P_MOD_B", "_MAINV_MOD_B", "ONE_MONT",
                 "_ZERO_CLASSES", "_ONE_CLASSES"):
        assert np.array_equal(getattr(R, name), getattr(J, name)), name
    assert R.NLIMBS == J.NLIMBS and R.SUPPORTS_WIDE is J.SUPPORTS_WIDE is True


def test_constants_header_is_generated():
    assert (CSRC / "rns_constants.cuh").read_text() == R.cuda_constants_header()


def test_host_codecs_match_jax():
    xs = _ints(3, 40) + [0, 1, P - 1]
    assert np.array_equal(R.ints_to_mont_batch(xs), J.ints_to_mont_batch(xs))
    assert R.ints_to_mont_batch([]).shape == (0, 64)
    enc = J.ints_to_mont_batch(xs)
    assert R.mont_batch_to_ints(enc) == J.mont_batch_to_ints(enc) == xs
    for x in xs[:5]:
        assert np.array_equal(R.to_mont(x), J.to_mont(x))
        assert np.array_equal(R.int_to_limbs(x), J.int_to_limbs(x))
        assert R.limbs_to_int(R.int_to_limbs(x)) == J.limbs_to_int(J.int_to_limbs(x)) == x
    neg = R._residues(-12345 % (MA * MB), R._PRIMES)
    assert R.from_mont_int(neg) == J.from_mont_int(neg) == (-12345) * pow(MA, -1, P) % P


EXACT = {"add": (R.OP_ADD, J.fp_add), "sub": (R.OP_SUB, J.fp_sub), "neg": (R.OP_NEG, J.fp_neg),
         "mul_wide": (R.OP_MUL_WIDE, J.fp_mul_wide)}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_channel_ops_equal_jax(name):
    op, theirs = EXACT[name]
    a, b = _operands(10)
    if op == R.OP_NEG:
        got, want = R.rns_ops(op, a), theirs(a.numpy())
    else:
        got, want = R.rns_ops(op, a, b), theirs(a.numpy(), b.numpy())
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_sum_stack_equals_jax(k):
    rows = torch.stack([_operands(20 + j)[0] for j in range(k)])
    got = R.rns_ops(R.OP_SUM_STACK, rows)
    assert np.array_equal(got.numpy(), np.asarray(J.fp_sum_stack(rows.numpy(), axis=0)))
    # the interface sums along any axis, as JAX's
    moved = rows.movedim(0, 1)
    assert torch.equal(R.fp_sum_stack(moved, axis=1), got)


MONT = {"mont_reduce": (R.OP_MONT_REDUCE, J.fp_mont_reduce),
        "mont_mul": (R.OP_MONT_MUL, J.fp_mont_mul),
        "pow_inv": (R.OP_POW_INV, J.fp_inv),
        "pow_sqrt": (R.OP_POW_SQRT, J.fp_sqrt_candidate)}


@pytest.mark.parametrize("name", sorted(MONT))
def test_montgomery_ops_equal_jax_mod_p(name):
    op, theirs = MONT[name]
    a0, b = _operands(30, n=12 if name.startswith("pow") else 24)
    # mont_reduce's input is a wide value: the channel product a0·b
    a = R.rns_ops(R.OP_MUL_WIDE, a0, b) if op == R.OP_MONT_REDUCE else a0
    if op == R.OP_MONT_MUL:
        got, want = R.rns_ops(op, a, b), np.asarray(theirs(a.numpy(), b.numpy()))
    else:
        got, want = R.rns_ops(op, a), np.asarray(theirs(a.numpy()))
    assert _from_mont(got) == J.mont_batch_to_ints(want)
    assert _same_or_p_apart(got, want).all()
    # and the value itself, against Python integers
    ints = [R.from_mont_int(r) for r in a0.numpy()]
    if op in (R.OP_MONT_MUL, R.OP_MONT_REDUCE):
        expect = [x * y % P for x, y in zip(ints, (R.from_mont_int(r) for r in b.numpy()))]
    else:
        e = P - 2 if op == R.OP_POW_INV else (P + 1) // 4
        expect = [pow(x, e, P) for x in ints]
    assert _from_mont(got) == expect


@pytest.mark.parametrize("name", ["is_zero", "is_one_mont"])
def test_predicates_equal_jax(name):
    op = R.OP_IS_ZERO if name == "is_zero" else R.OP_IS_ONE
    theirs = J.fp_is_zero if name == "is_zero" else J.fp_is_one_mont
    a, _ = _operands(40)
    got = R.rns_ops(op, a)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(theirs(a.numpy())))


def test_is_zero_and_is_one_on_their_classes_and_signed_values():
    zero_class = [0, P, 2 * P, -P, -2 * P, 5 * P]
    one_class = [R.R_MOD_P, R.R_MOD_P + P, R.R_MOD_P + 2 * P, R.R_MOD_P - P, R.R_MOD_P - 3 * P]
    others = [1, -1, P - 1, P + 1, R.R_MOD_P + 1, -R.R_MOD_P]
    vals = _residues(zero_class + one_class + others)
    z, o = R.fp_is_zero(vals).tolist(), R.fp_is_one_mont(vals).tolist()
    nz, no = len(zero_class), len(one_class)
    assert z == [True] * nz + [False] * (no + len(others))
    assert o == [False] * nz + [True] * no + [False] * len(others)
    assert z == np.asarray(J.fp_is_zero(vals.numpy())).tolist()
    assert o == np.asarray(J.fp_is_one_mont(vals.numpy())).tolist()


def _alpha_inputs():
    """mont_reduce inputs whose q = -t·p^-1 mod M_A lies next to M_A/4, where
    the first extension's float32 alpha decides a floor: t = (-q·p) mod M_A."""
    qs = [MA // 4 + k for k in range(-60, 61)]
    qs += [MA // 4 + int(MA * f) for f in (2**-20, -2**-20, 2**-23, -2**-23, 2**-25, -2**-25)]
    return _residues([(-q * P) % MA for q in qs])


def test_mont_reduce_at_the_alpha_boundary():
    t = _alpha_inputs()
    got = R.rns_ops(R.OP_MONT_REDUCE, t)
    want = np.asarray(J.fp_mont_reduce(t.numpy()))
    assert _same_or_p_apart(got, want).all()
    assert _from_mont(got) == J.mont_batch_to_ints(want)
    ints = [R.from_mont_int(r) for r in t.numpy()]
    assert _from_mont(got) == [x * pow(MA, -1, P) % P for x in ints]
    # both floors occur among these inputs: the result is r or r + p
    sigma = R._red_full(R._red_full(t[:, :32].long() * R._const("neg_pinv_a", "cpu"),
                                    R._const("mA", "cpu")) * R._const("ab_w_inv", "cpu"),
                        R._const("mA", "cpu"))
    alphas = set(R._alpha(sigma, R._const("ab_inv_f32", "cpu"), -0.25).tolist())
    assert len(alphas) >= 2


def test_alpha_is_the_channel_order_float32_sum():
    rng = np.random.default_rng(7)
    sigma = rng.integers(0, 32000, (300, 32))
    sigma[0] = 0
    sigma[4] = R._MA - 1
    inv = R._EXT_AB.inv_src_f32
    got = R._alpha(torch.from_numpy(sigma), torch.from_numpy(inv.copy()), -0.25)
    for row, a in zip(sigma, got.tolist()):
        acc = np.float32(0)
        for s, w in zip(row, inv):
            acc = np.float32(acc + np.float32(np.float32(s) * w))
        assert a == int(np.floor(np.float32(acc + np.float32(-0.25))))


def test_extension_equals_the_direct_64_bit_sum():
    """The plain version's extension reaches the canonical residue of JAX's
    (and K24's) sum: (sum_i sigma_i·C[i][j] - alpha·M) mod m_j."""
    rng = np.random.default_rng(8)
    for tag, ext, offset in (("ab", R._EXT_AB, -0.25), ("ba", R._EXT_BA, 0.25)):
        src = R._MA if tag == "ab" else R._MB
        sigma = rng.integers(0, src, (200, 32))
        sigma[0] = src - 1  # the largest residues
        sigma[1] = 0
        s = torch.from_numpy(sigma)
        got = R._extend(s, tag, offset).numpy()
        alpha = R._alpha(s, torch.from_numpy(ext.inv_src_f32.copy()), offset).numpy()
        direct = (sigma @ ext.C - alpha[:, None] * ext.m_src_prod_mod_dst.astype(np.int64))
        assert np.array_equal(got, direct % ext.dst_m.astype(np.int64))


def test_deep_mixed_chain_vs_bigint():
    """Adds, subs and negs stacked between products, magnitudes well past p
    both ways, multiplied without shrinking (tests/test_fp_rns.py's chain)."""
    xs = _ints(9, 8)
    dev = [torch.from_numpy(R.ints_to_mont_batch([x])) for x in xs]
    acc, ref = R.fp_sub(dev[0], dev[1]), xs[0] - xs[1]
    for i in range(2, 8):
        acc = R.fp_add(acc, R.fp_sub(dev[i], dev[(i + 3) % 8]))
        ref += xs[i] - xs[(i + 3) % 8]
        if i % 3 == 0:
            acc, ref = R.fp_neg(acc), -ref
    assert _from_mont(R.fp_mont_mul(acc, acc)) == [ref * ref % P]
    assert _from_mont(R.fp_mont_mul(acc, dev[5])) == [ref * xs[5] % P]
    wide = R.fp_add(R.fp_mul_wide(acc, dev[2]), R.fp_mul_wide(dev[3], dev[4]))
    assert _from_mont(R.fp_mont_reduce(wide)) == [(ref * xs[2] + xs[3] * xs[4]) % P]
    assert _from_mont(R.fp_inv(R.fp_mont_mul(acc, acc))) == [pow(ref * ref, P - 2, P)]


def test_interface_broadcasts_as_jax():
    a, b = _operands(50, n=6)
    one = torch.from_numpy(R.ONE_MONT)
    got = R.fp_mont_mul(a.reshape(-1, 1, 64)[:6], b[None, :3])
    want = J.fp_mont_mul(a.numpy().reshape(-1, 1, 64)[:6], b.numpy()[None, :3])
    assert got.shape == (6, 3, 64) and _same_or_p_apart(got.reshape(-1, 64),
                                                        np.asarray(want).reshape(-1, 64)).all()
    assert torch.equal(R.fp_add(a, one), convert.rns_from_jax(J.fp_add(a.numpy(), R.ONE_MONT)))
    assert R.fp_is_zero(a[:15].reshape(5, 3, 64)).shape == (5, 3)
    with pytest.raises(ValueError):
        R.fp_pow_const(a, 3)


def test_wrapper_checks_and_counts():
    a, b = _operands(60, n=4)
    for bad in (a.long(), a[:, :32], a[0]):
        with pytest.raises(ValueError):
            R.rns_ops(R.OP_NEG, bad)
    with pytest.raises(ValueError):
        R.rns_ops(R.OP_ADD, a, None)
    with pytest.raises(ValueError):
        R.rns_ops(R.OP_ADD, a, b[:2])
    with pytest.raises(ValueError):
        R.rns_ops(R.OP_SUM_STACK, torch.stack([a] * 9))
    with pytest.raises(ValueError):
        R.rns_ops(99, a)
    before, counted = build.LAUNCHES["rns_ops"], dict(R.OP_LAUNCHES)
    assert R.rns_ops(R.OP_MONT_MUL, a[:0], b[:0]).shape == (0, 64)
    assert R.rns_ops(R.OP_IS_ZERO, a[:0]).shape == (0,)
    R.rns_ops(R.OP_MONT_MUL, a, b)
    # the CPU path is the plain version: no kernel launch counted
    assert build.LAUNCHES["rns_ops"] == before and dict(R.OP_LAUNCHES) == counted


def test_carry_across_packages_and_fields():
    xs = _ints(70, 6)
    jax_res = J.ints_to_mont_batch(xs).reshape(2, 3, 64)
    mine = convert.rns_from_jax(jax_res)
    assert mine.dtype == torch.int32 and mine.shape == (2, 3, 64)
    assert np.array_equal(convert.rns_to_jax(mine), jax_res)
    words = torch.from_numpy(fp.ints_to_mont_words(xs)).reshape(2, 3, fp.NWORDS)
    rns = convert.rns_from_words(words)
    assert torch.equal(rns, mine)
    assert torch.equal(convert.words_from_rns(rns), words)
    # a redundant RNS value (standing for X + p) maps to the canonical words
    shifted = R.fp_add(mine, torch.from_numpy(R.int_to_limbs(P)))
    assert torch.equal(convert.words_from_rns(shifted), words)
