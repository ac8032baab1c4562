"""The port's Fp (consensus_specs_tpu_torch/ops/fp.py, the plain version of
kernel K8) held bit-equal to the JAX package's limb field
(consensus_specs_tpu/ops/fp_jax.py) on seeded inputs and the edge values
0, 1, p - 1 and R mod p. Both hold the Montgomery value a·2^384 mod p, so the
comparison is of canonical words after a repacking (engine/convert.py)."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fp_jax, fp_rns
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import fp

P = fp.P
EDGES = [0, 1, P - 1, fp.R_MOD_P, P - 2, (1 << 380) - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain field's tensors are small, so one
    thread is faster, and parallel test workers do not oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _values(seed, n):
    """n canonical values from numpy's generator, the edge values first."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    return (EDGES + rand)[:max(n, len(EDGES))]


def _jax_limbs(values):
    return np.stack([fp_jax.int_to_limbs(v) for v in values])


def _words(values):
    return torch.from_numpy(fp.ints_to_words(values))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "neg"])
def test_field_ops_match_jax_limbs(op, seed):
    a = _values(seed, 24)
    b = _values(seed + 100, 24)[::-1]
    ja, jb = _jax_limbs(a), _jax_limbs(b)
    want = {"mul": lambda: fp_jax.fp_mont_mul(ja, jb), "sqr": lambda: fp_jax.fp_mont_sqr(ja),
            "add": lambda: fp_jax.fp_add(ja, jb), "sub": lambda: fp_jax.fp_sub(ja, jb),
            "neg": lambda: fp_jax.fp_neg(ja)}[op]()
    code = {"mul": fp.OP_MUL, "sqr": fp.OP_SQR, "add": fp.OP_ADD, "sub": fp.OP_SUB,
            "neg": fp.OP_NEG}[op]
    got = fp.fp_ops(code, _words(a), _words(b) if code in fp._BINARY else None)
    assert torch.equal(got, convert.fp_from_jax_limbs(np.asarray(want)))


@pytest.mark.parametrize("op", ["inv", "sqrt"])
def test_field_pow_ops_match_jax_limbs(op):
    a = _values(7, 8)
    ja = _jax_limbs(a)
    want = fp_jax.fp_inv(ja) if op == "inv" else fp_jax.fp_sqrt_candidate(ja)
    got = fp.fp_ops(fp.OP_INV if op == "inv" else fp.OP_SQRT, _words(a))
    assert torch.equal(got, convert.fp_from_jax_limbs(np.asarray(want)))
    if op == "inv":  # zero maps to zero; a·a^-1 = 1 elsewhere
        assert int(got[0].abs().sum()) == 0
        prod = fp.words_to_ints(fp.fp_ops(fp.OP_MUL, _words(a), got))
        assert prod[1:] == [fp.R_MOD_P] * (len(a) - 1)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_sum_stack_matches_jax(k):
    vals = np.stack([_jax_limbs(_values(20 + j, 12)) for j in range(k)])
    want = fp_jax.fp_sum_stack(vals, axis=0)
    got = fp.fp_sum_stack(fp.to_limbs(convert.fp_from_jax_limbs(vals)), dim=0)
    assert torch.equal(fp.to_words(got), convert.fp_from_jax_limbs(np.asarray(want)))


def test_predicates_match_jax():
    vals = _values(3, 12)
    ja = _jax_limbs(vals)
    limbs = fp.to_limbs(_words(vals))
    assert fp.fp_is_zero(limbs).tolist() == np.asarray(fp_jax.fp_is_zero(ja)).tolist()
    assert fp.fp_is_one_mont(limbs).tolist() == np.asarray(fp_jax.fp_is_one_mont(ja)).tolist()
    assert fp.fp_is_one_mont(limbs).tolist()[3]  # R mod p is the Montgomery one


def test_plain_arithmetic_matches_python_ints():
    a, b = _values(11, 40), _values(12, 40)
    r_inv = pow(fp.R, -1, P)
    wa, wb = _words(a), _words(b)
    assert fp.words_to_ints(fp.fp_ops(fp.OP_MUL, wa, wb)) == [x * y * r_inv % P
                                                              for x, y in zip(a, b)]
    assert fp.words_to_ints(fp.fp_ops(fp.OP_ADD, wa, wb)) == [(x + y) % P for x, y in zip(a, b)]
    assert fp.words_to_ints(fp.fp_ops(fp.OP_SUB, wa, wb)) == [(x - y) % P for x, y in zip(a, b)]
    assert fp.words_to_ints(fp.fp_ops(fp.OP_NEG, wa)) == [(-x) % P for x in a]


def test_codecs_and_repacking_round_trip():
    vals = _values(5, 16)
    words = _words(vals)
    assert fp.words_to_ints(words) == vals
    assert torch.equal(fp.to_words(fp.to_limbs(words)), words)
    limbs = _jax_limbs(vals)
    assert torch.equal(convert.fp_from_jax_limbs(limbs), words)
    assert np.array_equal(convert.fp_to_jax_limbs(words), limbs.astype(np.uint32))
    mont = fp.ints_to_mont_words(vals)
    assert fp.mont_words_to_ints(mont) == vals
    assert np.array_equal(mont, fp.ints_to_words([fp_jax.FIELD.limbs_to_int(fp_jax.to_mont(v))
                                                   for v in vals]))


def test_rns_values_cross_as_canonical_ints():
    """JAX's default field is RNS, another layout: its values cross through
    canonical ints (its own `mont_batch_to_ints`) and give the port's words
    for the same product."""
    a, b = _values(13, 8), _values(14, 8)
    prod = fp_rns.fp_mont_mul(fp_rns.ints_to_mont_batch(a), fp_rns.ints_to_mont_batch(b))
    crossed = torch.from_numpy(fp.ints_to_mont_words(fp_rns.mont_batch_to_ints(prod)))
    mine = fp.fp_ops(fp.OP_MUL, torch.from_numpy(fp.ints_to_mont_words(a)),
                     torch.from_numpy(fp.ints_to_mont_words(b)))
    assert torch.equal(crossed, mine)
    assert fp.mont_words_to_ints(mine) == [x * y % P for x, y in zip(a, b)]


def test_to_mont_words_is_one_product_by_r2():
    vals = _values(9, 10)
    got = fp.to_mont_words(_words(vals))
    assert fp.words_to_ints(got) == [fp.to_mont(v) for v in vals]
    assert fp.R2_MOD_P == fp_jax.R2_MOD_P and fp.R_MOD_P == fp_jax.R_MOD_P


def test_plain_muls_counts_products():
    a = _words(_values(4, 10))
    before = fp.plain_muls
    fp.fp_ops(fp.OP_MUL, a, a)
    assert fp.plain_muls - before == a.shape[0]
    before = fp.plain_muls
    fp.fp_ops(fp.OP_INV, a[:2])
    e = P - 2
    assert fp.plain_muls - before == 2 * (e.bit_length() + bin(e).count("1"))


def test_fp_ops_rejects_bad_input():
    with pytest.raises(ValueError):
        fp.fp_ops(fp.OP_MUL, torch.zeros((4, 11), dtype=torch.int32),
                  torch.zeros((4, 11), dtype=torch.int32))
    with pytest.raises(ValueError):
        fp.fp_ops(fp.OP_ADD, torch.zeros((4, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        fp.fp_ops(fp.OP_NEG, torch.zeros((4, 12), dtype=torch.int64))
