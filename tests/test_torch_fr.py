"""The port's Fr field and NTT (consensus_specs_tpu_torch/ops/fr.py, the
plain versions of kernels K23 `fr_ops` and K22 `fr_ntt`) held bit-equal to
the JAX package's (consensus_specs_tpu/ops/fr_jax.py) on numpy-seeded
inputs and the edge values 0, 1 and r - 1. Both hold the Montgomery value
a·2^256 mod r, so the comparison is exact equality of canonical words after
a repacking (engine/convert.py's `fp_from_jax_limbs` / `fp_to_jax_limbs`,
which repack any width)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fr_jax
from consensus_specs_tpu_torch.engine.convert import fp_from_jax_limbs, fp_to_jax_limbs
from consensus_specs_tpu_torch.ops import fr
from consensus_specs_tpu_torch.ops.fr_host import R_MODULUS, host_ntt

EDGES = [0, 1, R_MODULUS - 1, fr.R_MOD_R]
NTT_SIZES = (1, 2, 8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain field's tensors are small, and
    parallel test workers do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_ntts():
    """One jitted JAX NTT per (n, inverse), shared by the module's tests
    (make_ntt compiles slowly on the CPU)."""
    return {(n, inv): fr_jax.make_ntt(n, inverse=inv) for n in NTT_SIZES for inv in (False, True)}


def _values(seed, n):
    """n canonical values from numpy's generator, the edge values first."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % R_MODULUS for _ in range(n)]
    return (EDGES + rand)[:max(n, len(EDGES))]


def _jax_mont(values):
    return np.asarray(fr_jax.ints_to_mont_batch(values))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_ops_match_jax(op, seed):
    a = _values(seed, 24)
    b = _values(seed + 100, 24)[::-1]
    b[1] = 0  # sub with b = 0: JAX renormalises r through cond_sub_mod
    ja, jb = _jax_mont(a), _jax_mont(b)
    want = {"mul": fr_jax.fr_mul, "add": fr_jax.fr_add, "sub": fr_jax.fr_sub}[op](ja, jb)
    code = {"mul": fr.OP_MUL, "add": fr.OP_ADD, "sub": fr.OP_SUB}[op]
    got = fr.fr_ops(code, fp_from_jax_limbs(ja), fp_from_jax_limbs(jb))
    assert torch.equal(got, fp_from_jax_limbs(np.asarray(want)))
    assert np.array_equal(fp_to_jax_limbs(got), np.asarray(want))


def test_inverse_matches_jax_and_maps_zero_to_zero():
    a = _values(2, 8)
    ja = _jax_mont(a)
    got = fr.fr_ops(fr.OP_INV, fp_from_jax_limbs(ja))
    assert torch.equal(got, fp_from_jax_limbs(np.asarray(fr_jax.fr_inv(ja))))
    assert fr.words_to_ints(got[0]) == [0]
    assert fr.mont_to_ints(got) == [pow(x, R_MODULUS - 2, R_MODULUS) for x in a]


def test_binary_op_broadcasts_one_row():
    a = fp_from_jax_limbs(_jax_mont(_values(3, 12)))
    b = fp_from_jax_limbs(_jax_mont([R_MODULUS - 1]))[0]
    assert torch.equal(fr.fr_ops(fr.OP_MUL, a, b), fr.fr_ops(fr.OP_MUL, a, b.expand_as(a)))


def test_codecs_round_trip_and_match_jax():
    vals = _values(4, 40) + [(1 << 256) - 1]
    words = fr.ints_to_words(vals)
    assert words.shape == (41, 8) and words.dtype == np.int32
    assert fr.words_to_ints(words) == vals
    assert fr.words_to_ints(torch.from_numpy(words)) == vals
    limbs = _jax_mont(vals[:-1])
    assert np.array_equal(fp_to_jax_limbs(fp_from_jax_limbs(limbs)), limbs)
    mont = fr.ints_to_mont(vals[:-1], "cpu")
    assert torch.equal(mont, fp_from_jax_limbs(limbs))
    assert fr.mont_to_ints(mont) == fr_jax.mont_batch_to_ints(limbs) == vals[:-1]
    # ints at or above r are reduced first, as JAX's to_mont does
    assert torch.equal(fr.ints_to_mont([R_MODULUS, R_MODULUS + 5], "cpu"),
                       fp_from_jax_limbs(_jax_mont([R_MODULUS, R_MODULUS + 5])))


def test_twiddle_table_is_jax_tables_flattened():
    n = 32
    for inverse in (False, True):
        table, scale = fr.twiddles(n, inverse, "cpu")
        want = np.concatenate(fr_jax._twiddle_tables(n, inverse))
        assert table.shape == (n - 1, 8)
        assert torch.equal(table, fp_from_jax_limbs(want))
        if inverse:
            n_inv = pow(n, R_MODULUS - 2, R_MODULUS)
            assert torch.equal(scale, fp_from_jax_limbs(fr_jax.to_mont(n_inv)))
        else:
            assert scale is None
    assert fr.twiddles(n, False, "cpu")[0] is fr.twiddles(n, False, "cpu")[0]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", NTT_SIZES)
def test_ntt_matches_jax_and_host(jax_ntts, n, inverse):
    shape = (3, n) if n == 16 else (n,)
    vals = _values(10 + n, int(np.prod(shape)))[:int(np.prod(shape))]
    limbs = _jax_mont(vals).reshape(*shape, 16)
    want = np.asarray(jax_ntts[(n, inverse)](limbs))
    x = fp_from_jax_limbs(limbs)
    plain = fr.ntt_plain(x, inverse)
    assert torch.equal(plain, fp_from_jax_limbs(want))
    assert torch.equal(fr.ntt(x, inverse), plain)
    rows = np.asarray(vals, dtype=object).reshape(-1, n).tolist()
    got = fr.mont_to_ints(plain)
    assert got == [v for row in rows for v in host_ntt(row, inverse=inverse)]
    if n == 16:
        assert fr.ntt_ints(rows[0], inverse, "cpu") == host_ntt(rows[0], inverse=inverse)


def test_ntt_inverse_round_trips():
    x = fp_from_jax_limbs(_jax_mont(_values(20, 64)).reshape(2, 32, 16))
    assert torch.equal(fr.ntt(fr.ntt(x), inverse=True), x)


@pytest.mark.parametrize("bad", [(3, 8), (6, 8), (0, 8)])
def test_ntt_rejects_sizes_that_are_not_powers_of_two(bad):
    with pytest.raises(ValueError, match="power of two"):
        fr.ntt(torch.zeros(bad, dtype=torch.int32))


def test_wrappers_reject_bad_tensors():
    with pytest.raises(ValueError):
        fr.ntt(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        fr.fr_ops(fr.OP_MUL, torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        fr.fr_ops(fr.OP_ADD, torch.zeros((4, 8), dtype=torch.int32),
                  torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        fr.fr_ops(9, torch.zeros((4, 8), dtype=torch.int32))


def test_ntt_ints_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fr.ntt_ints([1, 2], False)


def test_cuda_constants_match():
    """csrc/fr.cuh's constant tables hold r, R mod r, r - 2 and -r^-1 mod
    2^32 as ops/fr.py computes them."""
    text = (Path(fr.__file__).parents[1] / "csrc" / "fr.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", text).group(1)
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert table("FR_R") == R_MODULUS
    assert table("FR_ONE") == fr.R_MOD_R
    assert table("FR_EXP_INV") == R_MODULUS - 2
    assert int(re.search(r"#define FR_N0 (0x[0-9a-f]+)u", text).group(1), 16) == fr.N0_32
    top = int(re.search(r"#define FR_EXP_INV_TOP (\d+)", text).group(1))
    assert top == (R_MODULUS - 2).bit_length() - 1
