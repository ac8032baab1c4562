"""The port's G1 MSM, committee-key sum and subgroup check
(consensus_specs_tpu_torch/ops/bls12.py, K13/K14 and K10's aggregate) on the
CPU, where each kernel runs its plain version, held against the JAX
package's `ops/bls12_jax.py` entries and the copied host oracle.

Tolerance: exact. Results are canonical affine integers (or None for the
identity), digits and cost counts integers; every comparison is equality.
The JAX calls use the shapes tests/test_msm.py compiles (MSM buckets of 8 at
64 and 255 bits, the 64-item subgroup and aggregate programs). Inputs come
from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls12_jax as JK
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto import kzg, msm_synthetic
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import fp

F1 = oracle.FP_FIELD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain field's tensors are small."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _points(ks):
    return [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k)) for k in ks]


def _seeded_points(seed, n):
    rng = np.random.default_rng(seed)
    return _points([int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)])


def _host_msm(points, scalars):
    acc = kzg._msm(F1, [oracle.pt_from_affine(F1, p) for p in points], scalars)
    return None if acc is None else oracle.pt_to_affine(F1, acc)


def _neg(p):
    return (p[0], (-p[1]) % oracle.P)


# --- shape-only: digits and cost functions ------------------------------------------


@pytest.mark.parametrize("n,nbits,window", [(128, 255, 4), (128, 64, 4), (512, 255, 4),
                                            (64, 255, 5), (8, 64, 2), (488, 64, 3)])
def test_cost_functions_match_jax(n, nbits, window):
    assert B.g1_msm_op_counts(n, nbits, window) == JK.g1_msm_op_counts(n, nbits, window)
    assert B.g1_ladder_op_counts(n, nbits) == JK.g1_ladder_op_counts(n, nbits)
    assert sum(B.g1_msm_op_counts(n, nbits, window).values()) == JK.g1_msm_point_ops(
        n, nbits, window)
    assert sum(B.g1_ladder_op_counts(n, nbits).values()) == JK.g1_ladder_point_ops(n, nbits)


def test_cost_pins_at_the_kzg_shape():
    assert sum(B.g1_msm_op_counts(128, 255, 4).values()) == 10235
    assert sum(B.g1_ladder_op_counts(128, 255).values()) == 49024
    digits = B.msm_window_digits(torch.zeros((128, 255), dtype=torch.bool))
    assert digits.shape == (128, 64) == jax.eval_shape(
        JK.msm_window_digits, jnp.zeros((128, 255), dtype=bool)).shape


@pytest.mark.parametrize("nbits,window", [(64, 4), (255, 4), (255, 3)])
def test_data_op_counts_count_only_what_the_digits_need(nbits, window):
    """Dense digits give the shape's count; pads (scalar 0) and zero digits
    take their tables, tree adds and Horner steps away."""
    n = 16
    dense = int("".join("1" if i % window == 0 else "0" for i in range(nbits))[::-1], 2)
    sc = B.scalar_words([dense] * n, nbits)
    assert B.g1_msm_data_op_counts(sc, nbits, window) == B.g1_msm_op_counts(n, nbits, window)
    # 3 real items of one low digit each (windows 0, 0, 1), 13 pads
    sc = B.scalar_words([1, 2, 1 << window] + [0] * (n - 3), nbits)
    half = (1 << (window - 1)) - 1
    assert B.g1_msm_data_op_counts(sc, nbits, window) == {
        "doubles": 3 * half + window, "adds": 3 * half + 1 + 1}
    assert B.g1_msm_data_op_counts(B.scalar_words([0] * n, nbits), nbits, window) == {
        "doubles": 0, "adds": 0}


@pytest.mark.parametrize("window", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("nbits", [64, 255])
def test_window_digits_match_jax(window, nbits):
    bits = np.random.default_rng(window * nbits).integers(0, 2, (6, nbits)).astype(bool)
    want = np.asarray(JK.msm_window_digits(jnp.asarray(bits), window))
    got = B.msm_window_digits(torch.from_numpy(bits), window)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits", [8, 64, 255])
def test_scalar_words_give_jax_bits(nbits):
    rng = np.random.default_rng(nbits)
    scalars = [0, 1, 2**64 - 1, oracle.R - 1] + [int.from_bytes(rng.bytes(32), "little")
                                                 for _ in range(4)]
    bits = B._scalar_bits(B.scalar_words(scalars, nbits), nbits)
    assert np.array_equal(bits.numpy().astype(bool), JK._scalar_bits_lsb(scalars, nbits))


# --- the MSM against JAX's g1_msm_device and the host oracle -------------------------


def test_msm_device_matches_jax_64bit():
    """Bucket 8 at 64 bits: a zero scalar, scalar 1, 2^64 - 1, a repeated
    point, three (generator, 0) pads."""
    points = _points([2, 3, 3, 5, 9])
    scalars = [0xDEADBEEFCAFE, 0, 1, 0xFFFFFFFFFFFFFFFF, 7]
    got = B.g1_msm_device(points, scalars, 64, device="cpu")
    assert got == JK.g1_msm_device(points, scalars, 64) == _host_msm(points, scalars)


def test_msm_device_matches_jax_255bit():
    points = _seeded_points(1, 6)
    scalars = [int.from_bytes(np.random.default_rng(2).bytes(32), "little") % oracle.R]
    scalars += [pow(7, i + 1, oracle.R) for i in range(5)]
    got = B.g1_msm_device(points, scalars, 255, device="cpu")
    assert got == JK.g1_msm_device(points, scalars, 255) == _host_msm(points, scalars)


def test_msm_identity_is_none_like_jax():
    p = _points([6])[0]
    assert B.g1_msm_device(_points([2, 3, 4]), [0, 0, 0], 64, device="cpu") is None
    assert B.g1_msm_device([p, _neg(p)], [5, 5], 64, device="cpu") is None
    assert JK.g1_msm_device([p, _neg(p)], [5, 5], 64) is None


@pytest.mark.parametrize("window", [2, 3, 5])
def test_msm_windows_match_oracle_on_edge_cases(window):
    """Zero scalars, a P + (-P) cancellation inside the sum, repeated points
    and 2^64 - 1, at 64 and 255 bits."""
    pts = _seeded_points(window, 5)
    points = pts + [pts[1], _neg(pts[2]), pts[3]]
    for nbits, scalars in ((64, [2**64 - 1, 0, 11, 2**63, 9, 11, 11, 0]),
                           (255, [oracle.R - 1, 3, 2**200 + 5, 0, 1, 3, 2**200 + 5, 77])):
        got = B.g1_msm_device(points, scalars, nbits, window, device="cpu")
        assert got == _host_msm(points, scalars)


def test_msm_ignores_scalar_bits_above_nbits():
    """JAX reads nbits bits of a scalar; so do the words and the plain MSM."""
    points = _seeded_points(7, 3)
    scalars = [2**64 + 5, 2**70 + 3, 9]
    assert B.g1_msm_device(points, scalars, 64, device="cpu") == _host_msm(
        points, [s % 2**64 for s in scalars])


def test_msm_wrapper_rejects_bad_arguments():
    pts = B._jacobian_words(_points([2]), 0, "cpu")
    with pytest.raises(ValueError):
        B.g1_msm(pts, B.scalar_words([1], 64), 64, window=9)
    with pytest.raises(ValueError):
        B.g1_msm(pts, B.scalar_words([1], 255), 64)  # 8 words for 64 bits


# --- the subgroup check and the aggregate against JAX, 64-item bucket -----------------


def test_subgroup_check_matches_jax():
    """40 keys, the on-curve (0, 2) outside the subgroup, and pads to 64."""
    assert (2 * 2 - oracle.B_G1) % oracle.P == 0  # (0, 2) is on the curve
    points = _seeded_points(11, 39) + [(0, 2)]
    got = B.g1_subgroup_check_device(points, device="cpu")
    want = JK.g1_subgroup_check_device(points)
    assert got.dtype == bool and got.tolist() == want.tolist() == [True] * 39 + [False]


def test_subgroup_chain_matches_ladder_and_jax_off_the_subgroup():
    """K14's chain (phi(P) = -[x^2]·P), the r-ladder it replaced and JAX's
    `g1_subgroup_check_device` give the same booleans on 30 keys, (0, +-2)
    (order 3), 12 random curve points, 4 cofactor parts [r]·Q, 4 keys plus
    (0, 2) and 12 pads (the 64-item bucket), and match the oracle's
    [r]·P == infinity."""
    points, member = msm_synthetic.subgroup_edge_points(11)
    assert len(points) == 52 and sum(member) == 30
    got = B.g1_subgroup_check_device(points, device="cpu")
    want = JK.g1_subgroup_check_device(points)
    words = B._jacobian_words(points, 12, "cpu")
    r = B.scalar_words([oracle.R], 256).expand(words.shape[0], 8)
    ladder = fp.fp_is_zero(B.scalar_mul_limbs(B._Fp, fp.to_limbs(words), r)[:, 2])
    assert got.tolist() == want.tolist() == member
    assert B.g1_subgroup_check_plain(words).tolist() == ladder.tolist() == member + [True] * 12


def test_subgroup_chain_pins_beta_and_the_identity():
    """beta is a cube root of unity other than 1, and phi(P) = (beta·x, y)
    equals -[x^2]·P on 16 G1 points in the oracle's integers; the other root
    of unity does not."""
    beta, p = B.BETA, oracle.P
    assert pow(beta, 3, p) == 1 and beta != 1
    for q in _seeded_points(13, 16):
        minus = oracle.pt_neg(F1, oracle.pt_mul(F1, oracle.pt_from_affine(F1, q),
                                                oracle.X_PARAM ** 2))
        assert oracle.pt_to_affine(F1, minus) == (beta * q[0] % p, q[1])
        assert oracle.pt_to_affine(F1, minus) != (beta * beta * q[0] % p, q[1])


def test_subgroup_chain_op_counts():
    """126 doubles, 10 adds and 9 compare products a key, which is what the
    plain chain computes for a key: 1,051 Fp products."""
    assert B.g1_subgroup_chain_op_counts(1) == {"doubles": 126, "adds": 10, "fp_muls": 9}
    assert B.g1_subgroup_chain_op_counts(512) == {"doubles": 64512, "adds": 5120,
                                                  "fp_muls": 4608}
    key = B._jacobian_words(_seeded_points(14, 1), 0, "cpu")
    before = fp.plain_muls
    assert B.g1_subgroup_check_plain(key).tolist() == [True]
    assert fp.plain_muls - before == 126 * 7 + 10 * 16 + 9 == 1051


def _segments(case):
    """(Jacobian words, segment lengths, each segment's affine sum) of one
    segment_sums case."""
    keys = _seeded_points(31, 6)
    if case == "committee":  # the block's first committee, 512 keys
        pts, total = msm_synthetic.committee_keys(0)
        return B._jacobian_words(pts, 0, "cpu"), [512], [total]
    if case == "opposite":  # P + (-P), Q + (-Q) + S, a lone key
        pts = [keys[0], _neg(keys[0]), keys[1], _neg(keys[1]), keys[2], keys[3]]
        return B._jacobian_words(pts, 0, "cpu"), [2, 3, 1], [None, keys[2], keys[3]]
    if case == "double":  # P + P (the complete add's double), Q + Q + S, G + 2G + G
        two = _points([2])[0]
        pts = [keys[0], keys[0], keys[1], keys[1], keys[2], oracle.G1_GEN_AFF, two,
               oracle.G1_GEN_AFF]
        want = [_host_msm(keys[:1], [2]), _host_msm(keys[1:3], [2, 1]), _points([4])[0]]
        return B._jacobian_words(pts, 0, "cpu"), [2, 3, 3], want
    # pads: Jacobian zeros among six keys, then a segment of pads alone
    words = B._jacobian_words(keys, 10, "cpu")
    words = torch.cat([words[:2], words[6:10], words[2:6], words[10:]])
    return words, [10, 6], [_host_msm(keys, [1] * 6), None]


@pytest.mark.parametrize("case", ["committee", "opposite", "double", "pads"])
def test_segment_sums_do_not_depend_on_the_units(case):
    """K10's limb G1 sums are affine, one canonical encoding a point, so the
    order of the adds does not show: the plain version's 64 units (the
    kernel's 64 four-lane groups) and 256 units (one thread a unit over 256
    threads) give equal words, and the oracle's sums."""
    words, lengths, want = _segments(case)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int64)
    sums = [fp.to_words(B.segment_sums_limbs(B._Fp, fp.to_limbs(words), offsets, units))
            for units in (64, 256)]
    assert torch.equal(sums[0], sums[1])
    assert [B._affine_or_none(s) for s in sums[0]] == want


def test_aggregate_matches_jax():
    pts = _seeded_points(12, 40)
    got = B.g1_aggregate_device(pts, device="cpu")
    assert got == JK.g1_aggregate_device(pts) == _host_msm(pts, [1] * 40)
    cancel = pts[:20] + [_neg(p) for p in pts[:20]]
    assert B.g1_aggregate_device(cancel, device="cpu") is None
    assert JK.g1_aggregate_device(cancel) is None
