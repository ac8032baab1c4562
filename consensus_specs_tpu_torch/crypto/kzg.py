"""KZG10 polynomial commitments over BLS12-381 (sharding/DAS crypto layer).

Reference parity: the sharding spec's commitment machinery —
`DataCommitment`/degree-proof containers and the pairing checks in
`process_shard_header` (specs/sharding/beacon-chain.md:241-249,675-766:
`e(degree_proof, G2) == e(commitment, G2_SETUP[-points_count])`), the trusted
setup constants `G1_SETUP`/`G2_SETUP`/`ROOT_OF_UNITY` (:170-174), and the DAS
spec's `check_multi_kzg_proof` (specs/das/das-core.md:131-137). The reference
never ships executable KZG (its sharding fork is R&D-only and uncompiled);
here the full commit/open/verify path is implemented and tested.

The port's own copy of the JAX package's crypto/kzg.py (the host KZG
module), unchanged but for this docstring's layering notes and the comment
at the imports, so that the port imports nothing of that package.

Layering:
- polynomial arithmetic over Fr: host ints here (ops/fr_host.py);
- group/pairing ops: crypto/bls12_381.py pure-Python oracle; the batched
  verification's MSMs and pairing run on the card (crypto/kzg_batch.py);
- the trusted setup here is an INSECURE deterministic test setup (the secret
  is derived from a fixed tag) — mainnet setups come from a ceremony and are
  loaded as data, exactly as the reference treats G1_SETUP/G2_SETUP as
  externally-supplied constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from hashlib import sha256

from ..ops.fr_host import R_MODULUS, root_of_unity
from .bls12_381 import (
    F12_ONE,
    FP2_FIELD,
    FP_FIELD,
    G1_GEN,
    G2_GEN,
    g1_to_bytes,
    multi_pairing,
    pt_add,
    pt_mul,
    pt_neg,
    pt_to_affine,
)

MODULUS = R_MODULUS  # curve order; sharding spec's `MODULUS` (:107)


# --- polynomial helpers (host ints mod r) -----------------------------------


def eval_poly_at(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % MODULUS
    return acc


def poly_quotient_linear(coeffs: list[int], z: int, y: int) -> list[int]:
    """(P(x) - y) / (x - z) by synthetic division; exact iff P(z) == y."""
    n = len(coeffs)
    q = [0] * (n - 1)
    carry = 0
    for i in range(n - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % MODULUS
        q[i - 1] = carry
    remainder = (coeffs[0] + carry * z - y) % MODULUS
    assert remainder == 0, "point not on polynomial"
    return q


def interpolate_on_domain(values: list[int], shift: int = 1) -> list[int]:
    """Coefficients of the unique poly with P(shift·w^i) = values[i] over the
    n-th-root domain (n = len(values), power of two): inverse DFT + unshift."""
    n = len(values)
    w_inv = pow(root_of_unity(n), MODULUS - 2, MODULUS)
    n_inv = pow(n, MODULUS - 2, MODULUS)
    coeffs = []
    for i in range(n):
        acc = 0
        for j, v in enumerate(values):
            acc = (acc + v * pow(w_inv, i * j, MODULUS)) % MODULUS
        coeffs.append(acc * n_inv % MODULUS)
    if shift != 1:
        s_inv = pow(shift, MODULUS - 2, MODULUS)
        scale = 1
        for i in range(n):
            coeffs[i] = coeffs[i] * scale % MODULUS
            scale = scale * s_inv % MODULUS
    return coeffs


# --- trusted setup -----------------------------------------------------------


@dataclass(frozen=True)
class KZGSetup:
    """`G1_SETUP` / `G2_SETUP` of the sharding spec (:170-173): powers of a
    secret s on both curve sides; first entry is the generator."""

    g1: tuple  # tuple of Jacobian points, g1[i] = s^i * G1
    g2: tuple
    length: int

    @property
    def max_degree(self) -> int:
        return self.length - 1


def insecure_test_setup(n: int, tag: bytes = b"consensus-specs-tpu kzg test setup") -> KZGSetup:
    """Deterministic setup for tests; the 'secret' is public by construction."""
    s = int.from_bytes(sha256(tag).digest(), "little") % MODULUS
    g1, g2, acc = [], [], 1
    for _ in range(n):
        g1.append(pt_mul(FP_FIELD, G1_GEN, acc))
        g2.append(pt_mul(FP2_FIELD, G2_GEN, acc))
        acc = acc * s % MODULUS
    return KZGSetup(g1=tuple(g1), g2=tuple(g2), length=n)


# --- commit / prove / verify -------------------------------------------------


def _msm(field, points, scalars):
    """sum scalars[i]·points[i] over either group (host double-and-add; the
    device Pippenger kernel is the planned replacement)."""
    acc = None
    for pt, k in zip(points, scalars):
        k %= MODULUS
        if k == 0 or pt is None:
            continue
        term = pt_mul(field, pt, k)
        acc = term if acc is None else pt_add(field, acc, term)
    return acc


def _msm_g1(setup_points, scalars):
    return _msm(FP_FIELD, setup_points, scalars)


def commit(setup: KZGSetup, coeffs: list[int]):
    """C = P(s)·G1, computed as an MSM over the G1 setup. Returns Jacobian."""
    assert len(coeffs) <= setup.length, "polynomial exceeds setup degree"
    return _msm_g1(setup.g1, coeffs)


def commit_bytes(setup: KZGSetup, coeffs: list[int]) -> bytes:
    """Compressed 48-byte `BLSCommitment` (sharding spec :92)."""
    return g1_to_bytes(pt_to_affine(FP_FIELD, commit(setup, coeffs)))


def _pairings_equal(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2) via one multi-pairing: e(a1,a2)·e(-b1,b2) == 1."""
    nb1 = None if b1 is None else pt_neg(FP_FIELD, b1)
    aff = lambda F, p: None if p is None else pt_to_affine(F, p)
    res = multi_pairing(
        [
            (aff(FP_FIELD, a1), aff(FP2_FIELD, a2)),
            (aff(FP_FIELD, nb1), aff(FP2_FIELD, b2)),
        ]
    )
    return res == F12_ONE


def prove_degree_bound(setup: KZGSetup, coeffs: list[int], points_count: int):
    """Degree proof for `deg P < points_count`: commit to x^(M+1-k)·P(x)
    (sharding spec :716-719,766 — the shifted poly only fits in the setup if
    the bound holds)."""
    k = points_count
    assert 0 < k <= setup.max_degree + 1, "bound outside setup range"
    shift = setup.max_degree + 1 - k
    assert len(coeffs) <= k, "cannot prove a bound the polynomial violates"
    shifted = [0] * shift + list(coeffs)
    return commit(setup, shifted)


def verify_degree_proof(setup: KZGSetup, commitment, degree_proof, points_count: int) -> bool:
    """e(degree_proof, G2) == e(commitment, G2·s^(M+1-k)) (spec :716-719).

    An out-of-range bound claim is a rejection, never an index-wrap onto a
    different setup power (points_count is attacker-controlled input)."""
    k = points_count
    if not 0 < k <= setup.max_degree + 1:
        return False
    return _pairings_equal(
        degree_proof, setup.g2[0], commitment, setup.g2[setup.max_degree + 1 - k]
    )


def prove_at(setup: KZGSetup, coeffs: list[int], z: int):
    """Opening proof at z: commit to (P(x) - P(z)) / (x - z)."""
    y = eval_poly_at(coeffs, z)
    q = poly_quotient_linear(coeffs, z, y)
    return commit(setup, q), y


def verify_at(setup: KZGSetup, commitment, z: int, y: int, proof) -> bool:
    """e(proof, s·G2 - z·G2) == e(C - y·G1, G2)."""
    z_g2 = pt_mul(FP2_FIELD, G2_GEN, z % MODULUS)
    s_minus_z = pt_add(FP2_FIELD, setup.g2[1], pt_neg(FP2_FIELD, z_g2)) if z_g2 is not None else setup.g2[1]
    y_g1 = pt_mul(FP_FIELD, G1_GEN, y % MODULUS)
    c_minus_y = commitment if y_g1 is None else pt_add(FP_FIELD, commitment, pt_neg(FP_FIELD, y_g1))
    return _pairings_equal(proof, s_minus_z, c_minus_y, setup.g2[0])


def prove_coset(setup: KZGSetup, coeffs: list[int], coset_shift: int, m: int):
    """Multi-point proof over the coset {shift·w^i} of the m-th roots:
    commit to Q = (P - I) / Z with Z(x) = x^m - shift^m (the coset's
    vanishing poly) and I the degree-<m interpolant of P on the coset.
    This is the DAS spec's multi-proof shape (das-core.md:131-137)."""
    w = root_of_unity(m)
    ys = [eval_poly_at(coeffs, coset_shift * pow(w, i, MODULUS) % MODULUS) for i in range(m)]
    i_coeffs = interpolate_on_domain(ys, shift=coset_shift)
    # numerator N = P - I
    n_coeffs = list(coeffs)
    for i, c in enumerate(i_coeffs):
        n_coeffs[i] = (n_coeffs[i] - c) % MODULUS
    # divide by Z(x) = x^m - shift^m: long division, stride m
    zm = pow(coset_shift, m, MODULUS)
    q = [0] * max(len(n_coeffs) - m, 0)
    rem = list(n_coeffs)
    for i in range(len(n_coeffs) - 1, m - 1, -1):
        q[i - m] = rem[i]
        rem[i] = 0
        rem[i - m] = (rem[i - m] + q[i - m] * zm) % MODULUS
    assert all(r == 0 for r in rem), "coset values not on polynomial"
    return commit(setup, q) if q else None, ys


def verify_coset(setup: KZGSetup, commitment, coset_shift: int, ys: list[int], proof) -> bool:
    """e(proof, commit_G2(Z)) == e(C - commit_G1(I), G2)  — `check_multi_kzg_proof`.

    ys length is untrusted (it arrives inside a network sample): reject
    rather than crash when it is empty, not a power of two (no NTT domain),
    or beyond the setup (setup.g2[m] must exist)."""
    m = len(ys)
    if m == 0 or m & (m - 1) != 0 or m > setup.max_degree:
        return False
    zm = pow(coset_shift, m, MODULUS)
    # Z(x) = x^m - shift^m on the G2 side
    z_g2 = pt_add(
        FP2_FIELD, setup.g2[m], pt_neg(FP2_FIELD, pt_mul(FP2_FIELD, G2_GEN, zm))
    )
    i_coeffs = interpolate_on_domain(ys, shift=coset_shift)
    i_commit = _msm_g1(setup.g1, i_coeffs)
    c_minus_i = (
        commitment if i_commit is None else pt_add(FP_FIELD, commitment, pt_neg(FP_FIELD, i_commit))
    )
    return _pairings_equal(proof, z_g2, c_minus_i, setup.g2[0])
