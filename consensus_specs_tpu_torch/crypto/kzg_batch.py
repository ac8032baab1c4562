"""Batched KZG verification on the card (counterpart of the JAX package's
crypto/kzg_batch.py).

A block carries up to 128 data-blob commitments, each with sample and
degree proofs. A sample's check `verify_coset` (crypto/kzg.py) is one
2-pairing check; this module folds N of them into ONE 2-pairing check and
two G1 MSMs, by two identities:

1. Bilinearity moves the vanishing polynomial's scalar to G1: the item's
   e(proof, [s^m - zm]G2) == e(C - I, G2), zm = shift^m, becomes
       e(proof, [s^m]G2) · e(-zm·proof - C + I, G2) == 1,
   whose G2 inputs (a setup power and the generator) no longer depend on
   the item.
2. A random linear combination with 64-bit r_i from the CSPRNG (soundness
   error 2^-64): all N hold iff
       e(sum r_i·proof_i, [s^m]G2) · e(sum r_i·(-zm_i·proof_i - C_i) + I*, G2) == 1,
   where I* = commit(sum r_i·i_coeffs_i) folds the interpolants into one
   m-term MSM in coefficient space.

Device work: two bucket MSMs (`ops/bls12.g1_msm_device`, K13: 64-bit
scalars for the r_i side, 255-bit for the folded side) and one 2-pairing
check (`ops/bls12.pairing_check_batch`, K11 + K12). Host work an item: an
m-point interpolation and two products mod r. Degree proofs fold the same
way: e(sum r_i·D_i, G2) · e(sum r_i·(-C_i), [s^(M+1-k)]G2) == 1 for a shared
points count k.

The JAX package serves both batch checks through its scheduler's kzg work
class; the port has no scheduler yet, so `batch_verify_samples` and
`batch_verify_degree_proofs` call their implementations directly.
"""
from __future__ import annotations

import secrets

from ..ops import bls12 as K
from ..utils.device import resolve_device
from . import bls12_381 as oracle
from . import bls_torch, kzg
from .bls12_381 import FP_FIELD, P, pt_to_affine
from .kzg import MODULUS, KZGSetup

_SOUND_BITS = 64


def _rand_scalars(n: int) -> list[int]:
    return [secrets.randbelow(2**_SOUND_BITS - 1) + 1 for _ in range(n)]


def _aff(p):
    """Oracle point (Jacobian or affine) -> affine int pair (or None)."""
    if p is None:
        return None
    if isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], int):
        return p
    return pt_to_affine(FP_FIELD, p)


def _neg(aff):
    return (aff[0], (P - aff[1]) % P)


def _is_aff_g2(p) -> bool:
    return (isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], tuple)
            and len(p[0]) == 2 and isinstance(p[0][0], int))


def _check_two_pairings(p1, q2_point, p2, device) -> bool:
    """e(p1, q2_point) · e(p2, G2) == 1: one 2-pairing check on `device`, or
    the host oracle when either G1 input is the identity, which the affine
    words cannot carry."""
    if p1 is None or p2 is None:
        return kzg._pairings_equal(
            None if p1 is None else oracle.pt_from_affine(FP_FIELD, p1), q2_point,
            None if p2 is None else oracle.pt_from_affine(FP_FIELD, _neg(p2)), oracle.G2_GEN)
    q1 = q2_point if _is_aff_g2(q2_point) else pt_to_affine(oracle.FP2_FIELD, q2_point)
    _, args = bls_torch._pack_pairing_args([p1], [q1], [p2], [oracle.G2_GEN_AFF], device)
    return bool(K.pairing_check_batch(*args)[0])


def batch_verify_samples(setup: KZGSetup, items, device="cuda") -> bool:
    """All of `items` verify, each (commitment, coset_shift, ys, proof) as
    `verify_coset` takes them, in one randomized check. Empty or odd ys, m
    beyond the setup, a zero shift or an identity point reject the batch."""
    return _verify_samples_impl(setup, items, device)


def _verify_samples_impl(setup: KZGSetup, items, device="cuda") -> bool:
    items = list(items)
    if not items:
        return True
    m = len(items[0][2])
    if m == 0 or m & (m - 1) != 0 or m > setup.max_degree:
        return False
    rs = _rand_scalars(len(items))
    folded = [0] * m
    p1_pts, p1_sc = [], []  # sum r_i·proof_i                  (64-bit scalars)
    p2_pts, p2_sc = [], []  # sum r_i(-zm_i·proof_i - C_i) + I*  (255-bit)
    for (commitment, shift, ys, proof), r in zip(items, rs):
        if len(ys) != m or any(not 0 <= y < MODULUS for y in ys):
            return False
        c_aff, pr_aff = _aff(commitment), _aff(proof)
        if c_aff is None or pr_aff is None:
            return False
        zm = pow(shift % MODULUS, m, MODULUS)
        if zm == 0:
            return False
        for j, c in enumerate(kzg.interpolate_on_domain(ys, shift=shift)):
            folded[j] = (folded[j] + r * c) % MODULUS
        p1_pts.append(pr_aff)
        p1_sc.append(r)
        p2_pts.append(_neg(pr_aff))
        p2_sc.append(r * zm % MODULUS)
        p2_pts.append(_neg(c_aff))
        p2_sc.append(r)
    for j in range(m):
        if folded[j]:
            p2_pts.append(_aff(setup.g1[j]))
            p2_sc.append(folded[j])
    dev = resolve_device(device)
    a = K.g1_msm_device(p1_pts, p1_sc, _SOUND_BITS, device=dev)
    b = K.g1_msm_device(p2_pts, p2_sc, 255, device=dev)
    return _check_two_pairings(a, setup.g2[m], b, dev)


def batch_verify_degree_proofs(setup: KZGSetup, items, points_count: int,
                               device="cuda") -> bool:
    """All of `items` = (commitment, degree_proof) satisfy deg < points_count
    (`verify_degree_proof`), in one randomized check:
        e(sum r_i·D_i, G2) · e(sum r_i·(-C_i), [s^(M+1-k)]G2) == 1."""
    return _verify_degree_proofs_impl(setup, items, points_count, device)


def _verify_degree_proofs_impl(setup: KZGSetup, items, points_count: int,
                               device="cuda") -> bool:
    items = list(items)
    if not items:
        return True
    k = points_count
    if not 0 < k <= setup.max_degree + 1:
        return False
    rs = _rand_scalars(len(items))
    d_pts, c_pts = [], []
    for commitment, degree_proof in items:
        c_aff, d_aff = _aff(commitment), _aff(degree_proof)
        if c_aff is None or d_aff is None:
            return False
        d_pts.append(d_aff)
        c_pts.append(_neg(c_aff))
    dev = resolve_device(device)
    a = K.g1_msm_device(d_pts, rs, _SOUND_BITS, device=dev)
    b = K.g1_msm_device(c_pts, rs, _SOUND_BITS, device=dev)
    # e(A, G2) · e(B, [s^shift]G2) == 1 in the helper's shape e(B, q2)·e(A, G2)
    return _check_two_pairings(b, setup.g2[setup.max_degree + 1 - k], a, dev)


def verify_samples_attributed(setup: KZGSetup, items, device="cuda"):
    """Batch first, per-item attribution on failure: (all_ok, verdicts), the
    verdicts None on the batch's fast path. The batch is stricter than N
    `verify_coset` calls (an identity proof, a zero shift or mixed sample
    sizes reject it), so on any batch failure each item is re-checked with
    the host oracle's `kzg.verify_coset`."""
    items = list(items)
    if batch_verify_samples(setup, items, device=device):
        return True, None
    verdicts = [kzg.verify_coset(setup, commitment, shift, ys, proof)
                for commitment, shift, ys, proof in items]
    return all(verdicts), verdicts
