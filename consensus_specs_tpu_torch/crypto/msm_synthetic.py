"""Seeded inputs at mainnet size for the committee-key aggregation and the
KZG batch checks, made on the host with the port's copied oracle (no key
files, no network).

- `block_aggregate_inputs`: the FastAggregateVerify calls of one altair
  block at N = 2^20 validators, as bytes: MAX_ATTESTATIONS = 128 attestation
  aggregates over committees of 512 and the sync aggregate of
  SYNC_COMMITTEE_SIZE = 512, 66,048 distinct keys (the sync committee drawn
  apart from the attesters). Secret keys are consecutive, sk_0 + j, so key
  j + 1 is key j plus G1: one scalar multiplication and 66,047 point
  additions make every key. A call's aggregate signature is [sum sk]·H(m),
  computed directly, as `bls_synthetic.flush_inputs` does.
- `kzg_inputs`: one block's KZG sample items at the shape of the JAX
  package's KZG benchmark: 128 blobs of KZG_POINTS = 32 points under
  `insecure_test_setup(64)`, one sampled coset of m = 8 points a blob, and
  the 128 blobs' degree proofs for deg < 32. The test setup's secret s is
  public, so a commitment is [P(s)]·G1, a sample proof [Q(s)]·G1 with
  Q = (P - I)/(x^m - shift^m), a degree proof [s^(M+1-k)·P(s)]·G1: one
  scalar multiplication each instead of an MSM over the setup
  (tests/test_torch_kzg_batch.py holds them equal to `kzg.commit`,
  `prove_coset` and `prove_degree_bound` at a small size).
"""
from __future__ import annotations

from hashlib import sha256

import numpy as np

from ..ops.fr_host import root_of_unity
from . import bls12_381 as oracle
from . import bls_torch, kzg
from .bls_synthetic import COMMITTEE_SIZE, MAX_ATTESTATIONS, SYNC_COMMITTEE_SIZE

KZG_BLOBS = 128  # data blobs a block carries (the sharding mainnet preset)
KZG_POINTS = 32  # points a blob: verification costs the same at any blob size
KZG_SAMPLE = 8  # POINTS_PER_SAMPLE
KZG_SETUP = 2 * KZG_POINTS  # setup powers


def _affine_all(points) -> list:
    """Jacobian oracle points (Z != 0) -> affine pairs, one inversion in all
    (Montgomery's trick)."""
    P = oracle.P
    prefix, acc = [], 1
    for _, _, z in points:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, P - 2, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z = points[i]
        zi = inv * prefix[i] % P
        inv = inv * z % P
        zi2 = zi * zi % P
        out[i] = (x * zi2 % P, y * zi2 * zi % P)
    return out


def block_aggregate_inputs(seed: int) -> dict:
    """The block's 129 FastAggregateVerify calls from `seed`: a dict with
    `calls` [(pubkeys, message, signature)] (128 attestations, then the sync
    aggregate; bytes), `aggregates` (each call's [sum sk]·G1, affine) and
    `keys` {compressed key: affine} for every key."""
    F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
    rng = np.random.default_rng(seed)
    sizes = [COMMITTEE_SIZE] * MAX_ATTESTATIONS + [SYNC_COMMITTEE_SIZE]
    sk0 = int(rng.integers(1, 2**62))
    pt = oracle.pt_mul(F1, oracle.G1_GEN, sk0)
    jac = []
    for _ in range(sum(sizes)):
        jac.append(pt)
        pt = oracle.pt_add(F1, pt, oracle.G1_GEN)
    affs = _affine_all(jac)
    pks = [oracle.g1_to_bytes(a) for a in affs]
    calls, aggregates, start = [], [], 0
    for size in sizes:
        sk = (size * sk0 + size * start + size * (size - 1) // 2) % oracle.R
        msg = rng.bytes(32)
        h = oracle.pt_from_affine(F2, bls_torch.hash_to_curve_g2(msg))
        sig = oracle.g2_to_bytes(oracle.pt_to_affine(F2, oracle.pt_mul(F2, h, sk)))
        calls.append((pks[start:start + size], msg, sig))
        aggregates.append(oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, sk)))
        start += size
    return dict(calls=calls, aggregates=aggregates, keys=dict(zip(pks, affs)))


def kzg_inputs(seed: int, blobs: int = KZG_BLOBS, points: int = KZG_POINTS,
               m: int = KZG_SAMPLE, setup_size: int = KZG_SETUP) -> dict:
    """One block's KZG items from `seed`: a dict with `setup`
    (`kzg.insecure_test_setup(setup_size)`), `coeffs` (each blob's
    polynomial), `samples` [(commitment, shift, ys, proof)], `degree_proofs`
    [(commitment, degree proof)] and `points_count` (the bound they prove);
    points are the oracle's Jacobian triples with Z = 1, as `verify_coset`
    takes them. Blob b's sample is the coset shift·<w_m> with
    shift = w^(b mod (2·points / m)), w the (2·points)-th root of unity."""
    F1 = oracle.FP_FIELD
    r = kzg.MODULUS
    setup = kzg.insecure_test_setup(setup_size)
    s = int.from_bytes(sha256(b"consensus-specs-tpu kzg test setup").digest(), "little") % r
    n2 = 2 * points
    w, wm = root_of_unity(n2), root_of_unity(m)
    rng = np.random.default_rng(seed)

    def g1(k):
        return oracle.pt_from_affine(F1, oracle.pt_to_affine(
            F1, oracle.pt_mul(F1, oracle.G1_GEN, k % r)))

    polys, samples, degree_proofs = [], [], []
    for b in range(blobs):
        coeffs = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(points)]
        polys.append(coeffs)
        p_s = kzg.eval_poly_at(coeffs, s)
        shift = pow(w, b % (n2 // m), r)
        ys = [kzg.eval_poly_at(coeffs, shift * pow(wm, i, r) % r) for i in range(m)]
        i_s = kzg.eval_poly_at(kzg.interpolate_on_domain(ys, shift=shift), s)
        z_s = (pow(s, m, r) - pow(shift, m, r)) % r
        commitment = g1(p_s)
        samples.append((commitment, shift, ys, g1((p_s - i_s) * pow(z_s, r - 2, r))))
        degree_proofs.append((commitment, g1(pow(s, setup.max_degree + 1 - points, r) * p_s)))
    return dict(setup=setup, coeffs=polys, samples=samples, degree_proofs=degree_proofs,
                points_count=points)
