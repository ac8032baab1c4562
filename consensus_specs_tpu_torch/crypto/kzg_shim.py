"""KZG shim for the executable sharding spec.

The role `utils/bls.py` plays for signatures (reference utils/bls.py:6,33-44:
a single boundary with a `bls_active` kill-switch so the fast test matrix can
skip the expensive crypto), this module plays for the sharding spec's
polynomial-commitment checks (`process_shard_header`'s degree-bound pairing,
reference specs/sharding/beacon-chain.md:716-719). The compiled spec modules
see this module as `kzg` (compiler namespace), the same way they see the BLS
shim as `bls`.

The trusted setup (`G1_SETUP`/`G2_SETUP`, reference :172-173) is
externally-supplied ceremony data the spec treats as constants; here it is
process-global installable state (`use_setup`), with
`crypto/kzg.insecure_test_setup` as the test-time source. When `bls.bls_active`
is off (stub-crypto test mode) every check passes, mirroring the BLS
kill-switch contract.

The port's own copy of the JAX package's crypto/kzg_shim.py, unchanged below
this docstring, so that the port imports nothing of that package.
"""
from __future__ import annotations

from . import bls, kzg
from .bls12_381 import g1_from_bytes, g1_to_bytes, pt_from_affine, pt_to_affine
from .kzg import FP_FIELD, KZGSetup

_setup: KZGSetup | None = None


def use_setup(setup: KZGSetup | None) -> None:
    """Install (or with None, clear) the process-global trusted setup."""
    global _setup
    _setup = setup


def get_setup() -> KZGSetup:
    assert _setup is not None, "no KZG setup installed (kzg_shim.use_setup)"
    return _setup


def identity_commitment() -> bytes:
    """Compressed `G1_SETUP[0]` — the required degree proof for zero-length
    blobs (reference :713-714)."""
    return g1_to_bytes(pt_to_affine(FP_FIELD, get_setup().g1[0]))


def is_identity_commitment(proof: bytes) -> bool:
    if not bls.bls_active:
        return True
    return bytes(proof) == identity_commitment()


def verify_degree_bound(commitment: bytes, degree_proof: bytes, points_count: int) -> bool:
    """e(degree_proof, G2_SETUP[0]) == e(commitment, G2_SETUP[-points_count])
    (reference :716-719) over compressed inputs; decompression failures are
    rejections (both fields arrive from the network inside a block body)."""
    if not bls.bls_active:
        return True
    if int(points_count) == 0:
        # Zero-length blob (reference :714-719): the pairing degenerates to
        # e(proof, G2[0]) == e(commitment, G2[-0]) == e(commitment, G2[0]),
        # i.e. commitment == degree_proof == G1_SETUP[0]. Check by equality —
        # kzg.verify_degree_proof rejects k == 0 as out of setup range.
        ident = identity_commitment()
        return bytes(commitment) == ident and bytes(degree_proof) == ident
    try:
        c = pt_from_affine(FP_FIELD, g1_from_bytes(bytes(commitment)))
        p = pt_from_affine(FP_FIELD, g1_from_bytes(bytes(degree_proof)))
    except ValueError:
        return False
    return kzg.verify_degree_proof(get_setup(), c, p, int(points_count))


def commit_to_data(points: list[int]) -> bytes:
    """Builder-side helper: commitment for a blob's scalar points (the data
    IS the evaluation form at the setup's domain in the real protocol; the
    test harness commits to the coefficient form directly)."""
    if not bls.bls_active:
        return b"\xc0" + b"\x00" * 47
    if len(points) == 0:
        # Zero-length blob: commitment == degree_proof == G1_SETUP[0]
        # (reference :714-719 — the degenerate pairing forces both).
        return identity_commitment()
    return kzg.commit_bytes(get_setup(), [p % kzg.MODULUS for p in points])


def prove_degree_bound_bytes(points: list[int], points_count: int) -> bytes:
    if not bls.bls_active:
        return b"\xc0" + b"\x00" * 47
    if points_count == 0:
        return identity_commitment()
    proof = kzg.prove_degree_bound(get_setup(), [p % kzg.MODULUS for p in points], points_count)
    return g1_to_bytes(pt_to_affine(FP_FIELD, proof))


# --- das spec surface (specs/das/das-core.md) -------------------------------


def check_multi_kzg_proof(commitment: bytes, proof: bytes, x: int, ys: list) -> bool:
    """One multiproof check: does `proof` complement evaluations `ys` on the
    coset x·H (H the len(ys)-element subgroup) to match `commitment`?
    (reference specs/das/das-core.md:131-137, left `...` there; executable
    here via crypto/kzg.verify_coset). Compressed inputs arrive from the
    network — decompression failures are rejections."""
    if not bls.bls_active:
        return True
    try:
        c = pt_from_affine(FP_FIELD, g1_from_bytes(bytes(commitment)))
        p = pt_from_affine(FP_FIELD, g1_from_bytes(bytes(proof)))
    except ValueError:
        return False
    return kzg.verify_coset(
        get_setup(), c, int(x) % kzg.MODULUS,
        [int(y) % kzg.MODULUS for y in ys], p,
    )


def construct_proofs_bytes(poly_coeffs: list, points_per_sample: int) -> list:
    """Multiproofs for every aligned coset of the extended polynomial,
    indexed by DOMAIN position p (the coset w_{n2}^p · H). The reference
    stubs this as FK20 (das-core.md:138-146); per-coset quotient proofs are
    functionally equivalent (FK20 batch proving is a planned kernel)."""
    n2 = len(poly_coeffs)
    sample_count = n2 // points_per_sample
    if not bls.bls_active:
        return [b"\xc0" + b"\x00" * 47] * sample_count
    coeffs = [int(c) % kzg.MODULUS for c in poly_coeffs]
    # extended-data polynomial: degree < n, top half must be zero
    assert all(c == 0 for c in coeffs[n2 // 2:]), "not an extension polynomial"
    coeffs = coeffs[: n2 // 2]
    from ..ops.fr_host import root_of_unity

    w = root_of_unity(n2)
    setup = get_setup()
    out = []
    for p in range(sample_count):
        proof, _ = kzg.prove_coset(setup, coeffs, pow(w, p, kzg.MODULUS), points_per_sample)
        out.append(g1_to_bytes(pt_to_affine(FP_FIELD, proof)))
    return out
