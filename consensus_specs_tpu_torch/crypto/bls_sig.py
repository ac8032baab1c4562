"""IETF BLS signatures over BLS12-381 (ciphersuite G2_XMD:SHA-256_SSWU_RO_POP_).

Scheme-level API in the byte domain (48-byte compressed pubkeys, 96-byte
compressed signatures) matching the surface the reference consumes from
py_ecc/milagro (eth2spec/utils/bls.py:47-110): Sign, Verify, Aggregate,
AggregateVerify, FastAggregateVerify, AggregatePKs, SkToPk, KeyValidate.

Invalid inputs (bad encodings, off-curve, wrong subgroup, infinity pubkeys)
make verification return False rather than raise — the behavior the
conformance BLS vectors demand.
"""
from __future__ import annotations

from functools import lru_cache

from . import bls12_381 as c
from .hash_to_curve import hash_to_curve_g2

G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95


def SkToPk(privkey: int) -> bytes:
    if not 0 < privkey < c.R:
        raise ValueError("privkey out of range")
    return c.g1_to_bytes(c.pt_to_affine(c.FP_FIELD, c.pt_mul(c.FP_FIELD, c.G1_GEN, privkey)))


def KeyValidate(pubkey: bytes) -> bool:
    try:
        pk = c.g1_from_bytes(bytes(pubkey))
    except ValueError:
        return False
    return pk is not None  # infinity pubkey is invalid


def Sign(privkey: int, message: bytes) -> bytes:
    if not 0 < privkey < c.R:
        raise ValueError("privkey out of range")
    h = hash_to_curve_g2(bytes(message))
    sig = c.pt_to_affine(c.FP2_FIELD, c.pt_mul(c.FP2_FIELD, c.pt_from_affine(c.FP2_FIELD, h), privkey))
    return c.g2_to_bytes(sig)


def signature_to_point(signature: bytes):
    return c.g2_from_bytes(bytes(signature))


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    try:
        pk = c.g1_from_bytes(bytes(pubkey))
        sig = c.g2_from_bytes(bytes(signature))
    except ValueError:
        return False
    if pk is None:  # infinity pubkey always invalid
        return False
    h = hash_to_curve_g2(bytes(message))
    # e(pk, H(m)) == e(G1, sig)  <=>  e(-G1, sig) * e(pk, H(m)) == 1
    neg_g1 = (c.G1_GEN_AFF[0], c.P - c.G1_GEN_AFF[1])
    return c.multi_pairing([(neg_g1, sig), (pk, h)]) == c.F12_ONE


@lru_cache(maxsize=1 << 16)
def _sig_point_memo(signature: bytes):
    """Decompressed, subgroup-checked G2 point for one compressed signature.

    Decompression pays an Fp2 sqrt plus a full scalar-mul subgroup check;
    a streaming aggregation workload (the attestation firehose) decodes
    the same committee signatures on every re-sighting, so the memo turns
    the dominant admission cost into a dict hit. Pure and deterministic
    (points are nested int tuples), bounded so an adversarial stream of
    unique garbage cannot grow it without bound; ValueErrors are not
    cached by lru_cache, so malformed bytes keep raising."""
    return c.g2_from_bytes(bytes(signature))


def clear_sig_point_cache() -> None:
    _sig_point_memo.cache_clear()


def Aggregate(signatures) -> bytes:
    if len(signatures) == 0:
        raise ValueError("Aggregate requires at least one signature")
    acc = None
    for s in signatures:
        pt = _sig_point_memo(bytes(s))
        acc = c.pt_add(c.FP2_FIELD, acc, c.pt_from_affine(c.FP2_FIELD, pt))
    return c.g2_to_bytes(c.pt_to_affine(c.FP2_FIELD, acc))


def AggregatePKs(pubkeys) -> bytes:
    if len(pubkeys) == 0:
        raise ValueError("AggregatePKs requires at least one pubkey")
    acc = None
    for p in pubkeys:
        pt = c.g1_from_bytes(bytes(p))
        if pt is None:
            raise ValueError("cannot aggregate infinity pubkey")
        acc = c.pt_add(c.FP_FIELD, acc, c.pt_from_affine(c.FP_FIELD, pt))
    return c.g1_to_bytes(c.pt_to_affine(c.FP_FIELD, acc))


def AggregateVerify(pubkeys, messages, signature: bytes) -> bool:
    if len(pubkeys) == 0 or len(pubkeys) != len(messages):
        return False
    try:
        sig = c.g2_from_bytes(bytes(signature))
        pks = [c.g1_from_bytes(bytes(p)) for p in pubkeys]
    except ValueError:
        return False
    if any(pk is None for pk in pks):
        return False
    pairs = [((c.G1_GEN_AFF[0], c.P - c.G1_GEN_AFF[1]), sig)]
    for pk, msg in zip(pks, messages):
        pairs.append((pk, hash_to_curve_g2(bytes(msg))))
    return c.multi_pairing(pairs) == c.F12_ONE


def FastAggregateVerify(pubkeys, message: bytes, signature: bytes) -> bool:
    if len(pubkeys) == 0:
        return False
    try:
        agg_pk = AggregatePKs(pubkeys)
    except ValueError:
        return False
    return Verify(agg_pk, message, signature)
