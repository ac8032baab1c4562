"""Hash-to-curve for BLS12-381 G2 (RFC 9380 structure).

Pipeline: expand_message_xmd(SHA-256) -> hash_to_field(Fp2, m=2, L=64)
-> map_to_curve -> clear_cofactor (Budroni-Pintore endomorphism method).

map_to_curve status: the RFC suite BLS12381G2_XMD:SHA-256_SSWU_RO_ maps via
simplified SWU on a 3-isogenous curve E' (A'=240*I, B'=1012*(1+I), Z=-(2+I))
followed by the 3-isogeny to E. This module implements SSWU on E'; the isogeny
evaluation uses constants derived at import by isogeny.py (Velu). If
derivation is unavailable the module falls back to a deterministic
try-and-increment map — internally consistent (same message -> same G2 point,
uniform enough for tests) but NOT RFC-interoperable; the flag
MAP_TO_CURVE_RFC_COMPLIANT records which path is active.

The cofactor clearing uses psi (untwist-Frobenius-twist): h_eff action
[x^2-x-1]P + [x-1]psi(P) + psi^2(2P), the definition RFC 9380 G2 suites cite.
psi is validated at import against its characteristic equation.
"""
from __future__ import annotations

import hashlib

from .bls12_381 import (
    B_G2, F2_ONE, F2_ZERO, FP2_FIELD, P, X_PARAM, f2_add, f2_conj, f2_inv,
    f2_mul, f2_neg, f2_pow, f2_sqr, f2_sqrt, g2_on_curve, pt_add,
    pt_from_affine, pt_mul, pt_neg, pt_to_affine,
)

DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# --- expand_message_xmd (RFC 9380 section 5.3.1, H = SHA-256) --------------

_B_IN_BYTES = 32  # sha256 output
_R_IN_BYTES = 64  # sha256 block


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("expand_message_xmd: output too long")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        mixed = bytes(a ^ c for a, c in zip(b0, prev))
        blocks.append(hashlib.sha256(mixed + bytes([i]) + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


# --- hash_to_field for Fp2 (m=2, L=64) -------------------------------------

_L = 64


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = DST_G2) -> list[tuple[int, int]]:
    uniform = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            off = _L * (j + i * 2)
            coords.append(int.from_bytes(uniform[off:off + _L], "big") % P)
        out.append((coords[0], coords[1]))
    return out


# --- sgn0 for Fp2 (RFC 9380 section 4.1) -----------------------------------

def sgn0_fp2(x) -> int:
    a, b = x
    sign_0 = a % 2
    zero_0 = a == 0
    sign_1 = b % 2
    return sign_0 or (zero_0 and sign_1)


# --- SSWU on the 3-isogenous curve E': y^2 = x^3 + A'x + B' ----------------

A_ISO = (0, 240)          # 240 * I
B_ISO = (1012, 1012)      # 1012 * (1 + I)
Z_SSWU = (-2 % P, -1 % P)  # -(2 + I)


def _g_iso(x):
    return f2_add(f2_add(f2_mul(f2_sqr(x), x), f2_mul(A_ISO, x)), B_ISO)


def map_to_curve_sswu_iso(u) -> tuple:
    """Simplified SWU mapping u in Fp2 to a point on E' (the iso curve).
    RFC 9380 section 6.6.2 (straight-line version via sqrt, not sqrt_ratio —
    fine in a non-constant-time reference implementation)."""
    z = Z_SSWU
    zu2 = f2_mul(z, f2_sqr(u))
    tv1_denom = f2_add(f2_sqr(zu2), zu2)
    if tv1_denom == F2_ZERO:
        # exceptional case: x1 = B / (Z * A)
        x1 = f2_mul(B_ISO, f2_inv(f2_mul(z, A_ISO)))
    else:
        tv1 = f2_inv(tv1_denom)
        x1 = f2_mul(
            f2_mul(f2_neg(B_ISO), f2_inv(A_ISO)),
            f2_add(F2_ONE, tv1),
        )
    gx1 = _g_iso(x1)
    y1 = f2_sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = f2_mul(zu2, x1)
        gx2 = _g_iso(x2)
        y2 = f2_sqrt(gx2)
        assert y2 is not None, "SSWU: neither gx1 nor gx2 is square (impossible)"
        x, y = x2, y2
    if sgn0_fp2(u) != sgn0_fp2(y):
        y = f2_neg(y)
    return (x, y)


# --- isogeny E' -> E (derived) or fallback map -----------------------------

try:
    from .isogeny import ISO3_MAP  # (x', y') on E' -> (x, y) on E
    MAP_TO_CURVE_RFC_COMPLIANT = True
except ImportError:  # module not yet built — documented fallback path
    ISO3_MAP = None
    MAP_TO_CURVE_RFC_COMPLIANT = False


def _map_to_curve_try_inc(u) -> tuple:
    """Deterministic fallback: increment x from u until on-curve (NOT RFC
    interoperable; see module docstring)."""
    x = u
    while True:
        gx = f2_add(f2_mul(f2_sqr(x), x), B_G2)
        y = f2_sqrt(gx)
        if y is not None:
            if sgn0_fp2(u) != sgn0_fp2(y):
                y = f2_neg(y)
            return (x, y)
        x = f2_add(x, F2_ONE)


def map_to_curve_g2(u) -> tuple:
    if ISO3_MAP is not None:
        return ISO3_MAP(map_to_curve_sswu_iso(u))
    return _map_to_curve_try_inc(u)


# --- psi endomorphism + cofactor clearing ----------------------------------

from .bls12_381 import XI  # noqa: E402

assert (P - 1) % 3 == 0 and (P - 1) % 2 == 0
_PSI_CX = f2_inv(f2_pow(XI, (P - 1) // 3))
_PSI_CY = f2_inv(f2_pow(XI, (P - 1) // 2))


def psi(aff):
    """Twist endomorphism: twist . frobenius . untwist."""
    if aff is None:
        return None
    x, y = aff
    return (f2_mul(f2_conj(x), _PSI_CX), f2_mul(f2_conj(y), _PSI_CY))


def _validate_psi():
    # psi satisfies psi^2 - [t] psi + [p] = 0 on E'(Fp2), t = x + 1.
    probe = _map_to_curve_try_inc((5, 7))
    t = X_PARAM + 1
    p1 = pt_from_affine(FP2_FIELD, psi(psi(probe)))
    p2 = pt_mul(FP2_FIELD, pt_from_affine(FP2_FIELD, psi(probe)), abs(t))
    p2 = p2 if t >= 0 else pt_neg(FP2_FIELD, p2)
    p3 = pt_mul(FP2_FIELD, pt_from_affine(FP2_FIELD, probe), P)
    acc = pt_add(FP2_FIELD, p1, pt_neg(FP2_FIELD, p2))
    acc = pt_add(FP2_FIELD, acc, p3)
    assert acc is None, "psi endomorphism fails characteristic equation"


_validate_psi()


def clear_cofactor_g2(aff) -> tuple | None:
    """Budroni-Pintore: [x^2-x-1]P + [x-1]psi(P) + psi^2([2]P)."""
    if aff is None:
        return None
    F = FP2_FIELD
    p_j = pt_from_affine(F, aff)
    x = X_PARAM
    t1 = pt_mul(F, p_j, abs(x * x - x - 1))
    if x * x - x - 1 < 0:
        t1 = pt_neg(F, t1)
    psi_p = pt_from_affine(F, psi(aff))
    t2 = pt_mul(F, psi_p, abs(x - 1))
    if x - 1 < 0:
        t2 = pt_neg(F, t2)
    two_p = pt_to_affine(F, pt_mul(F, p_j, 2))
    t3 = pt_from_affine(F, psi(psi(two_p)))
    out = pt_add(F, pt_add(F, t1, t2), t3)
    return pt_to_affine(F, out)


# --- full hash_to_curve ----------------------------------------------------

def hash_to_curve_g2(msg: bytes, dst: bytes = DST_G2) -> tuple | None:
    """msg -> point in G2 (affine Fp2 pair). Follows hash_to_curve(RO):
    two field elements, two curve points, add, clear cofactor."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = map_to_curve_g2(u0)
    q1 = map_to_curve_g2(u1)
    F = FP2_FIELD
    q = pt_to_affine(F, pt_add(F, pt_from_affine(F, q0), pt_from_affine(F, q1)))
    out = clear_cofactor_g2(q)
    assert out is None or g2_on_curve(out)
    return out
