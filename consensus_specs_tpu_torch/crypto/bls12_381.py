"""BLS12-381: field towers, curve groups, optimal-ate pairing. Pure Python.

This is the framework's correctness oracle for BLS — the role py_ecc plays for
the reference (eth2spec/utils/bls.py backend "py_ecc"); the batched JAX kernels
(ops/bls_jax.py) are differential-tested against it. Built from the public
curve definition (y^2 = x^3 + 4 over Fp; sextic M-twist y^2 = x^3 + 4(u+1)
over Fp2; embedding degree 12).

Self-checking: every derived constant (cofactors, twist order, generators) is
validated at import time from the BLS parameter x = -0xd201000000010000, so a
corrupted constant fails fast instead of producing wrong signatures.

Representation choices:
- Fp: int mod P.
- Fp2 = Fp[u]/(u^2+1): tuple (a, b).
- Fp12 = Fp2[w]/(w^6 - xi), xi = 1+u: tuple of 6 Fp2 coefficients. The
  Fp6 tower view (v = w^2) is reconstructed only for inversion.
- Curve points: Jacobian (X, Y, Z) tuples; Z = zero => infinity.
"""
from __future__ import annotations

# --- parameters -----------------------------------------------------------

X_PARAM = -0xD201000000010000  # BLS parameter x (negative)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Cross-validate P and R from the BLS12 family equations.
assert R == X_PARAM**4 - X_PARAM**2 + 1
assert (X_PARAM - 1) ** 2 % 3 == 0
assert P == (X_PARAM - 1) ** 2 // 3 * R + X_PARAM

B_G1 = 4  # E: y^2 = x^3 + 4

# --- Fp -------------------------------------------------------------------

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """p == 3 (mod 4): candidate a^((p+1)/4); validated."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


# --- Fp2 = Fp[u]/(u^2+1) --------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return (-x[0] % P, -x[1] % P)


def f2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def f2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def f2_muli(x, k: int):
    return (x[0] * k % P, x[1] * k % P)


def f2_conj(x):
    return (x[0], -x[1] % P)


def f2_inv(x):
    a, b = x
    norm_inv = fp_inv(a * a + b * b)
    return (a * norm_inv % P, -b * norm_inv % P)


def f2_pow(x, n: int):
    result = F2_ONE
    base = x
    while n > 0:
        if n & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        n >>= 1
    return result


def f2_sqrt(x):
    """Square root in Fp2 via the norm method; None if not a QR."""
    a, b = x
    if b == 0:
        s = fp_sqrt(a)
        if s is not None:
            return (s, 0)
        s = fp_sqrt(-a % P)
        return None if s is None else (0, s)
    n = fp_sqrt((a * a + b * b) % P)
    if n is None:
        return None
    inv2 = fp_inv(2)
    c2 = (a + n) * inv2 % P
    c = fp_sqrt(c2)
    if c is None:
        c2 = (a - n) * inv2 % P
        c = fp_sqrt(c2)
        if c is None:
            return None
    d = b * fp_inv(2 * c) % P
    cand = (c, d)
    return cand if f2_sqr(cand) == (a % P, b % P) else None


XI = (1, 1)  # xi = 1 + u, the twist / tower non-residue

# --- Fp12 = Fp2[w]/(w^6 - xi) ---------------------------------------------

F12_ONE = (F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)
F12_ZERO = (F2_ZERO,) * 6


def f12_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f12_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f12_neg(x):
    return tuple(f2_neg(a) for a in x)


def f12_mul(x, y):
    # schoolbook degree-6 poly mult over Fp2, reduce w^6 -> xi
    prod = [(0, 0)] * 11
    for i in range(6):
        xi_c = x[i]
        if xi_c == F2_ZERO:
            continue
        for j in range(6):
            if y[j] == F2_ZERO:
                continue
            prod[i + j] = f2_add(prod[i + j], f2_mul(xi_c, y[j]))
    out = list(prod[:6])
    for k in range(6, 11):
        if prod[k] != F2_ZERO:
            out[k - 6] = f2_add(out[k - 6], f2_mul(prod[k], XI))
    return tuple(out)


def f12_sqr(x):
    return f12_mul(x, x)


def f12_conj(x):
    """f^(p^6): negate odd w-coefficients."""
    return tuple(f2_neg(c) if i % 2 else c for i, c in enumerate(x))


# Fp6 helpers over v^3 = xi, elements (c0, c1, c2) of Fp2 — used for inversion.

def _f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), t1), t2)))
    c1 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), t0), t1), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def _f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def _f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_sqr(a0), f2_mul(XI, f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul(XI, f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    denom = f2_add(
        f2_mul(a0, t0),
        f2_mul(XI, f2_add(f2_mul(a2, t1), f2_mul(a1, t2))),
    )
    dinv = f2_inv(denom)
    return (f2_mul(t0, dinv), f2_mul(t1, dinv), f2_mul(t2, dinv))


def _f6_mul_by_v(a):
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2."""
    return (f2_mul(XI, a[2]), a[0], a[1])


def f12_inv(x):
    # tower view: x = a(v) + w*b(v), v = w^2
    a = (x[0], x[2], x[4])
    b = (x[1], x[3], x[5])
    # norm = a^2 - v * b^2 in Fp6
    norm = [f2_sub(p, q) for p, q in zip(_f6_mul(a, a), _f6_mul_by_v(_f6_mul(b, b)))]
    ninv = _f6_inv(tuple(norm))
    ra = _f6_mul(a, ninv)
    rb = _f6_neg(_f6_mul(b, ninv))
    return (ra[0], rb[0], ra[1], rb[1], ra[2], rb[2])


def f12_pow(x, n: int):
    if n < 0:
        x = f12_inv(x)
        n = -n
    result = F12_ONE
    base = x
    while n > 0:
        if n & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        n >>= 1
    return result


# Frobenius: f^p with f = sum c_i w^i  =>  sum conj(c_i) * g_i * w^i,
# g_i = xi^(i*(p-1)/6).
assert (P - 1) % 6 == 0
_FROB_GAMMA = [f2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def f12_frobenius(x, power: int = 1):
    out = x
    for _ in range(power):
        out = tuple(f2_mul(f2_conj(c), _FROB_GAMMA[i]) for i, c in enumerate(out))
    return out


# --- generic Jacobian curve ops ------------------------------------------
# Parameterized by field function-table: (add, sub, mul, sqr, neg, inv, zero, one)

class _Field:
    __slots__ = ("add", "sub", "mul", "sqr", "neg", "inv", "zero", "one")

    def __init__(self, add, sub, mul, sqr, neg, inv, zero, one):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.zero, self.one = neg, inv, zero, one


FP_FIELD = _Field(
    lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
    lambda a, b: a * b % P, lambda a: a * a % P,
    lambda a: -a % P, fp_inv, 0, 1,
)
FP2_FIELD = _Field(f2_add, f2_sub, f2_mul, f2_sqr, f2_neg, f2_inv, F2_ZERO, F2_ONE)


def pt_is_inf(pt):
    return pt is None


def pt_double(F: _Field, pt):
    if pt is None:
        return None
    x, y, z = pt
    a = F.sqr(x)
    b = F.sqr(y)
    c = F.sqr(b)
    d = F.sub(F.sub(F.sqr(F.add(x, b)), a), c)
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    f = F.sqr(e)
    x3 = F.sub(f, F.add(d, d))
    c8 = F.add(F.add(F.add(c, c), F.add(c, c)), F.add(F.add(c, c), F.add(c, c)))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.mul(F.add(y, y), z)
    return (x3, y3, z3)


def pt_add(F: _Field, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = F.sqr(z1)
    z2z2 = F.sqr(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(F.mul(y1, z2), z2z2)
    s2 = F.mul(F.mul(y2, z1), z1z1)
    if u1 == u2:
        if s1 != s2:
            return None
        return pt_double(F, p1)
    h = F.sub(u2, u1)
    i = F.sqr(F.add(h, h))
    j = F.mul(h, i)
    r = F.sub(s2, s1)
    r = F.add(r, r)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.sqr(r), j), F.add(v, v))
    s1j = F.mul(s1, j)
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.add(s1j, s1j))
    z3 = F.mul(F.mul(z1, z2), F.add(h, h))
    return (x3, y3, z3)


def pt_neg(F: _Field, pt):
    if pt is None:
        return None
    x, y, z = pt
    return (x, F.neg(y), z)


def pt_mul(F: _Field, pt, n: int):
    if n < 0:
        return pt_mul(F, pt_neg(F, pt), -n)
    result = None
    addend = pt
    while n > 0:
        if n & 1:
            result = pt_add(F, result, addend)
        addend = pt_double(F, addend)
        n >>= 1
    return result


def pt_to_affine(F: _Field, pt):
    if pt is None:
        return None
    x, y, z = pt
    zinv = F.inv(z)
    zinv2 = F.sqr(zinv)
    return (F.mul(x, zinv2), F.mul(y, F.mul(zinv, zinv2)))


def pt_from_affine(F: _Field, aff):
    if aff is None:
        return None
    x, y = aff
    return (x, y, F.one)


def pt_eq(F: _Field, p1, p2):
    if p1 is None or p2 is None:
        return p1 is None and p2 is None
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1, z2z2 = F.sqr(z1), F.sqr(z2)
    if F.mul(x1, z2z2) != F.mul(x2, z1z1):
        return False
    return F.mul(F.mul(y1, z2), z2z2) == F.mul(F.mul(y2, z1), z1z1)


def g1_on_curve(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    return y * y % P == (x * x * x + B_G1) % P


B_G2 = f2_muli(XI, 4)  # 4(1+u)


def g2_on_curve(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    return f2_sqr(y) == f2_add(f2_mul(f2_sqr(x), x), B_G2)


# --- generators and cofactors (validated) ---------------------------------

G1_GEN_AFF = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN_AFF = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

assert g1_on_curve(G1_GEN_AFF), "G1 generator not on curve"
assert g2_on_curve(G2_GEN_AFF), "G2 generator not on twist curve"

G1_GEN = pt_from_affine(FP_FIELD, G1_GEN_AFF)
G2_GEN = pt_from_affine(FP2_FIELD, G2_GEN_AFF)

assert pt_mul(FP_FIELD, G1_GEN, R) is None, "G1 generator order != r"
assert pt_mul(FP2_FIELD, G2_GEN, R) is None, "G2 generator order != r"

# G1 cofactor: |E(Fp)| = p + 1 - t, t = x + 1  =>  |E(Fp)| = p - x.
assert (P - X_PARAM) % R == 0
H1 = (P - X_PARAM) // R

# Twist order: |E'(Fp2)| is one of p^2 + 1 - (±t2 ± 3f)/2 with
# t2 = t^2 - 2p and f^2 = (4p^2 - t2^2)/3; pick the candidate divisible by r.
_t = X_PARAM + 1
_t2 = _t * _t - 2 * P


def _isqrt(n: int) -> int:
    import math
    return math.isqrt(n)


_f2 = (4 * P * P - _t2 * _t2) // 3
assert (4 * P * P - _t2 * _t2) % 3 == 0
_f = _isqrt(_f2)
assert _f * _f == _f2
_candidates = [
    P * P + 1 - (_t2 + 3 * _f) // 2,
    P * P + 1 - (_t2 - 3 * _f) // 2,
    P * P + 1 + (_t2 + 3 * _f) // 2,
    P * P + 1 + (_t2 - 3 * _f) // 2,
]
_twist_orders = [n for n in _candidates if n % R == 0 and pt_mul(FP2_FIELD, G2_GEN, n) is None]
assert _twist_orders, "no valid twist order found"
TWIST_ORDER = _twist_orders[0]
H2 = TWIST_ORDER // R

# --- untwist + pairing ----------------------------------------------------

FP12_FIELD = _Field(f12_add, f12_sub, f12_mul, f12_sqr, f12_neg, f12_inv, F12_ZERO, F12_ONE)

_XI_INV = f2_inv(XI)


def _f12_from_f2(c, pos: int = 0):
    coeffs = [F2_ZERO] * 6
    coeffs[pos] = c
    return tuple(coeffs)


def untwist(q_aff):
    """E'(Fp2) affine -> E(Fp12) affine: (x', y') -> (x' w^-2, y' w^-3);
    w^-2 = w^4/xi, w^-3 = w^3/xi."""
    if q_aff is None:
        return None
    x, y = q_aff
    return (
        _f12_from_f2(f2_mul(x, _XI_INV), 4),
        _f12_from_f2(f2_mul(y, _XI_INV), 3),
    )


def _embed_fp(a: int):
    return _f12_from_f2((a % P, 0), 0)


def _line(p1, p2, at):
    """Evaluate the line through p1, p2 (affine E(Fp12) points) at `at`.
    Returns the standard Miller line value (unnormalized)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = at
    if x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    elif y1 == y2:
        three_x1_sq = f12_mul(_embed_fp(3), f12_sqr(x1))
        m = f12_mul(three_x1_sq, f12_inv(f12_mul(_embed_fp(2), y1)))
    else:
        return f12_sub(xt, x1)  # vertical line
    return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))


def _aff_add(F: _Field, p1, p2):
    return pt_to_affine(F, pt_add(F, pt_from_affine(F, p1), pt_from_affine(F, p2)))


def _aff_double(F: _Field, p1):
    return pt_to_affine(F, pt_double(F, pt_from_affine(F, p1)))


ATE_LOOP_COUNT = abs(X_PARAM)  # Miller loop runs over |x|; x < 0 handled by conjugation


def miller_loop(q_aff12, p_aff12):
    """f_{|x|,Q}(P) with Q, P affine points on E(Fp12); returns Fp12 element
    (before final exponentiation)."""
    if q_aff12 is None or p_aff12 is None:
        return F12_ONE
    f = F12_ONE
    t = q_aff12
    bits = bin(ATE_LOOP_COUNT)[3:]
    for bit in bits:
        f = f12_mul(f12_sqr(f), _line(t, t, p_aff12))
        t = _aff_double(FP12_FIELD, t)
        if bit == "1":
            f = f12_mul(f, _line(t, q_aff12, p_aff12))
            t = _aff_add(FP12_FIELD, t, q_aff12)
    # x < 0: f_{-n} = conj(f_n) up to final exponentiation
    return f12_conj(f)


# hard-part exponent of the final exponentiation, done by plain pow (safe,
# ~1500 bits); the easy part uses conj/inv/frobenius.
assert (P**4 - P**2 + 1) % R == 0
_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f):
    # easy: f^((p^6 - 1)(p^2 + 1))
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius(f, 2), f)
    # hard: f^((p^4 - p^2 + 1)/r)
    return f12_pow(f, _HARD_EXP)


def pairing(q_aff2, p_aff1, final_exp: bool = True):
    """e(P, Q) for P in G1 (affine Fp pair), Q in G2 (affine Fp2 pair)."""
    if q_aff2 is None or p_aff1 is None:
        return F12_ONE
    px, py = p_aff1
    p12 = (_embed_fp(px), _embed_fp(py))
    f = miller_loop(untwist(q_aff2), p12)
    return final_exponentiation(f) if final_exp else f


def multi_pairing(pairs) -> tuple:
    """prod e(P_i, Q_i): shares one final exponentiation across Miller loops."""
    f = F12_ONE
    for p_aff1, q_aff2 in pairs:
        if p_aff1 is None or q_aff2 is None:
            continue
        px, py = p_aff1
        p12 = (_embed_fp(px), _embed_fp(py))
        f = f12_mul(f, miller_loop(untwist(q_aff2), p12))
    return final_exponentiation(f)


# --- point (de)serialization: ZCash BLS12-381 format ----------------------

_COMP_FLAG = 0x80
_INF_FLAG = 0x40
_SIGN_FLAG = 0x20


def g1_to_bytes(aff) -> bytes:
    if aff is None:
        out = bytearray(48)
        out[0] = _COMP_FLAG | _INF_FLAG
        return bytes(out)
    x, y = aff
    flags = _COMP_FLAG | (_SIGN_FLAG if y > (P - 1) // 2 else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_from_bytes(data: bytes, subgroup_check: bool = True):
    """Decompress 48-byte G1 point; raises ValueError on invalid encoding."""
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _COMP_FLAG:
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & _INF_FLAG:
        if any(data[1:]) or flags & _SIGN_FLAG or data[0] != (_COMP_FLAG | _INF_FLAG):
            raise ValueError("invalid G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x coordinate >= p")
    y = fp_sqrt((x * x * x + B_G1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if (y > (P - 1) // 2) != bool(flags & _SIGN_FLAG):
        y = P - y
    aff = (x, y)
    if subgroup_check and pt_mul(FP_FIELD, pt_from_affine(FP_FIELD, aff), R) is not None:
        raise ValueError("G1 point not in r-subgroup")
    return aff


def g2_to_bytes(aff) -> bytes:
    if aff is None:
        out = bytearray(96)
        out[0] = _COMP_FLAG | _INF_FLAG
        return bytes(out)
    (x0, x1), (y0, y1) = aff
    sign = y1 > (P - 1) // 2 if y1 != 0 else y0 > (P - 1) // 2
    flags = _COMP_FLAG | (_SIGN_FLAG if sign else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_from_bytes(data: bytes, subgroup_check: bool = True):
    """Decompress 96-byte G2 point; raises ValueError on invalid encoding."""
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _COMP_FLAG:
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & _INF_FLAG:
        if any(data[1:]) or data[0] != (_COMP_FLAG | _INF_FLAG):
            raise ValueError("invalid G2 infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x coordinate >= p")
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), B_G2))
    if y is None:
        raise ValueError("G2 x not on twist curve")
    y0, y1 = y
    sign = y1 > (P - 1) // 2 if y1 != 0 else y0 > (P - 1) // 2
    if sign != bool(flags & _SIGN_FLAG):
        y = f2_neg(y)
    aff = (x, y)
    if subgroup_check and pt_mul(FP2_FIELD, pt_from_affine(FP2_FIELD, aff), R) is not None:
        raise ValueError("G2 point not in r-subgroup")
    return aff
