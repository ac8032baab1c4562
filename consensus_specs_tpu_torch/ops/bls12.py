"""BLS12-381 towers, curves, optimal-ate pairing and the randomized batch
check (counterpart of ops/bls12_jax.py).

Representation. Public functions take and return Montgomery words
(ops/fp.py): Fp (..., 12) int32, Fp2 (..., 2, 12) as (re, im), Fp12
(..., 12, 12) as the six Fp2 coefficients of w^k (w^6 = xi = 1 + u) flattened
(row 2k + c), G1 affine (..., 2, 12), G2 affine on the twist (..., 2, 2, 12),
Jacobian points (..., 3, 12) / (..., 3, 2, 12), 64-bit scalars z as (..., 2)
int32 words (low word first). The plain versions work on the same shapes in
sixteen-bit limbs (last axis 24, int64); the `f2_*`, `f6_*`, `f12_*`, `g1_*`,
`g2_*` functions below are plain and limb-level, and are what the kernels
compute inside one thread.

Every Fp value is canonical, so any correct formula for a tower product gives
the same words: the towers (f12_mul and f12_sqr by Karatsuba over Fp6,
Granger-Scott for cyclotomic squares) are free, and the plain version uses the
kernels' formulas so that `fp.plain_muls` counts the kernels' products. What
is not free is where the JAX package's values depend on a representative:
- the Miller loop keeps T in Jacobian coordinates with the JAX formulas and
  the same line scaling (2YZ^3·xi for a double, HZ·xi for an add,
  ops/bls12_jax.py:22-27), so its output is bit-equal to JAX's before the
  final exponentiation;
- the final exponentiation is JAX's chain, (x-1)^2 (x+p) (x^2+p^2-1) + 3
  = 3 (p^4 - p^2 + 1)/r (:28-34): it yields the CUBE of the reduced
  pairing, bit-equal to `pairing_cube_batch`;
- g1_add / g2_add are JAX's complete additions: infinity in (Z = 0) returns
  the other point, equal points double, opposite points give Z = 0 with the
  add formula's X and Y. The kernels branch on those cases exactly as JAX
  selects; the plain version computes each case only on its rows, so its
  product count is what this data needs.

Kernels (csrc/rlc.cu, csrc/pairing.cu, csrc/msm.cu; the towers in
csrc/tower.cuh and the curves in csrc/curve.cuh are templates over the base
field: the limb field of csrc/fp.cuh, a unit a thread, or the RNS field of
csrc/fp_rns.cuh, a unit a warp, for K9-K12). K9's ladders and K11's Miller
loop run an item on a group of units, their steps' Fp products a unit each
(csrc/bls_group.cuh, the programs of ops/bls12_programs.py; K9's limb G1
ladder on csrc/g1_lanes.cuh's four lanes), K12's exponentiation too
(csrc/f12_group.cuh), K10's limb G1 sums on four-lane groups, its G2
collapse on K9's G2 groups across blocks (both fields) and its RNS G1 sums
a warp a unit:
- K9 `rlc_ladders`: [z]·pk over G1 and [z]·sig over G2, 2-bit windows
  (`g1_scalar_mul_batch` :782, `g2_scalar_mul_batch` :957), G1 made affine
  in the same thread where asked (:868);
- K10 `point_sums`: the sum of each segment's Jacobian points made affine
  (`g2_sum_reduce` :1014 + `g2_jacobian_to_affine` :1043,
  `g1_segment_sum` :1172): G1 one block a segment, G2 `g2_sum_units(N)`
  groups a segment whose blocks meet by tickets;
- K11 `miller_loop` (:514);
- K12 `final_exp`: the final exponentiation and `f12_is_one` (:611, :628),
  by item (`pairing_cube_batch` :762, `pairing_check_batch` :768) or after a
  tree product, a launch a level (`f12_prod_reduce` :1061, `rlc_tail`
  :1219);
- K25 `f12_product`: that tree product alone, no exponentiation
  (`f12_prod_reduce` :1061 as the mesh collectives use it);
- K13 `g1_msm` (csrc/msm.cu): the windowed bucket MSM (`g1_msm_pippenger`
  :1291), affine out, every point operation on four lanes, its combine as
  interleaved Horner chains on one warp;
- K14 `g1_subgroup` (csrc/msm.cu): r-subgroup membership per item (:1347),
  by phi(P) = -[x^2]·P (csrc/curve.cuh `jac_in_g1`).
The committee-key sum (`_g1_aggregate_program` :1339) is K10 over one
segment; [z]·(-G1) (`g1_fixed_mul_neg_g1` :854) is K9 over -G1.
Each wrapper launches its kernel for CUDA tensors and runs `<name>_plain` for
CPU tensors. K9-K12's wrappers take either field's elements, told apart by
their width: 12 Montgomery words (the limb instance) or 64 RNS residues
(ops/fp_rns.py; the `_rns` entry points, counted apart in build.LAUNCHES).

The field of the BLS flush (JAX's switch, :55-64): `set_field_backend("limb")`
(the default) runs the randomized check and the per-item check on K9-K12's
limb instances; `set_field_backend("rns")` runs the same composition on
their RNS instances, crypto/bls_torch.py packing RNS residues for it (on the
host, `bls12_field.pack_mont`). Neither backend runs the other's kernels.
The key aggregation, the subgroup check and the MSM run on K10, K13 and K14
over the limb field under either.

The plain versions take their few field primitives (add, sub, neg, mul,
inverse, the zero and one tests, constants) from the field of the values
they are given, told apart by the trailing dim (`plain_field`): sixteen-bit
limbs (..., 24) int64, canonical, or RNS residues (..., 64) int32 through
ops/fp_rns.rns_ops_plain (K24's plain version). Over limbs any correct
formula gives the kernels' words; over RNS a value's residues depend on the
integers fed to each Montgomery product, so the formulas here feed every
product the same sums and differences as csrc/tower.cuh and csrc/curve.cuh
and visit the points in the kernels' order: the RNS plain version is
bit-equal to the RNS kernels (the card-only tests and chip_smoke.py hold
it).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..crypto import bls12_381 as oracle
from ..kernels import build
from ..utils.device import is_cpu, resolve_device
from . import bls12_field, fp, fp_rns
from .fp import (
    NLIMBS,
    NWORDS,
    P,
    fp_add,
    fp_inv,
    fp_is_zero,
    fp_mul,
    fp_neg,
    fp_sqr,
    fp_sub,
    to_limbs,
    to_words,
)

X_PARAM = oracle.X_PARAM
ABS_X = abs(X_PARAM)
X_BITS = [int(c) for c in bin(ABS_X)[3:]]  # the Miller loop's bits, MSB dropped
assert ((X_PARAM - 1) ** 2 * (X_PARAM + P) * (X_PARAM**2 + P**2 - 1) + 3) == 3 * (
    (P**4 - P**2 + 1) // oracle.R)

GAMMA1 = [oracle.f2_pow(oracle.XI, i * (P - 1) // 6) for i in range(6)]
GAMMA2 = [oracle.f2_mul(oracle.f2_conj(g), g) for g in GAMMA1]
NEG_G1 = (oracle.G1_GEN_AFF[0], (-oracle.G1_GEN_AFF[1]) % P)

miller_loop_items = 0  # Miller loops run through `miller_loop`, kernel or plain

class FieldBackend(NamedTuple):
    """One field of the BLS flush, over this module's packed layout (Q
    (B, 2, 2, width), P (B, 2, width), scalars (B, 2) int32 words). The
    checks (`pairing_check_batch`, `pairing_check_rlc`) serve both fields:
    they tell them apart by the width of the values they are given."""
    width: int        # int32 words an Fp element
    pack: Callable    # (canonical ints, device) -> (n, width) Montgomery form


_FIELD = "limb"


def set_field_backend(name: str) -> None:
    """Select the BLS flush's field: "limb" or "rns" (K9-K12's limb or RNS
    instances). An unknown name raises KeyError."""
    global _FIELD
    if name not in FIELD_BACKENDS:
        raise KeyError(f"unknown field backend {name!r}; one of {sorted(FIELD_BACKENDS)}")
    _FIELD = name


def field_backend() -> str:
    return _FIELD


def current_field() -> FieldBackend:
    """The selected backend's width and packing."""
    return FIELD_BACKENDS[_FIELD]


# --- host codecs (canonical ints <-> Montgomery words) --------------------------


def g1_to_words(points) -> torch.Tensor:
    """Affine G1 int pairs -> (n, 2, 12) Montgomery words (host, CPU)."""
    flat = [c for pt in points for c in pt]
    return torch.from_numpy(fp.ints_to_mont_words(flat).reshape(-1, 2, NWORDS))


def g2_to_words(points) -> torch.Tensor:
    """Affine G2 twist points ((x0, x1), (y0, y1)) -> (n, 2, 2, 12)."""
    flat = [c for pt in points for coord in pt for c in coord]
    return torch.from_numpy(fp.ints_to_mont_words(flat).reshape(-1, 2, 2, NWORDS))


def f12_to_words(values) -> torch.Tensor:
    """Oracle Fp12 values (6 int pairs) -> (n, 12, 12)."""
    flat = [c for v in values for coeff in v for c in coeff]
    return torch.from_numpy(fp.ints_to_mont_words(flat).reshape(-1, 12, NWORDS))


def f12_from_words(arr) -> list:
    """(..., 12, 12) words -> list of oracle Fp12 tuples."""
    ints = fp.mont_words_to_ints(arr)
    return [tuple((ints[i + 2 * k], ints[i + 2 * k + 1]) for k in range(6))
            for i in range(0, len(ints), 12)]


def affine_from_words(arr, g2: bool) -> list:
    """(..., 2, 12) G1 or (..., 2, 2, 12) G2 affine words -> int tuples."""
    ints = fp.mont_words_to_ints(arr)
    if not g2:
        return [(ints[i], ints[i + 1]) for i in range(0, len(ints), 2)]
    return [((ints[i], ints[i + 1]), (ints[i + 2], ints[i + 3])) for i in range(0, len(ints), 4)]


def _limb_const(rows, like: torch.Tensor) -> torch.Tensor:
    """Canonical ints (nested lists) -> Montgomery limbs on like's device."""
    flat = np.asarray(rows, dtype=object).reshape(-1)
    words = torch.from_numpy(fp.ints_to_mont_words(flat))
    return to_limbs(words).reshape(*np.asarray(rows, dtype=object).shape, NLIMBS).to(like.device)


# --- the plain versions' base field ----------------------------------------------


class _LimbField:
    """Sixteen-bit limbs (..., 24) int64, every value canonical (ops/fp.py)."""
    words = NWORDS  # int32 words an element at the kernels' boundary
    units = 64      # K10's G1 units a block (csrc/rlc.cu SUM_UNITS)
    add, sub, neg = staticmethod(fp_add), staticmethod(fp_sub), staticmethod(fp_neg)
    mul, sqr, inv = staticmethod(fp_mul), staticmethod(fp_sqr), staticmethod(fp_inv)
    is_zero, is_one = staticmethod(fp_is_zero), staticmethod(fp.fp_is_one_mont)
    to_plain, from_plain = staticmethod(to_limbs), staticmethod(to_words)

    @staticmethod
    def one(like):
        return fp.const_limbs(fp.R_MOD_P, like)

    @staticmethod
    def const(rows, like):
        return _limb_const(rows, like)


def _rns(op, *xs):
    """`fp_rns.rns_ops_plain` over any (broadcast) leading shape."""
    xs = torch.broadcast_tensors(*xs)
    shape = xs[0].shape
    out = fp_rns.rns_ops_plain(op, *(x.reshape(-1, fp_rns.NLIMBS) for x in xs))
    return out.reshape(shape if out.dim() == 2 else shape[:-1])


def _same(x):
    return x


class _RnsField:
    """RNS residues (..., 64) int32, redundant (ops/fp_rns.py), through K24's
    plain version."""
    words = fp_rns.NLIMBS
    units = 16  # K10's G1 units a block (csrc/rlc.cu SUM_WARPS)
    to_plain = from_plain = staticmethod(_same)

    @staticmethod
    def add(a, b):
        return _rns(fp_rns.OP_ADD, a, b)

    @staticmethod
    def sub(a, b):
        return _rns(fp_rns.OP_SUB, a, b)

    @staticmethod
    def neg(a):
        return _rns(fp_rns.OP_NEG, a)

    @staticmethod
    def mul(a, b):
        return _rns(fp_rns.OP_MONT_MUL, a, b)

    @staticmethod
    def sqr(a):
        return _rns(fp_rns.OP_MONT_MUL, a, a)

    @staticmethod
    def inv(a):
        return _rns(fp_rns.OP_POW_INV, a)

    @staticmethod
    def is_zero(a):
        return _rns(fp_rns.OP_IS_ZERO, a)

    @staticmethod
    def is_one(a):
        return _rns(fp_rns.OP_IS_ONE, a)

    @staticmethod
    def one(like):
        return torch.from_numpy(fp_rns.ONE_MONT).to(like.device)

    @staticmethod
    def const(rows, like):
        shape = np.asarray(rows, dtype=object).shape
        flat = np.asarray(rows, dtype=object).reshape(-1)
        return torch.from_numpy(fp_rns.ints_to_mont_batch(flat)).reshape(
            *shape, fp_rns.NLIMBS).to(like.device)


def plain_field(x):
    """The plain field of a plain value, by its trailing dim: RNS residues
    (64) or limbs (24)."""
    return _RnsField if x.shape[-1] == fp_rns.NLIMBS else _LimbField


def word_field(width: int):
    """The plain field of the kernels' elements of `width` int32 words (12 or
    64); anything else raises ValueError."""
    if width == NWORDS:
        return _LimbField
    if width == fp_rns.NLIMBS:
        return _RnsField
    raise ValueError(f"an Fp element is {NWORDS} Montgomery words or {fp_rns.NLIMBS} RNS "
                     f"residues, not {width}")


# --- Fp2 = Fp[u]/(u^2 + 1): (..., 2, w) ------------------------------------------


def f2_add(x, y):
    return plain_field(x).add(x, y)


def f2_sub(x, y):
    return plain_field(x).sub(x, y)


def f2_neg(x):
    return plain_field(x).neg(x)


def f2_conj(x):
    return torch.stack([x[..., 0, :], plain_field(x).neg(x[..., 1, :])], -2)


def f2_mul(x, y):
    """Karatsuba: 3 Fp products in one stacked call."""
    F = plain_field(x)
    x, y = torch.broadcast_tensors(x, y)
    s = F.add(torch.stack([x[..., 0, :], y[..., 0, :]]), torch.stack([x[..., 1, :], y[..., 1, :]]))
    m = F.mul(torch.stack([x[..., 0, :], x[..., 1, :], s[0]], -2),
              torch.stack([y[..., 0, :], y[..., 1, :], s[1]], -2))
    ac, bd, t = m.unbind(-2)
    d = F.sub(torch.stack([ac, t], -2), torch.stack([bd, ac], -2))
    return torch.stack([d[..., 0, :], F.sub(d[..., 1, :], bd)], -2)


def f2_sqr(x):
    """(a+b)(a-b) + 2ab·u: 2 Fp products."""
    F = plain_field(x)
    a, b = x[..., 0, :], x[..., 1, :]
    s = F.add(torch.stack([a, a], -2), torch.stack([b, a], -2))
    return F.mul(torch.stack([s[..., 0, :], s[..., 1, :]], -2),
                 torch.stack([F.sub(a, b), b], -2))


def f2_mul_xi(x):
    """x·(1 + u) = (a - b) + (a + b)u."""
    F = plain_field(x)
    a, b = x[..., 0, :], x[..., 1, :]
    return torch.stack([F.sub(a, b), F.add(a, b)], -2)


def f2_inv(x):
    F = plain_field(x)
    sq = F.sqr(x)
    ninv = F.inv(F.add(sq[..., 0, :], sq[..., 1, :]))
    m = F.mul(x, ninv[..., None, :])
    return torch.stack([m[..., 0, :], F.neg(m[..., 1, :])], -2)


def f2_is_zero(x):
    return plain_field(x).is_zero(x).all(-1)


def f2_one_like(x):
    one = torch.zeros_like(x)
    one[..., 0, :] = plain_field(x).one(x)
    return one


# --- Fp6 = Fp2[v]/(v^3 - xi): (..., 3, 2, w) -------------------------------------


def f6_mul(a, b):
    """Karatsuba over Fp2: 6 Fp2 products in one stacked call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-3)
    b0, b1, b2 = b.unbind(-3)
    sa = f2_add(torch.stack([a1, a0, a0], -3), torch.stack([a2, a1, a2], -3))
    sb = f2_add(torch.stack([b1, b0, b0], -3), torch.stack([b2, b1, b2], -3))
    m = f2_mul(torch.cat([a, sa], -3), torch.cat([b, sb], -3))
    t0, t1, t2, s12, s01, s02 = m.unbind(-3)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(s12, f2_add(t1, t2))))
    c1 = f2_add(f2_sub(s01, f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(s02, f2_add(t0, t2)), t1)
    return torch.stack([c0, c1, c2], -3)


def f6_mul_by_v(a):
    return torch.stack([f2_mul_xi(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], -3)


def f6_inv(a):
    a0, a1, a2 = a.unbind(-3)
    sq = f2_sqr(a)
    m = f2_mul(torch.stack([a1, a0, a0], -3), torch.stack([a2, a1, a2], -3))
    a12, a01, a02 = m.unbind(-3)
    c0 = f2_sub(sq[..., 0, :, :], f2_mul_xi(a12))
    c1 = f2_sub(f2_mul_xi(sq[..., 2, :, :]), a01)
    c2 = f2_sub(sq[..., 1, :, :], a02)
    m = f2_mul(torch.stack([a0, a2, a1], -3), torch.stack([c0, c1, c2], -3))
    t = f2_add(m[..., 0, :, :], f2_mul_xi(f2_add(m[..., 1, :, :], m[..., 2, :, :])))
    return f2_mul(torch.stack([c0, c1, c2], -3), f2_inv(t)[..., None, :, :])


# --- Fp12 in the w basis: (..., 6, 2, w); the Fp6 pair (a, b) = (even, odd) ------


def _split(x):
    return x[..., 0::2, :, :], x[..., 1::2, :, :]


def _join(a, b):
    return torch.stack([a, b], -3).flatten(-4, -3)


def f12_one_like(x):
    """The Fp12 one over the batch shape of the Fp2 value x (..., 2, w)."""
    one = torch.zeros(x.shape[:-2] + (6, 2, x.shape[-1]), dtype=x.dtype, device=x.device)
    one[..., 0, 0, :] = plain_field(x).one(x)
    return one


def f12_conj(x):
    """f^(p^6): the odd coefficients negated."""
    a, b = _split(x)
    return _join(a, f2_neg(b))


def f12_mul(x, y):
    """(a0 + a1 w)(b0 + b1 w) = a0b0 + a1b1·v + ((a0+a1)(b0+b1) - a0b0 - a1b1) w:
    3 Fp6 products, 54 Fp products."""
    x, y = torch.broadcast_tensors(x, y)
    a0, a1 = _split(x)
    b0, b1 = _split(y)
    m = f6_mul(torch.stack([a0, a1, f2_add(a0, a1)]), torch.stack([b0, b1, f2_add(b0, b1)]))
    t0, t1, t2 = m
    return _join(f2_add(t0, f6_mul_by_v(t1)), f2_sub(t2, f2_add(t0, t1)))


def f12_sqr(x):
    """(a + b w)^2 = (a+b)(a + v b) - ab - v ab + 2ab w: 2 Fp6 products."""
    a, b = _split(x)
    m = f6_mul(torch.stack([a, f2_add(a, b)]), torch.stack([b, f2_add(a, f6_mul_by_v(b))]))
    t, s = m
    return _join(f2_sub(s, f2_add(t, f6_mul_by_v(t))), f2_add(t, t))


def f12_mul_sparse035(f, l0, l3, l5):
    """f·(l0 + l3 w^3 + l5 w^5), the line (0, l3, l5) on the odd Fp6:
    a·l0 by coefficient, b·(0, l3, l5) and (a + b)(l0, l3, l5) as Fp6
    products, 15 Fp2 products."""
    a, b = _split(f)
    zero = torch.zeros_like(l0)
    t0 = f2_mul(a, l0[..., None, :, :])
    lines = torch.stack([torch.stack([zero, l3, l5], -3), torch.stack([l0, l3, l5], -3)])
    m = f6_mul(torch.stack([b, f2_add(a, b)]), lines)
    t1, t2 = m
    return _join(f2_add(t0, f6_mul_by_v(t1)), f2_sub(t2, f2_add(t0, t1)))


def f12_inv(x):
    """(a + b w)^-1 = (a - b w)/(a^2 - v b^2)."""
    a, b = _split(x)
    m = f6_mul(torch.stack([a, b]), torch.stack([a, b]))
    dinv = f6_inv(f2_sub(m[0], f6_mul_by_v(m[1])))
    r = f6_mul(torch.stack([a, b]), dinv)
    return _join(r[0], f2_neg(r[1]))


def f12_frobenius(x):
    """f^p: each coefficient conjugated, times gamma1^k."""
    return f2_mul(f2_conj(x), plain_field(x).const(GAMMA1, x))


def f12_frobenius2(x):
    """f^(p^2): coefficient k times gamma2^k."""
    return f2_mul(x, plain_field(x).const(GAMMA2, x))


def f12_cyclotomic_sqr(f):
    """Granger-Scott squaring for unitary f (ops/bls12_jax.py:539): with
    s = w^3 and f = A + B w + C w^2 over Fp4 = Fp2[s],
    f^2 = (3A^2 - 2conj(A)) + (3 s C^2 + 2 conj(B)) w + (3B^2 - 2conj(C)) w^2."""
    c = f.unbind(-3)
    x = torch.stack([torch.stack([c[0], c[1], c[2]], -3), torch.stack([c[3], c[4], c[5]], -3)])
    sq = f2_sqr(x)  # a^2 and b^2 of A, B, C
    ab = f2_mul(x[0], x[1])
    re = f2_add(sq[0], f2_mul_xi(sq[1]))  # Fp4 squares: (a^2 + xi b^2) + 2ab s
    im = f2_add(ab, ab)

    def triple(t):
        return f2_add(f2_add(t, t), t)

    def twice(t):
        return f2_add(t, t)

    # A' = 3A^2 - 2conj(A); B' = 3 s C^2 + 2 conj(B); C' = 3B^2 - 2conj(C)
    a0 = f2_sub(triple(re[..., 0, :, :]), twice(c[0]))
    a1 = f2_add(triple(im[..., 0, :, :]), twice(c[3]))
    b0 = f2_add(triple(f2_mul_xi(im[..., 2, :, :])), twice(c[1]))
    b1 = f2_sub(triple(re[..., 2, :, :]), twice(c[4]))
    c0 = f2_sub(triple(re[..., 1, :, :]), twice(c[2]))
    c1 = f2_add(triple(im[..., 1, :, :]), twice(c[5]))
    return torch.stack([a0, b0, c0, a1, b1, c1], -3)


def f12_is_one(f):
    """(...) bool: f == 1, coefficient 0's real part one and the eleven
    others zero (over RNS, the class compares)."""
    F = plain_field(f)
    flat = f.flatten(-3, -2)
    return F.is_one(flat[..., 0, :]) & F.is_zero(flat[..., 1:, :]).all(-1)


# --- the pairing ----------------------------------------------------------------


def _dbl_step(T, xp, yp):
    """One Miller doubling of T = (X, Y, Z) on the twist, with the line
    l0 = 2YZ^3·xi·yp, l3 = 3X^3 - 2Y^2, l5 = -3X^2 Z^2·xp (:442)."""
    X, Y, Z = T.unbind(-3)
    sq = f2_sqr(T)
    A, B, Zsq = sq.unbind(-3)
    E = f2_add(f2_add(A, A), A)
    m1 = f2_mul(torch.stack([X, Y, Z, E, E], -3), torch.stack([B, Z, Zsq, X, Zsq], -3))
    D0, YZ, Zcu, EX, EZsq = m1.unbind(-3)
    D = f2_add(D0, D0)
    D = f2_add(D, D)
    sq2 = f2_sqr(torch.stack([E, B], -3))
    Fq, C = sq2.unbind(-3)
    X3 = f2_sub(Fq, f2_add(D, D))
    C8 = f2_add(C, C)
    C8 = f2_add(C8, C8)
    C8 = f2_add(C8, C8)
    m2 = f2_mul(torch.stack([E, Y], -3), torch.stack([f2_sub(D, X3), Zcu], -3))
    Y3a, YZcu = m2.unbind(-3)
    Y3 = f2_sub(Y3a, C8)
    Z3 = f2_add(YZ, YZ)
    xi0 = f2_mul_xi(f2_add(YZcu, YZcu))
    lm = plain_field(xp).mul(torch.stack([xi0, EZsq], -3), torch.stack([yp, xp], -2)[..., None, :])
    l0, l5 = lm[..., 0, :, :], f2_neg(lm[..., 1, :, :])
    l3 = f2_sub(EX, f2_add(B, B))
    return torch.stack([X3, Y3, Z3], -3), (l0, l3, l5)


def _add_step(T, Q, xp, yp):
    """Mixed addition T + Q (Q affine on the twist), with the line
    l0 = HZ·xi·yp, l3 = r·xq - HZ·yq, l5 = -r·xp (:478)."""
    X, Y, Z = T.unbind(-3)
    xq, yq = Q.unbind(-3)
    Zsq = f2_sqr(Z)
    m1 = f2_mul(torch.stack([xq, Z], -3), Zsq[..., None, :, :])
    U, Zcu = m1.unbind(-3)
    S = f2_mul(yq, Zcu)
    H = f2_sub(U, X)
    r = f2_sub(S, Y)
    sq = f2_sqr(torch.stack([H, r], -3))
    Hsq, rsq = sq.unbind(-3)
    m2 = f2_mul(torch.stack([H, X, H], -3), torch.stack([Hsq, Hsq, Z], -3))
    Hcu, V, HZ = m2.unbind(-3)
    X3 = f2_sub(f2_sub(rsq, Hcu), f2_add(V, V))
    m3 = f2_mul(torch.stack([r, Y, r, HZ], -3), torch.stack([f2_sub(V, X3), Hcu, xq, yq], -3))
    Y3a, YHcu, rxq, HZyq = m3.unbind(-3)
    Y3 = f2_sub(Y3a, YHcu)
    Z3 = HZ  # = Z·H, which JAX multiplies again
    xiHZ = f2_mul_xi(HZ)
    lm = plain_field(xp).mul(torch.stack([xiHZ, r], -3), torch.stack([yp, xp], -2)[..., None, :])
    l0, l5 = lm[..., 0, :, :], f2_neg(lm[..., 1, :, :])
    l3 = f2_sub(rxq, HZyq)
    return torch.stack([X3, Y3, Z3], -3), (l0, l3, l5)


def miller_loop_limbs(Q, Pt):
    """f_{|x|,Q}(P), conjugated (x < 0): Q (..., 2, 2, w), P (..., 2, w)
    -> (..., 6, 2, w), over either plain field."""
    xp, yp = Pt[..., 0, :], Pt[..., 1, :]
    T = torch.stack([Q[..., 0, :, :], Q[..., 1, :, :], f2_one_like(Q[..., 0, :, :])], -3)
    f = f12_one_like(Q[..., 0, :, :])
    for bit in X_BITS:
        T, (l0, l3, l5) = _dbl_step(T, xp, yp)
        f = f12_mul_sparse035(f12_sqr(f), l0, l3, l5)
        if bit:
            T, (l0, l3, l5) = _add_step(T, Q, xp, yp)
            f = f12_mul_sparse035(f, l0, l3, l5)
    return f12_conj(f)


def _f12_pow_x(f):
    """f^x for unitary f (x < 0: the conjugate of f^|x|)."""
    r = f
    for bit in X_BITS:
        r = f12_cyclotomic_sqr(r)
        if bit:
            r = f12_mul(r, f)
    return f12_conj(r)


def final_exponentiation_limbs(f):
    """The cube of the reduced pairing (:611): the easy part, then the hard
    part (x-1)^2 (x+p) (x^2+p^2-1) + 3."""
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius2(f), f)
    a = f12_mul(_f12_pow_x(f), f12_conj(f))  # f^(x-1)
    a = f12_mul(_f12_pow_x(a), f12_conj(a))  # ^(x-1)^2
    b = f12_mul(_f12_pow_x(a), f12_frobenius(a))  # ^(x+p)
    c = f12_mul(f12_mul(_f12_pow_x(_f12_pow_x(b)), f12_frobenius2(b)), f12_conj(b))
    return f12_mul(c, f12_mul(f12_sqr(f), f))


# --- curves: one code for G1 over Fp and G2 over Fp2, either plain field ---------


class _Fp:
    dims = 1

    @staticmethod
    def mul(a, b):
        return plain_field(a).mul(a, b)

    @staticmethod
    def sqr(a):
        return plain_field(a).sqr(a)

    @staticmethod
    def add(a, b):
        return plain_field(a).add(a, b)

    @staticmethod
    def sub(a, b):
        return plain_field(a).sub(a, b)

    @staticmethod
    def is_zero(a):
        return plain_field(a).is_zero(a)

    @staticmethod
    def inv(a):
        return plain_field(a).inv(a)


class _Fp2:
    dims = 2
    mul, sqr, add, sub = staticmethod(f2_mul), staticmethod(f2_sqr), staticmethod(f2_add), \
        staticmethod(f2_sub)
    is_zero = staticmethod(f2_is_zero)
    inv = staticmethod(f2_inv)


def _stack(F, xs):
    return torch.stack(xs, -1 - F.dims)


def _unbind(F, x):
    return x.unbind(-1 - F.dims)


def jac_double(F, pt):
    """Jacobian doubling, no special case (Z = 0 stays Z = 0) (:641, :892)."""
    X, Y, Z = _unbind(F, pt)
    A, B = _unbind(F, F.sqr(_stack(F, [X, Y])))
    D0, YZ, C = _unbind(F, F.mul(_stack(F, [X, Y, B]), _stack(F, [B, Z, B])))
    D = F.add(D0, D0)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.sqr(E), F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    return _stack(F, [X3, Y3, F.add(YZ, YZ)])


def _jac_add_core(F, p1, p2):
    X1, Y1, Z1 = _unbind(F, p1)
    X2, Y2, Z2 = _unbind(F, p2)
    Z1sq, Z2sq = _unbind(F, F.sqr(_stack(F, [Z1, Z2])))
    U1, U2, Z2cu, Z1cu = _unbind(F, F.mul(_stack(F, [X1, X2, Z2, Z1]),
                                          _stack(F, [Z2sq, Z1sq, Z2sq, Z1sq])))
    S1, S2 = _unbind(F, F.mul(_stack(F, [Y1, Y2]), _stack(F, [Z2cu, Z1cu])))
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    Hsq, rsq = _unbind(F, F.sqr(_stack(F, [H, r])))
    Hcu, V, Z1Z2 = _unbind(F, F.mul(_stack(F, [H, U1, Z1]), _stack(F, [Hsq, Hsq, Z2])))
    X3 = F.sub(F.sub(rsq, Hcu), F.add(V, V))
    m = F.mul(_stack(F, [r, S1, Z1Z2]), _stack(F, [F.sub(V, X3), Hcu, H]))
    Y3a, S1Hcu, Z3 = _unbind(F, m)
    return _stack(F, [X3, F.sub(Y3a, S1Hcu), Z3]), F.is_zero(H), F.is_zero(r)


def jac_add(F, p1, p2):
    """Complete Jacobian addition (:661, :913): Z1 = 0 gives p2, else Z2 = 0
    gives p1; equal points double p1; opposite points keep the add's X, Y
    with Z = 0. Each case is computed only on its rows."""
    p1, p2 = torch.broadcast_tensors(p1, p2)
    shape = p1.shape
    tail = shape[-1 - F.dims:]
    a, b = p1.reshape(-1, *tail), p2.reshape(-1, *tail)
    inf1, inf2 = F.is_zero(a[:, 2]), F.is_zero(b[:, 2])
    sel = inf1.reshape(-1, *([1] * len(tail)))
    out = torch.where(sel, b, a)
    live = (~inf1 & ~inf2).nonzero()[:, 0]
    if live.numel():
        res, same_x, same_y = _jac_add_core(F, a[live], b[live])
        dbl = (same_x & same_y).nonzero()[:, 0]
        if dbl.numel():
            res[dbl] = jac_double(F, a[live][dbl])
        res[same_x & ~same_y, 2] = 0
        out[live] = res
    return out.reshape(shape)


def jac_to_affine(F, pt):
    """(X/Z^2, Y/Z^3); Z = 0 gives (0, 0) (inv(0) = 0) (:868, :1043)."""
    X, Y, Z = _unbind(F, pt)
    zinv = F.inv(Z)
    zinv2 = F.sqr(zinv)
    return F.mul(_stack(F, [X, Y]), _stack(F, [zinv2, F.mul(zinv, zinv2)]))


def g1_double(pt):
    return jac_double(_Fp, pt)


def g1_add(p1, p2):
    return jac_add(_Fp, p1, p2)


def g2_double(pt):
    return jac_double(_Fp2, pt)


def g2_add(p1, p2):
    return jac_add(_Fp2, p1, p2)


def _digits(zbits: torch.Tensor) -> torch.Tensor:
    """(N, k) int32 words of z -> (N, 16k) int64 2-bit digits, LSB first."""
    w = zbits.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 2, device=zbits.device)
    return ((w[:, :, None] >> shifts) & 3).flatten(1)


def scalar_mul_limbs(F, pt, zbits):
    """[z]·pt per item, 2-bit windows (:782, :957): the table [0, P, 2P, 3P],
    the top window's entry, then (16k - 1) times two doublings and one
    complete add of the window's entry. pt (N, 3, ...) Jacobian, zbits (N, k)
    int32 words of z (k = 2 for K9's 64-bit z, 8 for K14's r)."""
    n = pt.shape[0]
    p2 = jac_double(F, pt)
    tab = torch.stack([torch.zeros_like(pt), pt, p2, jac_add(F, p2, pt)])
    digits = _digits(zbits)
    rows = torch.arange(n, device=pt.device)
    acc = tab[digits[:, -1], rows]
    for w in range(digits.shape[1] - 2, -1, -1):
        acc = jac_add(F, jac_double(F, jac_double(F, acc)), tab[digits[:, w], rows])
    return acc


def segment_sums_limbs(F, pts, offsets, units):
    """Affine sum of each segment [offsets[d], offsets[d+1]) of Jacobian
    points (N, 3, ...) in K10's order (csrc/curve.cuh `block_tree_sum`):
    unit u of `units` folds the entries u, u + units, ... into infinity, one
    complete add an entry it has, then the units meet in a tree (unit u
    takes unit u + half), and the sum is made affine."""
    counts = (offsets[1:] - offsets[:-1]).tolist()
    d = len(counts)
    rounds = max([-(-c // units) for c in counts] + [0])
    grid = torch.zeros((d, rounds * units) + pts.shape[1:], dtype=pts.dtype, device=pts.device)
    for i, (start, count) in enumerate(zip(offsets[:-1].tolist(), counts)):
        grid[i, :count] = pts[start:start + count]
    grid = grid.reshape((d, rounds, units) + pts.shape[1:])
    have = (torch.arange(rounds * units, device=pts.device).reshape(rounds, units)[None]
            < torch.tensor(counts, device=pts.device)[:, None, None])
    acc = torch.zeros((d, units) + pts.shape[1:], dtype=pts.dtype, device=pts.device)
    for r in range(rounds):
        live = have[:, r]
        if live.any():
            acc[live] = jac_add(F, acc[live], grid[:, r][live])
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = jac_add(F, acc[:, :half], acc[:, half:])
    return jac_to_affine(F, acc[:, 0])


# --- kernel wrappers (words) -----------------------------------------------------


def _check(name, t, tail):
    if t.dtype != torch.int32 or tuple(t.shape[1:]) != tail or t.dim() != 1 + len(tail):
        raise ValueError(f"{name} takes (N, {', '.join(map(str, tail))}) int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.contiguous()


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _instance(name: str, width: int) -> str:
    """The entry point (and launch counter) of kernel `name` for elements of
    `width` words: the limb instance, or its RNS instance `<name>_rns`."""
    return name if word_field(width) is _LimbField else f"{name}_rns"


def _launch(source, name, width, n_ptrs, n_ints, *args):
    entry = _instance(name, width)
    fn = build.entry(source, entry, n_ptrs, n_ints)
    build.count_launch(entry)
    build.check(fn(*args), entry)


def rlc_ladders_plain(p, q, zbits, affine_g1=True):
    """Plain version of K9 (see `rlc_ladders`)."""
    g1 = g2 = None
    F = word_field((p if p is not None else q).shape[-1])
    if p is not None:
        pl = F.to_plain(p)
        jac = torch.cat([pl, plain_field(pl).one(pl).expand_as(pl[:, :1])], 1)
        g1 = scalar_mul_limbs(_Fp, jac, zbits)
        g1 = F.from_plain(jac_to_affine(_Fp, g1) if affine_g1 else g1)
    if q is not None:
        ql = F.to_plain(q)
        jac = torch.cat([ql, f2_one_like(ql[:, :1])], 1)
        g2 = F.from_plain(scalar_mul_limbs(_Fp2, jac, zbits))
    return g1, g2


def rlc_ladders(p, q, zbits, affine_g1=True):
    """K9: [z_i]·p_i over G1 and [z_i]·q_i over G2 (either may be None),
    affine points in, (N, 2) int32 scalar words. Returns (G1 (N, 2, w)
    affine if `affine_g1` else (N, 3, w) Jacobian, G2 (N, 3, 2, w)
    Jacobian), w the elements' width (12 limb words, 64 RNS residues).
    Kernel on CUDA, plain on the CPU."""
    zbits = _check("rlc_ladders zbits", zbits, (2,))
    n = zbits.shape[0]
    w = (p if p is not None else q).shape[-1]
    word_field(w)
    if p is not None:
        p = _check("rlc_ladders p", p, (2, w))
    if q is not None:
        q = _check("rlc_ladders q", q, (2, 2, w))
    for t in (p, q):
        if t is not None and (t.shape[0] != n or t.device != zbits.device):
            raise ValueError("rlc_ladders: points and zbits differ in count or device")
    if is_cpu(zbits):
        return rlc_ladders_plain(p, q, zbits, affine_g1)
    g1 = None if p is None else torch.empty((n, 2 if affine_g1 else 3, w),
                                             dtype=torch.int32, device=zbits.device)
    g2 = None if q is None else torch.empty((n, 3, 2, w), dtype=torch.int32,
                                             device=zbits.device)
    _launch("rlc", "rlc_ladders", w, 5, 3, _ptr(p), _ptr(q), zbits.data_ptr(), _ptr(g1), _ptr(g2),
            n, int(p is not None), int(q is not None), int(affine_g1), build.stream_ptr(zbits))
    return g1, g2


def g2_sum_units(n: int) -> int:
    """K10's G2 units a segment for N points in all (csrc/rlc.cu
    `g2_sums_kernel`): the largest power of two at most N / 4, in [1, 256],
    so that a unit folds about four points before the tree."""
    units = 1
    while units < 256 and units * 8 <= n:
        units *= 2
    return units


def point_sums_plain(pts, offsets):
    """Plain version of K10 (see `point_sums`)."""
    F = word_field(pts.shape[-1])
    g2 = pts.dim() == 4
    units = g2_sum_units(pts.shape[0]) if g2 else F.units
    return F.from_plain(segment_sums_limbs(_Fp2 if g2 else _Fp, F.to_plain(pts), offsets.cpu(),
                                           units))


def point_sums(pts, offsets):
    """K10: the affine sum of each segment [offsets[d], offsets[d+1]) of
    Jacobian points, G1 (N, 3, w) -> (D, 2, w) or G2 (N, 3, 2, w) ->
    (D, 2, 2, w). An empty segment sums to infinity and comes out (0, 0).
    `offsets` (D + 1,) int64 on the points' device. G1: one block a segment
    of 64 units (16 warps under RNS; the limb units four lanes each, 256
    threads a block). G2: `g2_sum_units(N)` units a segment, each one of
    K9's G2 groups (16 lanes, or a block of 8 warps under RNS), over as many
    blocks as they fill, the blocks' partials meeting by tickets. Kernel on
    CUDA, plain on the CPU."""
    g2 = pts.dim() == 4
    w = pts.shape[-1]
    word_field(w)
    pts = _check("point_sums", pts, (3, 2, w) if g2 else (3, w))
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or offsets.device != pts.device:
        raise ValueError("point_sums: offsets must be (D + 1,) int64 on the points' device")
    if is_cpu(pts):
        return point_sums_plain(pts, offsets)
    offsets = offsets.contiguous()
    d = offsets.shape[0] - 1
    out = torch.empty((d, 2) + pts.shape[2:], dtype=torch.int32, device=pts.device)
    units = g2_sum_units(pts.shape[0]) if g2 else 0
    # G2: the blocks' partials (6 elements each) and their tickets
    scratch = (torch.empty(d * units * (6 * w + 1), dtype=torch.int32, device=pts.device)
               if g2 else None)
    _launch("rlc", "point_sums", w, 4, 2, pts.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            _ptr(scratch), d, int(g2), units, build.stream_ptr(pts))
    return out


def miller_loop_plain(q, p):
    """Plain version of K11 (see `miller_loop`)."""
    F = word_field(q.shape[-1])
    f = miller_loop_limbs(F.to_plain(q), F.to_plain(p))
    return F.from_plain(f).reshape(-1, 12, F.words)


def miller_loop(q, p):
    """K11: f_{|x|,Q}(P) conjugated, per pair: Q (B, 2, 2, w) affine on the
    twist, P (B, 2, w) affine -> (B, 12, w). Kernel on CUDA, plain on the
    CPU."""
    global miller_loop_items
    w = q.shape[-1]
    word_field(w)
    q = _check("miller_loop q", q, (2, 2, w))
    p = _check("miller_loop p", p, (2, w))
    if q.shape[0] != p.shape[0] or q.device != p.device:
        raise ValueError("miller_loop: Q and P differ in count or device")
    miller_loop_items += q.shape[0]
    if is_cpu(q):
        return miller_loop_plain(q, p)
    out = torch.empty((q.shape[0], 12, w), dtype=torch.int32, device=q.device)
    _launch("pairing", "miller_loop", w, 3, 0, q.data_ptr(), p.data_ptr(), out.data_ptr(),
            q.shape[0], build.stream_ptr(q))
    return out


def stack_limit() -> int:
    """The card's per-thread stack limit in bytes, first raised to what the
    BLS kernels need (csrc/stack.cuh), as every K9-K12 entry does; launches
    nothing."""
    import ctypes

    out = ctypes.c_longlong(0)
    build.check(build.entry("pairing", "bls_stack_limit", 1)(ctypes.addressof(out), 0, None),
                "bls_stack_limit")
    return out.value


def _f12_limbs(m):
    F = word_field(m.shape[-1])
    p = F.to_plain(m)
    return p.reshape(*m.shape[:-2], 6, 2, p.shape[-1])


def _f12_words(f):
    F = plain_field(f)
    return F.from_plain(f).reshape(*f.shape[:-3], 12, F.words)


def final_exp_batch_plain(m1, m2=None):
    """Plain version of K12's batch mode (see `final_exp_batch`)."""
    f = _f12_limbs(m1)
    if m2 is not None:
        f = f12_mul(f, _f12_limbs(m2))
    cube = final_exponentiation_limbs(f)
    return _f12_words(cube), f12_is_one(cube)


def f12_tree_product_limbs(f):
    """The product of the n Fp12 values f (n, 6, 2, w), in the tree order of
    K12's tail and K25 (csrc/pairing.cu `f12_tree_product`): at each level
    value i takes value i + ceil(n/2)."""
    while f.shape[0] > 1:
        n, half = f.shape[0], (f.shape[0] + 1) // 2
        f = torch.cat([f12_mul(f[:n - half], f[half:]), f[n - half:half]])
    return f[0]


def final_exp_tail_plain(m, extra):
    """Plain version of K12's tail mode (see `final_exp_tail`)."""
    f = f12_tree_product_limbs(_f12_limbs(torch.cat([m, extra[None]])))
    cube = final_exponentiation_limbs(f)
    return _f12_words(cube), f12_is_one(cube)


def f12_product_plain(m):
    """Plain version of K25 (see `f12_product`)."""
    return _f12_words(f12_tree_product_limbs(_f12_limbs(m)))


def f12_product(m):
    """K25: the product of the B Fp12 values m (B, 12, 12), B >= 1 -> (12,
    12), with no final exponentiation (`f12_prod_reduce` :1061): a copy of m
    tree-multiplied as K12's tail does it, a launch a level. Limb field
    only. Kernel on CUDA, plain on the CPU."""
    m = _check("f12_product", m, (12, NWORDS))
    if m.shape[0] < 1:
        raise ValueError("f12_product of no values")
    if is_cpu(m):
        return f12_product_plain(m)
    work = m.clone()
    fn = build.entry("pairing", "f12_product", 1)
    build.count_launch("f12_product")
    build.check(fn(work.data_ptr(), work.shape[0], build.stream_ptr(work)), "f12_product")
    return work[0]


def _final_exp(m1, m2, mode):
    """Launch K12: mode 1 (batch) over the items of m1 (times m2), mode 0
    (tail) over the product of all of m1's rows, which it overwrites."""
    b, w = m1.shape[0], m1.shape[-1]
    out = torch.empty((b if mode == 1 else 1, 12, w), dtype=torch.int32, device=m1.device)
    ok = torch.empty(out.shape[0], dtype=torch.int32, device=m1.device)
    _launch("pairing", "final_exp", w, 4, 1, m1.data_ptr(), _ptr(m2), out.data_ptr(),
            ok.data_ptr(), b, mode, build.stream_ptr(m1))
    return out, ok != 0


def final_exp_batch(m1, m2=None):
    """K12, batch mode: per item the final exponentiation of m1 (times m2
    where given), (B, 12, w) -> (the cube of the reduced pairing (B, 12, w),
    is_one (B,) bool). Kernel on CUDA, plain on the CPU."""
    w = m1.shape[-1]
    word_field(w)
    m1 = _check("final_exp_batch", m1, (12, w))
    if m2 is not None:
        m2 = _check("final_exp_batch m2", m2, (12, w))
        if m2.shape != m1.shape or m2.device != m1.device:
            raise ValueError("final_exp_batch: m1 and m2 differ in shape or device")
    if is_cpu(m1):
        return final_exp_batch_plain(m1, m2)
    return _final_exp(m1, m2, 1)


def final_exp_tail(m, extra):
    """K12, tail mode: the product of the B Miller values m (B, 12, w) and
    `extra` (12, w), then one final exponentiation -> (cube (12, w), is_one
    0-d bool). The tree is a launch a level, a group of units a product,
    then one group exponentiates (csrc/f12_group.cuh). Kernel on CUDA, plain
    on the CPU."""
    w = m.shape[-1]
    word_field(w)
    m = _check("final_exp_tail", m, (12, w))
    if extra.dtype != torch.int32 or tuple(extra.shape) != (12, w) \
            or extra.device != m.device:
        raise ValueError("final_exp_tail: extra must be (12, w) int32 on m's device")
    if is_cpu(m):
        return final_exp_tail_plain(m, extra)
    out, ok = _final_exp(torch.cat([m, extra[None]]), None, 0)
    return out[0], ok[0]


# --- pairings and the randomized batch check (words) ------------------------------


def neg_g1_words(device, width: int = NWORDS) -> torch.Tensor:
    """-G1 affine, (2, width): Montgomery words or RNS residues."""
    if word_field(width) is _RnsField:
        return _RnsField.const(list(NEG_G1), torch.empty(0, device=device)).to(torch.int32)
    return g1_to_words([NEG_G1])[0].to(device)


def pairing_cube_batch(q, p):
    """e(P, Q)^3 per pair (the JAX package's device-canonical pairing)."""
    return final_exp_batch(miller_loop(q, p))[0]


def pairing_check_batch(q1, p1, q2, p2):
    """Per item e(P1, Q1)·e(P2, Q2) == 1: one Miller launch over the 2B pairs,
    one final exponentiation an item. Returns (B,) bool."""
    b = q1.shape[0]
    m = miller_loop(torch.cat([q1, q2]), torch.cat([p1, p2]))
    return final_exp_batch(m[:b], m[b:])[1]


def g1_fixed_mul_neg_g1(zbits):
    """[z_i]·(-G1) per item, Jacobian (N, 3, 12) (`g1_fixed_mul_neg_g1`
    :854). JAX reads 8-bit windows of fixed tables; here K9's G1 ladder runs
    over -G1: the same points by another algorithm (compare affine: the
    Jacobian representatives differ)."""
    zbits = _check("g1_fixed_mul_neg_g1 zbits", zbits, (2,))
    base = neg_g1_words(zbits.device).expand(zbits.shape[0], 2, NWORDS).contiguous()
    return rlc_ladders(base, None, zbits, affine_g1=False)[0]


def rlc_randomize_g1(p, zbits):
    """Stage 1: [z_i]·P_i, affine out (K9, G1 only)."""
    return rlc_ladders(p, None, zbits)[0]


def rlc_collapse_g2(q2, zbits):
    """Stage 2: the bilinearity collapse sum_i [z_i]·sig_i, affine out
    (K9, G2 only, then K10 over one segment)."""
    zsig = rlc_ladders(None, q2, zbits)[1]
    return point_sums(zsig, _whole(zsig))[0]


def _whole(pts):
    return torch.tensor([0, pts.shape[0]], dtype=torch.int64, device=pts.device)


def segment_offsets(seg_ids, num_segments):
    """(order, offsets): a stable order that groups the items by segment and
    the (D + 1,) int64 segment bounds in it (glue)."""
    order = torch.sort(seg_ids.to(torch.int64), stable=True).indices
    counts = torch.bincount(seg_ids.to(torch.int64), minlength=num_segments)[:num_segments]
    return order, torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def g1_segment_sum(pts, seg_ids, num_segments):
    """Affine sum of the Jacobian G1 points of each segment (K10): out[d] =
    sum over i with seg_ids[i] == d; an empty segment gives (0, 0), the
    affine image of infinity (:1172)."""
    order, offsets = segment_offsets(seg_ids, num_segments)
    return point_sums(pts[order], offsets)


def rlc_collapse_g1_by_message(p, zbits, seg_ids, num_segments):
    """Stage 1, grouped: [z_i]·pk_i (K9, Jacobian), then the sum of each
    message's segment (K10) -> (D, 2, 12) affine (:1195)."""
    return g1_segment_sum(rlc_ladders(p, None, zbits, affine_g1=False)[0], seg_ids,
                          num_segments)


def rlc_miller_loop_count(*millers) -> int:
    """Miller loops a set of stage outputs represents: the leading dim of
    each batched Fp12 (1 for a single one)."""
    return sum(int(m.shape[0]) if m.dim() == 3 else 1 for m in millers)


def rlc_tail(m1, m2_single):
    """Stage 3: the product of the batched Miller values with the single
    one, one shared final exponentiation, is_one (K12 tail mode)."""
    return final_exp_tail(m1, m2_single)[1]


def pairing_check_rlc(q1, p1, q2, zbits, seg_ids=None):
    """Randomized batch check with one shared final exponentiation (:1080):

        prod_i e(z_i·P1_i, Q1_i) · e(-G1, sum_i z_i·Q2_i) == 1

    the second pairing of every item being e(-G1, sig_i), which the BLS
    checks always are (JAX's p2_is_neg_g1=True). Without `seg_ids`: Q1
    (N, 2, 2, 12), K9 (G1 affine and G2), K10 (the G2 collapse), one K11
    over N + 1 pairs, K12's tail. With `seg_ids` (N,) int (the grouped
    path): Q1 holds the D distinct H(m) (D, 2, 2, 12), the G1 ladders stay
    Jacobian and K10 sums each message's segment, so K11 runs D + 1 Miller
    loops. Every segment needs a member, and a batch with an empty segment
    fails: its sum is infinity, whose affine image (0, 0) gives a Miller
    value in Fp4 that the final exponentiation maps to 1, so the product
    alone would not fail (the JAX function, :1120-1125, returns that
    product); the segment counts decide it here. Returns a 0-d bool."""
    members = None
    if seg_ids is None:
        a1, zsig = rlc_ladders(p1, q2, zbits, affine_g1=True)
    else:
        z1, zsig = rlc_ladders(p1, q2, zbits, affine_g1=False)
        order, offsets = segment_offsets(seg_ids, q1.shape[0])
        a1 = point_sums(z1[order], offsets)
        members = (offsets[1:] > offsets[:-1]).all()
    aq = point_sums(zsig, _whole(zsig))
    m = miller_loop(torch.cat([q1, aq]),
                    torch.cat([a1, neg_g1_words(a1.device, a1.shape[-1])[None]]))
    ok = rlc_tail(m[:-1], m[-1])
    return ok if members is None else ok & members


def pack_mont(ints, device) -> torch.Tensor:
    """Canonical ints -> (n, 12) Montgomery words on `device`: packed on the
    host, converted in one K8 launch."""
    return fp.to_mont_words(torch.from_numpy(fp.ints_to_words(list(ints))).to(device))


FIELD_BACKENDS = {
    "limb": FieldBackend(NWORDS, pack_mont),
    "rns": FieldBackend(fp_rns.NLIMBS, bls12_field.pack_mont),
}


# --- the MSM, the committee-key sum and the subgroup check (:1254-1494) -----------
#
# JAX's MSM exchanges the bucket scatter for a digit-indexed gather:
#     sum_k k·(sum_{i: d_i = k} P_i) == sum_i [d_i]·P_i,
# so each (item, window) reads [d_ij]·P_i from the item's bucket table, the
# window sums are one tree over the items, and a Horner combine folds the
# windows MSB first. K13 computes that on the card; its result and the plain
# version's are affine, hence canonical whatever order the sums took.

MSM_WINDOW = 4  # default window width: 2^w bucket-table entries an item
# phi(x, y) = (BETA·x, y) on E(Fp): the cube root of unity for which phi acts
# on G1 as [-x^2] (the subgroup check's endomorphism)
BETA = 0x5F19672FDF76CE51BA69C6076A0F77EADDB3A93BE6F89688DE17D813620A00022E01FFFFFFFEFFFE


def msm_window_digits(bits: torch.Tensor, window: int = MSM_WINDOW) -> torch.Tensor:
    """(..., nbits) LSB-first scalar bits (bool or 0/1) -> (..., W) int64 window
    digits, W = ceil(nbits / window); nbits zero-pads up to a multiple of the
    window (:1257)."""
    nbits = bits.shape[-1]
    rem = (-nbits) % window
    b = bits.to(torch.int64)
    if rem:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (rem,))], -1)
    weights = 1 << torch.arange(window, dtype=torch.int64, device=b.device)
    return (b.reshape(b.shape[:-1] + (-1, window)) * weights).sum(-1)


def scalar_words(scalars, nbits: int) -> torch.Tensor:
    """Int scalars -> (n, ceil(nbits / 32)) int32 words, LSB first, each cut
    to its low nbits bits (JAX reads nbits bits of a scalar, :1368)."""
    nwords = (nbits + 31) // 32
    mask = (1 << nbits) - 1
    buf = b"".join((int(s) & mask).to_bytes(4 * nwords, "little") for s in scalars)
    return torch.from_numpy(np.frombuffer(buf, dtype="<u4").astype(np.uint32)
                            .view(np.int32).reshape(-1, nwords).copy())


def _scalar_bits(scalars: torch.Tensor, nbits: int) -> torch.Tensor:
    """(N, nwords) int32 words -> (N, nbits) int64 bits, LSB first."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=scalars.device)
    return ((w[:, :, None] >> shifts) & 1).flatten(1)[:, :nbits]


def _g1_bucket_tables(pt: torch.Tensor, window: int) -> torch.Tensor:
    """Per-item tables tab[k] = [k]·P_i, k < 2^window, stacked on a leading
    axis: pt (N, 3, 24) Jacobian limbs -> (2^w, N, 3, 24) (:1277). Entry 0 is
    the Jacobian zero; even entries double tab[k/2], odd ones add P once."""
    table = [torch.zeros_like(pt), pt]
    for k in range(2, 1 << window):
        table.append(jac_double(_Fp, table[k // 2]) if k % 2 == 0
                     else jac_add(_Fp, table[k - 1], pt))
    return torch.stack(table)


def _sum_points(pts: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of (N, ..., 3, 24) Jacobian G1 limbs: padded with Z = 0
    to a power of two and tree-summed with the complete add."""
    n = pts.shape[0]
    width = 1
    while width < n:
        width *= 2
    if width > n:
        pts = torch.cat([pts, pts.new_zeros((width - n,) + pts.shape[1:])])
    while pts.shape[0] > 1:
        pts = jac_add(_Fp, pts[0::2], pts[1::2])
    return pts[0]


def _check_msm_args(pts, scalars, nbits, window):
    pts = _check("g1_msm points", pts, (3, NWORDS))
    if not 2 <= window <= 8 or nbits < 1:
        raise ValueError(f"g1_msm takes 2 <= window <= 8 and nbits >= 1, got {window}, {nbits}")
    scalars = _check("g1_msm scalars", scalars, ((nbits + 31) // 32,))
    if scalars.shape[0] != pts.shape[0] or scalars.device != pts.device or pts.shape[0] == 0:
        raise ValueError("g1_msm: points and scalars differ in count or device, or are empty")
    return pts, scalars


def g1_msm_plain(pts, scalars, nbits: int, window: int = MSM_WINDOW):
    """Plain version of K13 (see `g1_msm`): digits, bucket tables, the gather,
    one tree over the items for every window, the Horner combine (:1291)."""
    pts, scalars = _check_msm_args(pts, scalars, nbits, window)
    n = pts.shape[0]
    digits = msm_window_digits(_scalar_bits(scalars, nbits), window)  # (N, W)
    tab = _g1_bucket_tables(to_limbs(pts), window)  # (2^w, N, 3, 24)
    rows = torch.arange(n, device=pts.device)[:, None]
    sums = _sum_points(tab[digits, rows])  # (W, 3, 24)
    acc = sums[-1]
    for j in range(sums.shape[0] - 2, -1, -1):
        for _ in range(window):
            acc = jac_double(_Fp, acc)
        acc = jac_add(_Fp, acc, sums[j])
    return to_words(jac_to_affine(_Fp, acc))


def g1_msm(pts, scalars, nbits: int, window: int = MSM_WINDOW):
    """K13: sum_i [s_i]·P_i -> (2, 12) affine words, (0, 0) for the identity.
    pts (N, 3, 12) Jacobian (Z = 0 rows add nothing), scalars (N, ceil(nbits /
    32)) int32 words, LSB first (bits at or above nbits are ignored), 2 <=
    window <= 8. Kernel on CUDA, plain on the CPU."""
    pts, scalars = _check_msm_args(pts, scalars, nbits, window)
    if is_cpu(pts):
        return g1_msm_plain(pts, scalars, nbits, window)
    n = pts.shape[0]
    nwin = -(-nbits // window)
    tab = torch.empty((1 << window, n, 3, NWORDS), dtype=torch.int32, device=pts.device)
    sums = torch.empty((nwin, 3, NWORDS), dtype=torch.int32, device=pts.device)
    out = torch.empty((2, NWORDS), dtype=torch.int32, device=pts.device)
    fn = build.entry("msm", "g1_msm", 5, 3)
    build.count_launch("g1_msm")
    build.check(fn(pts.data_ptr(), scalars.data_ptr(), tab.data_ptr(), sums.data_ptr(),
                   out.data_ptr(), n, scalars.shape[1], nbits, window,
                   build.stream_ptr(pts)), "g1_msm")
    return out


def _mul_x_abs_limbs(pt):
    """[|x|]·pt per item over Jacobian limbs, as the kernel's chain
    (csrc/curve.cuh `jac_mul_x_abs`): from pt (|x|'s top bit), for each lower
    bit a double, then a complete add of pt where the bit is set."""
    acc = pt
    for bit in X_BITS:
        acc = jac_double(_Fp, acc)
        if bit:
            acc = jac_add(_Fp, acc, pt)
    return acc


def g1_subgroup_check_plain(pts):
    """Plain version of K14 (see `g1_subgroup_check`), step by step the
    kernel's chain: Q = [|x|]·[|x|]·P, then phi(P) = -Q in Jacobian form."""
    p = to_limbs(_check("g1_subgroup_check", pts, (3, NWORDS)))
    q = _mul_x_abs_limbs(_mul_x_abs_limbs(p))
    (X, Y, Z), (QX, QY, QZ) = p.unbind(1), q.unbind(1)
    zq2, zp2 = fp_sqr(QZ), fp_sqr(Z)
    zq3, zp3 = fp_mul(zq2, QZ), fp_mul(zp2, Z)
    bx = fp_mul(X, fp.const_limbs(fp.to_mont(BETA), X).expand_as(X))
    same_x = fp_is_zero(fp_sub(fp_mul(bx, zq2), fp_mul(QX, zp2)))
    minus_y = fp_is_zero(fp_add(fp_mul(Y, zq3), fp_mul(QY, zp3)))
    return fp_is_zero(Z) | (~fp_is_zero(QZ) & same_x & minus_y)


def g1_subgroup_check(pts):
    """K14: r-subgroup membership per item, (N, 3, 12) Jacobian -> (N,) bool;
    a Z = 0 row (a pad) reports True. Domain: points on E(Fp), y^2 = x^3 + 4
    (the callers decompress them), where P is in G1 iff phi(P) = -[x^2]·P
    (M. Scott, ePrint 2021/1130; phi(x, y) = (beta·x, y)), the same boolean as
    [r]·P == infinity (JAX's `_g1_subgroup_program` :1347); a point off the
    curve may answer otherwise. The kernel runs a key on a group of four
    lanes (csrc/g1_lanes.cuh). Kernel on CUDA, plain on the CPU."""
    pts = _check("g1_subgroup_check", pts, (3, NWORDS))
    if is_cpu(pts):
        return g1_subgroup_check_plain(pts)
    ok = torch.empty(pts.shape[0], dtype=torch.int32, device=pts.device)
    fn = build.entry("msm", "g1_subgroup", 2)
    build.count_launch("g1_subgroup")
    build.check(fn(pts.data_ptr(), ok.data_ptr(), pts.shape[0], build.stream_ptr(pts)),
                "g1_subgroup")
    return ok != 0


def g1_aggregate(pts):
    """The all-ones MSM, sum_i P_i of (N, 3, 12) Jacobian points -> (2, 12)
    affine words, (0, 0) for infinity (:1339): K10 over one segment."""
    return point_sums(pts, _whole(pts))[0]


def _msm_pow2_pad(n: int, min_bucket: int = 8) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _jacobian_words(points_aff, pads: int, device) -> torch.Tensor:
    """Affine int pairs, then `pads` Jacobian zeros -> (n + pads, 3, 12)
    Montgomery words on `device` (Z = 1 for the points)."""
    n = len(points_aff)
    out = torch.zeros((n + pads, 3, NWORDS), dtype=torch.int32)
    if n:
        out[:n, :2] = torch.from_numpy(fp.ints_to_mont_words(
            [c for pt in points_aff for c in pt]).reshape(n, 2, NWORDS))
        out[:n, 2] = torch.from_numpy(fp.ints_to_words([fp.R_MOD_P])[0])
    return out.to(device)


def _affine_or_none(words):
    """(2, 12) affine words -> an int pair, or None for (0, 0), the image of
    infinity ((0, 0) is not on the curve)."""
    x, y = fp.mont_words_to_ints(words)
    return None if x == 0 and y == 0 else (x, y)


def g1_msm_device(points_aff, scalars, nbits: int, window: int = MSM_WINDOW,
                  device="cuda"):
    """Host-callable MSM (:1376): affine int pairs and int scalars in, the
    affine int pair out (None for the identity). The item count pads to a
    power-of-two bucket (at least 8) with (G1 generator, scalar 0)."""
    dev = resolve_device(device)
    b = _msm_pow2_pad(len(points_aff))
    pad = b - len(points_aff)
    pts = _jacobian_words(list(points_aff) + [oracle.G1_GEN_AFF] * pad, 0, dev)
    sc = scalar_words(list(scalars) + [0] * pad, nbits).to(dev)
    return _affine_or_none(g1_msm(pts, sc, nbits, window))


def g1_aggregate_device(points_aff, device="cuda"):
    """sum_i P_i (:1402): affine int pairs in, the affine pair out (None for
    an infinity sum); pads to the bucket with Jacobian zeros."""
    dev = resolve_device(device)
    b = _msm_pow2_pad(len(points_aff))
    return _affine_or_none(g1_aggregate(_jacobian_words(points_aff, b - len(points_aff), dev)))


def g1_subgroup_check_device(points_aff, device="cuda") -> np.ndarray:
    """r-subgroup membership per affine point (:1426): (n,) bool; the batch
    pads to the bucket with Jacobian zeros (True, discarded)."""
    dev = resolve_device(device)
    n = len(points_aff)
    pts = _jacobian_words(points_aff, _msm_pow2_pad(n) - n, dev)
    return g1_subgroup_check(pts).cpu().numpy()[:n]


# Shape-only cost accounting (:1453-1494), from (n, nbits, window) alone.


def g1_ladder_op_counts(n: int, nbits: int) -> dict:
    """G1 point ops of the per-item ladder for an (n, nbits) MSM: a 4-entry
    table (1 double + 1 add), then ceil(nbits/2) - 1 steps of 2 doubles and
    1 add, an item."""
    nw = (nbits + 1) // 2
    return {"doubles": n * (1 + 2 * (nw - 1)), "adds": n * nw}


def g1_subgroup_chain_op_counts(n: int) -> dict:
    """Work of K14's chain for n keys (pads excluded): two passes of [|x|]
    over |x|'s 64 bits, 6 of them set (63 doubles and 5 complete adds a
    pass), and the 9 Fp products of the Jacobian compare phi(P) = -Q."""
    return {"doubles": n * 2 * len(X_BITS), "adds": n * 2 * sum(X_BITS), "fp_muls": n * 9}


def g1_msm_op_counts(n: int, nbits: int, window: int = MSM_WINDOW) -> dict:
    """G1 point ops of the bucket MSM for an (n, nbits, w) MSM: the tables,
    the window tree and the Horner combine."""
    n_windows = -(-nbits // window)
    half = (1 << (window - 1)) - 1
    return {"doubles": n * half + window * (n_windows - 1),
            "adds": n * half + (n - 1) * n_windows + (n_windows - 1)}


def g1_msm_data_op_counts(scalars: torch.Tensor, nbits: int, window: int = MSM_WINDOW) -> dict:
    """The point ops an MSM's own (N, nwords) scalar words need, where
    `g1_msm_op_counts` counts every item and digit of the shape: tables for
    the items with a nonzero digit, (nonzero digits - 1) tree adds a window,
    and the Horner combine from the top window with a nonzero digit. Pads
    (scalar 0) and zero digits cost nothing; dense digits give the shape's
    count."""
    nz = msm_window_digits(_scalar_bits(scalars.cpu(), nbits), window) != 0
    items = int(nz.any(dim=1).sum())
    per_window = nz.sum(dim=0)
    tree = int((per_window - 1).clamp(min=0).sum())
    used = torch.nonzero(per_window).flatten()
    steps = int(used[-1]) if used.numel() else 0
    half = (1 << (window - 1)) - 1
    return {"doubles": items * half + window * steps,
            "adds": items * half + tree + steps}


# --- the kernels' constants -------------------------------------------------------


def cuda_constants_header() -> str:
    """The text of csrc/bls_constants.cuh, generated from these constants (a
    test holds the committed file equal to it)."""
    def words(x):
        return "{" + ", ".join(f"0x{int(w):08x}u" for w in fp.int_to_words(x)) + "}"

    def f2_rows(gs):
        return ",\n    ".join("{" + words(fp.to_mont(g[0])) + ", " + words(fp.to_mont(g[1])) + "}"
                              for g in gs)

    return f"""// Generated by consensus_specs_tpu_torch.ops.bls12.cuda_constants_header();
// a test holds this file equal to its output. Field values in Montgomery form
// (R = 2^384), twelve little-endian 32-bit words each.
#pragma once
#include <cstdint>

__device__ __constant__ uint32_t FP_P[12] = {words(P)};
__device__ __constant__ uint32_t FP_ONE[12] = {words(fp.R_MOD_P)};
__device__ __constant__ uint32_t FP_R2[12] = {words(fp.R2_MOD_P)};
// the square root's exponent (a plain integer), (p + 1) / 4
__device__ __constant__ uint32_t FP_EXP_SQRT[12] = {words((P + 1) // 4)};
#define FP_N0 0x{fp.N0_32:08x}u  // -p^-1 mod 2^32
// the inverse's constants (csrc/fp.cuh fp_inv): p in 30-bit limbs, p^-1 mod
// 2^30, and R^3 mod p, the product that takes (aR)^-1 to a^-1 R
__device__ __constant__ int32_t FP_P30[{fp.S30_LIMBS}] = {{{", ".join(f"0x{l:08x}" for l in fp.int_to_s30(P))}}};
#define FP_PINV30 0x{fp.P_INV30:08x}u
__device__ __constant__ uint32_t FP_R3[12] = {words(fp.R3_MOD_P)};
// beta, the cube root of unity of the subgroup check's phi(x, y) = (beta·x, y)
__device__ __constant__ uint32_t FP_BETA[12] = {words(fp.to_mont(BETA))};
#define X_ABS 0x{ABS_X:016x}ull  // |x|, the BLS parameter
// gamma1^k = xi^(k(p-1)/6) and gamma2^k = conj(gamma1^k)·gamma1^k, k = 0..5
__device__ __constant__ uint32_t GAMMA1[6][2][12] = {{
    {f2_rows(GAMMA1)}}};
__device__ __constant__ uint32_t GAMMA2[6][2][12] = {{
    {f2_rows(GAMMA2)}}};
"""
