"""BLS12-381 towers, curves, optimal-ate pairing and the randomized batch
check over a field module `F` (counterpart of ops/bls12_jax.py, as that
module writes them over its swappable field backend).

Here `F` is ops/fp_rns.py, the RNS field: every Fp operation is one call of
`F` (on the card one launch of K24 `rns_ops`), and what lies between them
(stacking, indexing, selection, concatenation) is torch glue. This module is
the mirror of JAX's tower code on JAX's default field, held against it on
the CPU; no flush runs it. The flush's "rns" field backend
(ops/bls12.set_field_backend) runs K9-K12's RNS instances (ops/bls12.py),
whose plain version uses the kernels' formulas; `pack_mont` here is that
backend's packing.

The code follows bls12_jax.py line for line: the same stacked calls, the
same wide products with one Montgomery reduction per output coefficient,
the same order of operations, `torch.where` where JAX selects. Its loops
(`fori_loop`, `lax.cond` over the 63 bits of |x|, the window ladders)
become Python loops over the same bits. So on the CPU its residues equal
JAX's default path's but for the one difference of ops/fp_rns.py (an alpha
next to 1/4 on a first base extension gives r + p for r): Fp2 and Fp12
values, Miller-loop outputs and final exponentiations are equal mod p, and
every boolean is equal (tests/test_torch_bls12_field.py).

Representation, as in bls12_jax.py: Fp (..., 64) int32 residues, Fp2 a tuple
(re, im), Fp12 a tuple of six Fp2 coefficients of w^i (w^6 = xi = 1 + u),
points tuples of coordinates, batch axes leading; scalars as (..., nbits)
bool, least significant bit first. The final exponentiation yields the cube
of the reduced pairing (bls12_jax.py:28-34).

Not here, waiting for their "rns" configuration: `g1_fixed_mul_neg_g1`
(:854, no caller) and the MSM, aggregation and subgroup programs
(:1257-1352), which run over the limb kernels K10, K13 and K14.
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto import bls12_381 as oracle
from . import fp_rns

F = fp_rns

P = F.P
_X_BITS = [int(c) for c in bin(abs(oracle.X_PARAM))[3:]]  # the Miller loop's bits, MSB dropped

_DEVICE_CONSTS: dict = {}
miller_loop_items = 0  # Miller loops run through `miller_loop_batch` (items)


def _on(arr, like: torch.Tensor) -> torch.Tensor:
    """A module-level numpy constant as a tensor on like's device (cached)."""
    key = (id(arr), str(like.device))
    hit = _DEVICE_CONSTS.get(key)
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.from_numpy(np.ascontiguousarray(arr)).to(like.device))
        _DEVICE_CONSTS[key] = hit
    return hit[1]


def _one(like: torch.Tensor) -> torch.Tensor:
    """F.ONE_MONT broadcast to like's shape."""
    return _on(F.ONE_MONT, like).expand(like.shape)


# --- Fp2 = Fp[u]/(u^2 + 1) (:82-180) -------------------------------------------


def f2_zero_like(x):
    z = torch.zeros_like(x[0])
    return (z, z)


def f2_one_like(x):
    one = _one(x[0])
    return (one, torch.zeros_like(one))


def f2_add(x, y):
    return (F.fp_add(x[0], y[0]), F.fp_add(x[1], y[1]))


def f2_sub(x, y):
    return (F.fp_sub(x[0], y[0]), F.fp_sub(x[1], y[1]))


def f2_neg(x):
    return (F.fp_neg(x[0]), F.fp_neg(x[1]))


def f2_conj(x):
    return (x[0], F.fp_neg(x[1]))


def _bcast2(x, y):
    a, b = torch.broadcast_tensors(x[0], y[0])
    c, d = torch.broadcast_tensors(x[1], y[1])
    return (a, c), (b, d)


def f2_mul_wide(x, y):
    """Karatsuba, three stacked Fp products, the result WIDE (not yet
    Montgomery-reduced)."""
    x, y = _bcast2(x, y)
    a, b = x
    c, d = y
    A = torch.stack([a, b, F.fp_add(a, b)])
    B = torch.stack([c, d, F.fp_add(c, d)])
    M = F.fp_mul_wide(A, B)
    ac, bd, t = M[0], M[1], M[2]
    return (F.fp_sub(ac, bd), F.fp_sub(F.fp_sub(t, ac), bd))


def f2_reduce(x):
    return (F.fp_mont_reduce(x[0]), F.fp_mont_reduce(x[1]))


def f2_mul(x, y):
    return f2_reduce(f2_mul_wide(x, y))


def f2_sqr(x):
    a, b = x
    A = torch.stack([F.fp_add(a, b), F.fp_add(a, a)])
    B = torch.stack([F.fp_sub(a, b), b])
    M = F.fp_mont_reduce(F.fp_mul_wide(A, B))
    return (M[0], M[1])


def f2_mul_fp(x, s):
    S = torch.stack(torch.broadcast_tensors(s, s))
    M = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(x[0], x[1])), S)
    return (M[0], M[1])


def f2_mul_xi(x):
    """x·xi with xi = 1 + u: (a + bu)(1 + u) = (a - b) + (a + b)u."""
    a, b = x
    return (F.fp_sub(a, b), F.fp_add(a, b))


def f2_inv(x):
    a, b = x
    norm = F.fp_add(F.fp_mont_sqr(a), F.fp_mont_sqr(b))
    ninv = F.fp_inv(norm)
    M = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(a, b)), ninv)
    return (M[0], F.fp_neg(M[1]))


def f2_stack(elems):
    """A list of Fp2 -> one Fp2 with a leading axis of len(elems)."""
    res = [torch.broadcast_tensors(e[0], e[1]) for e in elems]
    shape = torch.broadcast_shapes(*[r[0].shape for r in res])
    return (torch.stack([r[0].expand(shape) for r in res]),
            torch.stack([r[1].expand(shape) for r in res]))


def f2_unstack(x, n):
    return [(x[0][i], x[1][i]) for i in range(n)]


def f2_is_zero(x):
    return F.fp_is_zero(x[0]) & F.fp_is_zero(x[1])


# --- Fp12 as six Fp2 coefficients of w^i, w^6 = xi (:183-436) --------------------


def f12_one_like(c):
    one = f2_one_like(c)
    z = f2_zero_like(c)
    return (one, z, z, z, z, z)


def f12_conj(x):
    """f^(p^6): the odd coefficients negated."""
    return tuple(c if i % 2 == 0 else f2_neg(c) for i, c in enumerate(x))


def _combine_tables(pairs):
    """Index tables from a product list (degrees i + j) to the 6
    coefficients, padded with len(pairs) (a zero row appended)."""
    lo = [[] for _ in range(6)]
    hi = [[] for _ in range(6)]
    for idx, (i, j) in enumerate(pairs):
        d = i + j
        (lo[d] if d < 6 else hi[d - 6]).append(idx)
    pad = len(pairs)
    lo_w = max(max(len(g) for g in lo), 1)
    hi_w = max(max(len(g) for g in hi), 1)
    lo_m = np.full((6, lo_w), pad, dtype=np.int64)
    hi_m = np.full((6, hi_w), pad, dtype=np.int64)
    for k in range(6):
        lo_m[k, : len(lo[k])] = lo[k]
        hi_m[k, : len(hi[k])] = hi[k]
    return lo_m, hi_m


def _combine_products(prod, lo_m, hi_m):
    """prod: stacked WIDE Fp2 products (m, ..., 64) -> 6 coefficients,
    out[k] = sum(lo) + xi·sum(hi), one Montgomery reduction a coefficient
    (twelve, in one call)."""
    Pre, Pim = prod
    zero = torch.zeros_like(Pre[:1])
    PreE = torch.cat([Pre, zero])
    PimE = torch.cat([Pim, zero])
    lo_i, hi_i = _on(lo_m, Pre), _on(hi_m, Pre)
    lo_re = F.fp_sum_stack(PreE[lo_i], axis=1)  # (6, ..., 64)
    lo_im = F.fp_sum_stack(PimE[lo_i], axis=1)
    hi_re = F.fp_sum_stack(PreE[hi_i], axis=1)
    hi_im = F.fp_sum_stack(PimE[hi_i], axis=1)
    xi_re, xi_im = F.fp_sub(hi_re, hi_im), F.fp_add(hi_re, hi_im)
    out = F.fp_mont_reduce(torch.stack([F.fp_add(lo_re, xi_re), F.fp_add(lo_im, xi_im)]))
    out_re, out_im = out[0], out[1]
    return tuple((out_re[k], out_im[k]) for k in range(6))


_FULL_PAIRS = [(i, j) for i in range(6) for j in range(6)]
_FULL_I = np.array([i for i, _ in _FULL_PAIRS], dtype=np.int64)
_FULL_J = np.array([j for _, j in _FULL_PAIRS], dtype=np.int64)
_FULL_LO, _FULL_HI = _combine_tables(_FULL_PAIRS)


def f12_mul(x, y):
    X = f2_stack(list(x))
    Y = f2_stack(list(y))
    fi, fj = _on(_FULL_I, X[0]), _on(_FULL_J, X[0])
    A = (X[0][fi], X[1][fi])
    B = (Y[0][fj], Y[1][fj])
    prod = f2_mul_wide(A, B)  # (36, ..., 64) wide
    return _combine_products(prod, _FULL_LO, _FULL_HI)


def _fp4_mul_wide(u, v):
    """(a + b·s)(c + d·s) = (ac + xi·bd) + (ad + bc)·s, s = w^3, Karatsuba
    over Fp2, products kept wide."""
    a, b = u
    c, d = v
    X = f2_stack([a, b, f2_add(a, b)])
    Y = f2_stack([c, d, f2_add(c, d)])
    M = f2_mul_wide(X, Y)
    ac = (M[0][0], M[1][0])
    bd = (M[0][1], M[1][1])
    t = (M[0][2], M[1][2])
    return (f2_add(ac, f2_mul_xi(bd)), f2_sub(f2_sub(t, ac), bd))


def _fp4_dbl(u):
    return (f2_add(u[0], u[0]), f2_add(u[1], u[1]))


def _fp4_mul_s(u):
    """s·(a + b·s) = xi·b + a·s."""
    return (f2_mul_xi(u[1]), u[0])


def f12_sqr(x):
    """Squaring in the Fp4 view (:245): with f = A + B·w + C·w^2,
    f^2 = (A^2 + 2BC·s) + (2AB + C^2·s)·w + (B^2 + 2AC)·w^2; one batched
    reduction for the 12 coefficients."""
    c0, c1, c2, c3, c4, c5 = x
    A = (c0, c3)
    B = (c1, c4)
    C = (c2, c5)
    A2 = _fp4_mul_wide(A, A)
    B2 = _fp4_mul_wide(B, B)
    C2 = _fp4_mul_wide(C, C)
    AB = _fp4_mul_wide(A, B)
    AC = _fp4_mul_wide(A, C)
    BC = _fp4_mul_wide(B, C)
    out0 = tuple(f2_add(p_, q_) for p_, q_ in zip(A2, _fp4_mul_s(_fp4_dbl(BC))))
    out1 = tuple(f2_add(p_, q_) for p_, q_ in zip(_fp4_dbl(AB), _fp4_mul_s(C2)))
    out2 = tuple(f2_add(p_, q_) for p_, q_ in zip(B2, _fp4_dbl(AC)))
    re = torch.stack([out0[0][0], out1[0][0], out2[0][0], out0[1][0], out1[1][0], out2[1][0]])
    im = torch.stack([out0[0][1], out1[0][1], out2[0][1], out0[1][1], out1[1][1], out2[1][1]])
    red = F.fp_mont_reduce(torch.stack([re, im]))
    rre, rim = red[0], red[1]
    return tuple((rre[k], rim[k]) for k in range(6))


_SPARSE_J = (0, 3, 5)
_SPARSE_PAIRS = [(i, j) for j in _SPARSE_J for i in range(6)]
_SPARSE_I = np.array([i for i, _ in _SPARSE_PAIRS], dtype=np.int64)
_SPARSE_LO, _SPARSE_HI = _combine_tables(_SPARSE_PAIRS)


def f12_mul_sparse035(f, l0, l3, l5):
    """f·(l0 + l3·w^3 + l5·w^5), 18 stacked products."""
    Fs = f2_stack(list(f))
    si = _on(_SPARSE_I, Fs[0])
    A = (Fs[0][si], Fs[1][si])
    L = f2_stack([l0] * 6 + [l3] * 6 + [l5] * 6)
    prod = f2_mul_wide(A, L)
    return _combine_products(prod, _SPARSE_LO, _SPARSE_HI)


# the Fp6 view (v = w^2, Fp6 = Fp2[v]/(v^3 - xi)), for the inverse only


def _f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a0, c0), f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


def _f6_mul_by_v(a):
    return (f2_mul_xi(a[2]), a[0], a[1])


def f12_inv(x):
    c0, c1 = (x[0], x[2], x[4]), (x[1], x[3], x[5])
    # (c0 + c1 w)^-1 = (c0 - c1 w) / (c0^2 - c1^2 v)
    c1sq_v = _f6_mul_by_v(_f6_mul(c1, c1))
    denom = tuple(f2_sub(a, b) for a, b in zip(_f6_mul(c0, c0), c1sq_v))
    dinv = _f6_inv(denom)
    num0 = _f6_mul(c0, dinv)
    num1 = tuple(f2_neg(c) for c in _f6_mul(c1, dinv))
    return (num0[0], num1[0], num0[1], num1[1], num0[2], num1[2])


# Frobenius constants, from the oracle's Fp2 arithmetic, in this field's form
_GAMMA1 = [oracle.f2_pow(oracle.XI, i * (P - 1) // 6) for i in range(6)]
_GAMMA2 = [oracle.f2_mul(oracle.f2_conj(g), g) for g in _GAMMA1]


def _const_f2_stack(gammas):
    return (np.stack([F.to_mont(g[0]) for g in gammas]),
            np.stack([F.to_mont(g[1]) for g in gammas]))


_GAMMAS = (_const_f2_stack(_GAMMA1), _const_f2_stack(_GAMMA2))


def _gamma_shaped(g, like):
    """(6, 64) constant -> (6, 1, ..., 1, 64) against like (..., 64)."""
    return _on(g, like).reshape((6,) + (1,) * (like.dim() - 1) + (F.NLIMBS,))


def f12_frobenius(x):
    """f^p: each coefficient conjugated, times gamma1^i (stacked)."""
    g_re, g_im = _GAMMAS[0]
    Xs = f2_stack([f2_conj(c) for c in x])
    prod = f2_mul(Xs, (_gamma_shaped(g_re, x[0][0]), _gamma_shaped(g_im, x[0][0])))
    return tuple(f2_unstack(prod, 6))


def f12_frobenius2(x):
    """f^(p^2): coefficient i times gamma2^i."""
    g_re, g_im = _GAMMAS[1]
    Xs = f2_stack(list(x))
    prod = f2_mul(Xs, (_gamma_shaped(g_re, x[0][0]), _gamma_shaped(g_im, x[0][0])))
    return tuple(f2_unstack(prod, 6))


# --- the Miller loop (:442-536) ---------------------------------------------------


def _dbl_step(T, xp, yp):
    """One doubling of T = (X, Y, Z), Jacobian on E'(Fp2), and its line
    l0 = 2YZ^3·xi·yp, l3 = 3X^3 - 2Y^2, l5 = -3X^2Z^2·xp."""
    X, Y, Z = T
    sq = f2_sqr(f2_stack([X, Y, Z]))
    A, B, Zsq = f2_unstack(sq, 3)
    E = f2_add(f2_add(A, A), A)
    m1 = f2_mul(f2_stack([X, Y, Z, E, E]), f2_stack([B, Z, Zsq, X, Zsq]))
    D0, YZ, Zcu, EX, EZsq = f2_unstack(m1, 5)
    D = f2_add(D0, D0)
    D = f2_add(D, D)
    sq2 = f2_sqr(f2_stack([E, B]))
    Fq, C = f2_unstack(sq2, 2)
    X3 = f2_sub(Fq, f2_add(D, D))
    C8 = f2_add(C, C)
    C8 = f2_add(C8, C8)
    C8 = f2_add(C8, C8)
    m2 = f2_mul(f2_stack([E, Y]), f2_stack([f2_sub(D, X3), Zcu]))
    Y3a, YZcu = f2_unstack(m2, 2)
    Y3 = f2_sub(Y3a, C8)
    Z3 = f2_add(YZ, YZ)
    xi0 = f2_mul_xi(f2_add(YZcu, YZcu))
    lm = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(xi0[0], xi0[1], EZsq[0], EZsq[1])),
                       torch.stack(torch.broadcast_tensors(yp, yp, xp, xp)))
    l0 = (lm[0], lm[1])
    l5 = f2_neg((lm[2], lm[3]))
    l3 = f2_sub(EX, f2_add(B, B))
    return (X3, Y3, Z3), (l0, l3, l5)


def _add_step(T, Q, xp, yp):
    """Mixed addition T + Q (Q affine on E'(Fp2)) and its line."""
    X, Y, Z = T
    xq, yq = Q
    Zsq = f2_sqr(Z)
    m1 = f2_mul(f2_stack([xq, Z]), f2_stack([Zsq, Zsq]))
    U, Zcu = f2_unstack(m1, 2)
    S = f2_mul(yq, Zcu)
    H = f2_sub(U, X)
    r = f2_sub(S, Y)
    sq = f2_sqr(f2_stack([H, r]))
    Hsq, rsq = f2_unstack(sq, 2)
    m2 = f2_mul(f2_stack([H, X, H]), f2_stack([Hsq, Hsq, Z]))
    Hcu, V, HZ = f2_unstack(m2, 3)
    X3 = f2_sub(f2_sub(rsq, Hcu), f2_add(V, V))
    m3 = f2_mul(f2_stack([r, Y, r, HZ]), f2_stack([f2_sub(V, X3), Hcu, xq, yq]))
    Y3a, YHcu, rxq, HZyq = f2_unstack(m3, 4)
    Y3 = f2_sub(Y3a, YHcu)
    Z3 = f2_mul(Z, H)
    xiHZ = f2_mul_xi(HZ)
    lm = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(xiHZ[0], xiHZ[1], r[0], r[1])),
                       torch.stack(torch.broadcast_tensors(yp, yp, xp, xp)))
    l0 = (lm[0], lm[1])
    l5 = f2_neg((lm[2], lm[3]))
    l3 = f2_sub(rxq, HZyq)
    return (X3, Y3, Z3), (l0, l3, l5)


def miller_loop_batch(Qx, Qy, xp, yp):
    """f_{|x|,Q}(P), conjugated (x < 0): Qx, Qy Fp2, xp, yp Fp, batched."""
    global miller_loop_items
    miller_loop_items += torch.broadcast_shapes(Qx[0].shape, xp.shape).numel() // F.NLIMBS
    f = f12_one_like(Qx)
    T = (Qx, Qy, f2_one_like(Qx))
    for bit in _X_BITS:
        T, (l0, l3, l5) = _dbl_step(T, xp, yp)
        f = f12_mul_sparse035(f12_sqr(f), l0, l3, l5)
        if bit:
            T, (l0, l3, l5) = _add_step(T, (Qx, Qy), xp, yp)
            f = f12_mul_sparse035(f, l0, l3, l5)
    return f12_conj(f)


# --- the final exponentiation (:539-626) -------------------------------------------


def f12_cyclotomic_sqr(f):
    """Granger-Scott squaring of a unitary f (:539):
    f^2 = (3A^2 - 2conj(A)) + (3xi·C^2 + 2conj(B))·w + (3B^2 - 2conj(C))·w^2."""
    c0, c1, c2, c3, c4, c5 = f
    A = (c0, c3)
    B = (c1, c4)
    C = (c2, c5)

    def fp4_sqr(x):
        a, b = x
        X = f2_stack([a, b, a])
        Y = f2_stack([a, b, b])
        M = f2_mul_wide(X, Y)
        a2 = (M[0][0], M[1][0])
        b2 = (M[0][1], M[1][1])
        ab = (M[0][2], M[1][2])
        re = f2_add(a2, f2_mul_xi(b2))
        im = f2_add(ab, ab)
        red = f2_reduce(f2_stack([re, im]))
        return ((red[0][0], red[1][0]), (red[0][1], red[1][1]))

    def triple(x):
        return f2_add(f2_add(x, x), x)

    def fp4_conj(x):
        return (x[0], f2_neg(x[1]))

    A2 = fp4_sqr(A)
    B2 = fp4_sqr(B)
    C2 = fp4_sqr(C)
    cA = fp4_conj(A)
    cB = fp4_conj(B)
    cC = fp4_conj(C)
    sC2 = _fp4_mul_s(C2)
    Ao = tuple(f2_sub(triple(t), f2_add(c, c)) for t, c in zip(A2, cA))
    Bo = tuple(f2_add(triple(t), f2_add(c, c)) for t, c in zip(sC2, cB))
    Co = tuple(f2_sub(triple(t), f2_add(c, c)) for t, c in zip(B2, cC))
    return (Ao[0], Bo[0], Co[0], Ao[1], Bo[1], Co[1])


def _f12_pow_abs_x(f):
    """f^|x| for a unitary f, square-and-multiply over |x|'s bits."""
    r = f
    for bit in _X_BITS:
        r = f12_cyclotomic_sqr(r)
        if bit:
            r = f12_mul(r, f)
    return r


def _f12_pow_x(f):
    """f^x, x < 0: the conjugate of f^|x| (cyclotomic subgroup)."""
    return f12_conj(_f12_pow_abs_x(f))


def final_exponentiation_batch(f):
    # the easy part: f^((p^6 - 1)(p^2 + 1))
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius2(f), f)
    # the hard part: (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3
    fx = _f12_pow_x(f)
    a = f12_mul(fx, f12_conj(f))
    ax = _f12_pow_x(a)
    a = f12_mul(ax, f12_conj(a))
    b = f12_mul(_f12_pow_x(a), f12_frobenius(a))
    c = f12_mul(f12_mul(_f12_pow_x(_f12_pow_x(b)), f12_frobenius2(b)), f12_conj(b))
    f3 = f12_mul(f12_sqr(f), f)
    return f12_mul(c, f3)


def f12_is_one(f):
    """(...) bool: f == 1, through the field's class compares."""
    ok = F.fp_is_one_mont(f[0][0])
    zero_parts = [f[0][1]]
    for c in f[1:]:
        zero_parts.extend([c[0], c[1]])
    z = F.fp_is_zero(torch.stack(torch.broadcast_tensors(*zero_parts)))
    return ok & z.all(0)


# --- G1 Jacobian (:641-740) ---------------------------------------------------------


def g1_double(pt):
    X, Y, Z = pt
    sq = F.fp_mont_mul(torch.stack([X, Y, Z]), torch.stack([X, Y, Z]))
    A, B = sq[0], sq[1]
    m1 = F.fp_mont_mul(torch.stack([X, Y]), torch.stack([B, Z]))
    D0, YZ = m1[0], m1[1]
    C = F.fp_mont_sqr(B)
    D = F.fp_add(D0, D0)
    D = F.fp_add(D, D)
    E = F.fp_add(F.fp_add(A, A), A)
    Fv = F.fp_mont_sqr(E)
    X3 = F.fp_sub(Fv, F.fp_add(D, D))
    C8 = F.fp_add(C, C)
    C8 = F.fp_add(C8, C8)
    C8 = F.fp_add(C8, C8)
    Y3 = F.fp_sub(F.fp_mont_mul(E, F.fp_sub(D, X3)), C8)
    Z3 = F.fp_add(YZ, YZ)
    return (X3, Y3, Z3)


def _sel(c, a, b):
    return torch.where(c[..., None], a, b)


def g1_add(p1, p2):
    """JAX's complete addition: infinity in returns the other point, equal
    points double, opposite points give Z = 0; branch-free selects."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    inf1 = F.fp_is_zero(Z1)
    inf2 = F.fp_is_zero(Z2)
    Z1sq = F.fp_mont_sqr(Z1)
    Z2sq = F.fp_mont_sqr(Z2)
    m1 = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(X1, X2, Z2, Z1)),
                       torch.stack(torch.broadcast_tensors(Z2sq, Z1sq, Z2sq, Z1sq)))
    U1, U2, Z2cu, Z1cu = m1[0], m1[1], m1[2], m1[3]
    m2 = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(Y1, Y2)),
                       torch.stack(torch.broadcast_tensors(Z2cu, Z1cu)))
    S1, S2 = m2[0], m2[1]
    H = F.fp_sub(U2, U1)
    r = F.fp_sub(S2, S1)
    same_x = F.fp_is_zero(H)
    same_y = F.fp_is_zero(r)
    Hsq = F.fp_mont_sqr(H)
    m3 = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(H, U1, Z1)),
                       torch.stack(torch.broadcast_tensors(Hsq, Hsq, Z2)))
    Hcu, V, Z1Z2 = m3[0], m3[1], m3[2]
    rsq = F.fp_mont_sqr(r)
    X3 = F.fp_sub(F.fp_sub(rsq, Hcu), F.fp_add(V, V))
    m4 = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(r, S1, Z1Z2)),
                       torch.stack(torch.broadcast_tensors(F.fp_sub(V, X3), Hcu, H)))
    Y3 = F.fp_sub(m4[0], m4[1])
    Z3 = m4[2]
    dX, dY, dZ = g1_double(p1)
    is_dbl = same_x & same_y & ~inf1 & ~inf2
    is_inf_out = same_x & ~same_y & ~inf1 & ~inf2
    X3 = _sel(is_dbl, dX, X3)
    Y3 = _sel(is_dbl, dY, Y3)
    Z3 = _sel(is_dbl, dZ, Z3)
    Z3 = torch.where(is_inf_out[..., None], torch.zeros_like(Z3), Z3)
    X3 = _sel(inf1, X2, _sel(inf2, X1, X3))
    Y3 = _sel(inf1, Y2, _sel(inf2, Y1, Y3))
    Z3 = _sel(inf1, Z2, _sel(inf2, Z1, Z3))
    return (X3, Y3, Z3)


def g1_sum_reduce(pts):
    """Tree sum of a (N, ...) batch of Jacobian points over the leading axis."""
    X, Y, Z = pts
    n = X.shape[0]
    while n > 1:
        half = n // 2
        even = (X[: 2 * half : 2], Y[: 2 * half : 2], Z[: 2 * half : 2])
        odd = (X[1 : 2 * half : 2], Y[1 : 2 * half : 2], Z[1 : 2 * half : 2])
        sX, sY, sZ = g1_add(even, odd)
        if n % 2:
            sX = torch.cat([sX, X[-1:]])
            sY = torch.cat([sY, Y[-1:]])
            sZ = torch.cat([sZ, Z[-1:]])
        X, Y, Z = sX, sY, sZ
        n = X.shape[0]
    return X[0], Y[0], Z[0]


def _digits(bits):
    """(..., nbits) LSB-first bits -> (..., nbits/2) 2-bit window digits,
    nbits padded to even."""
    if bits.shape[-1] % 2:
        bits = torch.cat([bits, torch.zeros_like(bits[..., :1])], -1)
    pairs = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 2, 2).to(torch.int64)
    return pairs[..., 0] + 2 * pairs[..., 1]


def _gather_window(tab, digits, w):
    """tab[d_w] per item: tab (4, ..., 64), digits (..., W)."""
    d = digits[..., w][None, ..., None]
    return torch.gather(tab, 0, d.expand(1, *tab.shape[1:]))[0]


def g1_scalar_mul_batch(pt, bits):
    """[z]P per item over `bits` ((..., nbits) bool, LSB first), Jacobian in
    and out, 2-bit fixed windows (:782): a per-item table [0, P, 2P, 3P],
    then a window at a time two doublings and one table-gathered add."""
    digits = _digits(bits)
    n_windows = digits.shape[-1]
    X, Y, Z = pt
    inf = (torch.zeros_like(X), torch.zeros_like(Y), torch.zeros_like(Z))
    p2 = g1_double(pt)
    table = [inf, pt, p2, g1_add(p2, pt)]
    tab = tuple(torch.stack([t[i] for t in table]) for i in range(3))

    def gather(w):
        return tuple(_gather_window(c, digits, w) for c in tab)

    acc = gather(n_windows - 1)
    for i in range(n_windows - 1):
        w = n_windows - 2 - i
        acc = g1_double(g1_double(acc))
        acc = g1_add(acc, gather(w))
    return acc


def _g1_jacobian_to_affine_batch(pt):
    X, Y, Z = pt
    zinv = F.fp_inv(Z)
    zinv2 = F.fp_mont_sqr(zinv)
    M = F.fp_mont_mul(torch.stack(torch.broadcast_tensors(X, Y)),
                      torch.stack(torch.broadcast_tensors(zinv2, F.fp_mont_mul(zinv, zinv2))))
    return M[0], M[1]


# --- G2 Jacobian on the twist, over Fp2 (:888-1050) ---------------------------------


def g2_double(pt):
    X, Y, Z = pt
    A = f2_sqr(X)
    B = f2_sqr(Y)
    C = f2_sqr(B)
    D0 = f2_mul(X, B)
    YZ = f2_mul(Y, Z)
    D = f2_add(D0, D0)
    D = f2_add(D, D)
    E = f2_add(f2_add(A, A), A)
    Fv = f2_sqr(E)
    X3 = f2_sub(Fv, f2_add(D, D))
    C8 = f2_add(C, C)
    C8 = f2_add(C8, C8)
    C8 = f2_add(C8, C8)
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), C8)
    Z3 = f2_add(YZ, YZ)
    return (X3, Y3, Z3)


def _sel2(c, a, b):
    return (torch.where(c[..., None], a[0], b[0]), torch.where(c[..., None], a[1], b[1]))


def g2_add(p1, p2):
    """The complete addition over Fp2 (g1_add's mirror)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    inf1 = f2_is_zero(Z1)
    inf2 = f2_is_zero(Z2)
    Z1sq = f2_sqr(Z1)
    Z2sq = f2_sqr(Z2)
    U1 = f2_mul(X1, Z2sq)
    U2 = f2_mul(X2, Z1sq)
    Z2cu = f2_mul(Z2, Z2sq)
    Z1cu = f2_mul(Z1, Z1sq)
    S1 = f2_mul(Y1, Z2cu)
    S2 = f2_mul(Y2, Z1cu)
    H = f2_sub(U2, U1)
    r = f2_sub(S2, S1)
    same_x = f2_is_zero(H)
    same_y = f2_is_zero(r)
    Hsq = f2_sqr(H)
    Hcu = f2_mul(H, Hsq)
    V = f2_mul(U1, Hsq)
    rsq = f2_sqr(r)
    X3 = f2_sub(f2_sub(rsq, Hcu), f2_add(V, V))
    Y3 = f2_sub(f2_mul(r, f2_sub(V, X3)), f2_mul(S1, Hcu))
    Z3 = f2_mul(f2_mul(Z1, Z2), H)
    dX, dY, dZ = g2_double(p1)
    is_dbl = same_x & same_y & ~inf1 & ~inf2
    is_inf_out = same_x & ~same_y & ~inf1 & ~inf2
    X3 = _sel2(is_dbl, dX, X3)
    Y3 = _sel2(is_dbl, dY, Y3)
    Z3 = _sel2(is_dbl, dZ, Z3)
    Z3 = _sel2(is_inf_out, (torch.zeros_like(Z3[0]), torch.zeros_like(Z3[1])), Z3)
    X3 = _sel2(inf1, X2, _sel2(inf2, X1, X3))
    Y3 = _sel2(inf1, Y2, _sel2(inf2, Y1, Y3))
    Z3 = _sel2(inf1, Z2, _sel2(inf2, Z1, Z3))
    return (X3, Y3, Z3)


def g2_scalar_mul_batch(pt, bits):
    """[z]Q per item over `bits`, 2-bit fixed windows (:957)."""
    digits = _digits(bits)
    n_windows = digits.shape[-1]
    X, Y, Z = pt
    inf = tuple((torch.zeros_like(c[0]), torch.zeros_like(c[1])) for c in (X, Y, Z))
    q2 = g2_double(pt)
    table = [inf, pt, q2, g2_add(q2, pt)]
    tab = tuple((torch.stack([t[i][0] for t in table]), torch.stack([t[i][1] for t in table]))
                for i in range(3))

    def gather(w):
        return tuple((_gather_window(c[0], digits, w), _gather_window(c[1], digits, w))
                     for c in tab)

    acc = gather(n_windows - 1)
    for i in range(n_windows - 1):
        w = n_windows - 2 - i
        acc = g2_double(g2_double(acc))
        acc = g2_add(acc, gather(w))
    return acc


def g2_sum_reduce(pts):
    """Tree sum of a (N, ...) batch of Jacobian G2 points."""
    X, Y, Z = pts

    def take(c, sl):
        return (c[0][sl], c[1][sl])

    def cat_last(s, c):
        return (torch.cat([s[0], c[0][-1:]]), torch.cat([s[1], c[1][-1:]]))

    n = X[0].shape[0]
    while n > 1:
        half = n // 2
        ev = slice(None, 2 * half, 2)
        od = slice(1, 2 * half, 2)
        sX, sY, sZ = g2_add((take(X, ev), take(Y, ev), take(Z, ev)),
                           (take(X, od), take(Y, od), take(Z, od)))
        if n % 2:
            sX, sY, sZ = cat_last(sX, X), cat_last(sY, Y), cat_last(sZ, Z)
        X, Y, Z = sX, sY, sZ
        n = X[0].shape[0]
    return (X[0][0], X[1][0]), (Y[0][0], Y[1][0]), (Z[0][0], Z[1][0])


def g2_jacobian_to_affine(pt):
    X, Y, Z = pt
    zinv = f2_inv(Z)
    zinv2 = f2_sqr(zinv)
    return f2_mul(X, zinv2), f2_mul(Y, f2_mul(zinv, zinv2))


# --- the randomized batch check (:768, :1053-1250) -----------------------------------

_NEG_G1 = (F.to_mont(oracle.G1_GEN_AFF[0]), F.to_mont((-oracle.G1_GEN_AFF[1]) % P))


def _neg_g1_affine_mont(like):
    return _on(_NEG_G1[0], like), _on(_NEG_G1[1], like)


def f12_prod_reduce(f):
    """Tree product of a batch of Fp12 values over the leading axis."""
    n = f[0][0].shape[0]
    while n > 1:
        half = n // 2
        even = tuple((c[0][: 2 * half : 2], c[1][: 2 * half : 2]) for c in f)
        odd = tuple((c[0][1 : 2 * half : 2], c[1][1 : 2 * half : 2]) for c in f)
        prod = f12_mul(even, odd)
        if n % 2:
            prod = tuple((torch.cat([c[0], f[k][0][-1:]]), torch.cat([c[1], f[k][1][-1:]]))
                         for k, c in enumerate(prod))
        f = prod
        n = f[0][0].shape[0]
    return f


def pairing_cube_batch(qx, qy, px, py):
    """e(P, Q)^3 per item."""
    return final_exponentiation_batch(miller_loop_batch(qx, qy, px, py))


def pairing_check_batch(qx, qy, px, py, q2x, q2y, p2x, p2y):
    """Per item e(P1, Q1)·e(P2, Q2) == 1: (...) bool (:768)."""
    m1 = miller_loop_batch(qx, qy, px, py)
    m2 = miller_loop_batch(q2x, q2y, p2x, p2y)
    return f12_is_one(final_exponentiation_batch(f12_mul(m1, m2)))


def pairing_check_rlc(qx, qy, px, py, q2x, q2y, p2x, p2y, zbits, p2_is_neg_g1: bool = False,
                      seg_ids=None):
    """The randomized batch check with one shared final exponentiation
    (:1080): prod_i e(z_i·P1_i, Q1_i)·e(z_i·P2_i, Q2_i) == 1 for the host's
    (N, 64) bool scalars `zbits`. `p2_is_neg_g1` (every P2 is -G1, as the
    BLS checks are) collapses the second set by bilinearity into
    e(-G1, sum_i z_i·Q2_i); `seg_ids` (N,) (with it) groups the first set
    by distinct message, Q1 then holding the D distinct H(m): D + 1 Miller
    loops. Returns a 0-d bool. An empty segment sums to infinity, which this
    check, as JAX's, does not fail by itself (ROADMAP C2): callers give
    every segment a member."""
    if seg_ids is not None:
        assert p2_is_neg_g1, "the grouped check needs the collapsed -G1 side"
        num_segments = qx[0].shape[0]
        a1x, a1y = rlc_collapse_g1_by_message(px, py, zbits, seg_ids, num_segments)
        m1 = miller_loop_batch(qx, qy, a1x, a1y)
        aqx, aqy = rlc_collapse_g2(q2x, q2y, zbits)
        ngx, ngy = _neg_g1_affine_mont(px)
        m2 = miller_loop_batch(aqx, aqy, ngx, ngy)
        return rlc_tail(m1, m2)
    a1x, a1y = rlc_randomize_g1(px, py, zbits)
    m1 = miller_loop_batch(qx, qy, a1x, a1y)
    if p2_is_neg_g1:
        aqx, aqy = rlc_collapse_g2(q2x, q2y, zbits)
        ngx, ngy = _neg_g1_affine_mont(px)
        m2 = miller_loop_batch(aqx, aqy, ngx, ngy)
        return rlc_tail(m1, m2)
    z2 = g1_scalar_mul_batch((p2x, p2y, _one(px)), zbits)
    a2x, a2y = _g1_jacobian_to_affine_batch(z2)
    m2 = miller_loop_batch(q2x, q2y, a2x, a2y)
    prod = f12_prod_reduce(f12_mul(m1, m2))
    single = tuple((c[0][0], c[1][0]) for c in prod)
    return f12_is_one(final_exponentiation_batch(single))


def rlc_randomize_g1(px, py, zbits):
    """Stage 1: [z_i]·P1_i, affine out."""
    z1 = g1_scalar_mul_batch((px, py, _one(px)), zbits)
    return _g1_jacobian_to_affine_batch(z1)


def rlc_collapse_g2(q2x, q2y, zbits):
    """Stage 2: sum_i [z_i]·sig_i, affine out."""
    one = _one(q2x[0])
    zsig = g2_scalar_mul_batch((q2x, q2y, (one, torch.zeros_like(one))), zbits)
    return g2_jacobian_to_affine(g2_sum_reduce(zsig))


def g1_segment_sum(pts, seg_ids, num_segments, first_segment=0):
    """out[d] = the sum of the points with seg_ids == first_segment + d: the
    masked (N, D) tree of :1172, non-members entering as Z = 0."""
    X, Y, Z = pts
    n = X.shape[0]
    segs = torch.arange(num_segments, dtype=seg_ids.dtype, device=seg_ids.device) + first_segment
    mask = seg_ids[:, None] == segs[None, :]
    shape = (n, num_segments) + tuple(X.shape[1:])
    Xb = X[:, None].expand(shape)
    Yb = Y[:, None].expand(shape)
    Zb = torch.where(mask[..., None], Z[:, None].expand(shape), torch.zeros_like(Z[:, None]))
    return g1_sum_reduce((Xb, Yb, Zb))


def rlc_collapse_g1_by_message(px, py, zbits, seg_ids, num_segments, first_segment=0):
    """Stage 1, grouped: [z_i]·pk_i, then a sum per distinct message ->
    (D,) affine points."""
    z1 = g1_scalar_mul_batch((px, py, _one(px)), zbits)
    seg = g1_segment_sum(z1, seg_ids, num_segments, first_segment)
    return _g1_jacobian_to_affine_batch(seg)


def rlc_tail(m1, m2_single):
    """Stage 3: the tree product of the batched Miller values times the
    single one, one shared final exponentiation, is_one."""
    prod = f12_prod_reduce(m1)
    single = tuple((c[0][0], c[1][0]) for c in prod)
    return f12_is_one(final_exponentiation_batch(f12_mul(single, m2_single)))


# --- host bridging ---------------------------------------------------------------------


def f12_from_tensors(f) -> list:
    """Fp12 tuples of (..., 64) residues -> oracle Fp12 tuples, flattened over
    the batch (canonical ints)."""
    coeffs = [(F.mont_batch_to_ints(c[0]), F.mont_batch_to_ints(c[1])) for c in f]
    n = len(coeffs[0][0])
    return [tuple((coeffs[k][0][i], coeffs[k][1][i]) for k in range(6)) for i in range(n)]


# --- the flush's packed layout ---------------------------------------------------------
#
# crypto/bls_torch.py packs a flush once, in ops/bls12.py's layout: Q (B, 2, 2, w),
# P (B, 2, w), scalars as (B, 2) int32 words; `pack_mont` is the "rns" backend's
# packing (ops/bls12.FIELD_BACKENDS), and the helpers below carry that layout into
# this module's tuples and JAX's bit form.


def pack_mont(ints, device) -> torch.Tensor:
    """Canonical ints -> (n, 64) RNS Montgomery residues on `device`, packed on
    the host in one `ints_to_mont_batch`."""
    return torch.from_numpy(F.ints_to_mont_batch(list(ints))).to(device)


def zbits_to_bits(zbits: torch.Tensor) -> torch.Tensor:
    """(n, 2) int32 scalar words (low word first) -> (n, 64) bool, least
    significant bit first: the JAX package's `zbits` form."""
    shifts = torch.arange(32, device=zbits.device)
    words = zbits.to(torch.int64) & 0xFFFFFFFF
    return ((words[..., None] >> shifts) & 1).reshape(*zbits.shape[:-1], 64).bool()


def g2_pair(q):
    """(n, 2, 2, w) -> ((x0, x1), (y0, y1))."""
    return (q[:, 0, 0], q[:, 0, 1]), (q[:, 1, 0], q[:, 1, 1])


def g1_pair(p):
    """(n, 2, w) -> (x, y)."""
    return p[:, 0], p[:, 1]
