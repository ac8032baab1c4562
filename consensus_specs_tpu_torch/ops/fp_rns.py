"""The BLS12-381 base field Fp in a residue number system (counterpart of
ops/fp_rns.py, the JAX package's default field backend).

Representation, as the JAX package keeps it: an element is (..., 64) int32,
its residues modulo 64 fixed 15-bit primes (`_gen_primes`, the largest below
2^15 - 128 and above 2^15 - 2^10); the first 32 form base A (product M_A),
the last 32 base B (M_B). Montgomery form with R = M_A: x is stored as the
residues of x·M_A mod p. Values are signed and redundant: a channel vector
stands for one integer that may exceed p or be negative (`fp_sub` is a plain
per-channel a + (m - b)), a Montgomery product lands in (-p/2^9, 3p), and
equality is never a residue compare: `fp_is_zero` / `fp_is_one_mont` shrink
(a product by ONE_MONT) and compare with the residue vectors of the classes
{0, p, 2p} / {R, R + p, R + 2p}. Nothing here canonicalises a residue
vector to [0, p).

A Montgomery product (Bajard-Kawamura): t = x·y per channel; q = -t·p^-1 in
base A; q extended to base B through sigma_i = q_i·(M_A/a_i)^-1 mod a_i, the
constant matrix C[i][j] = (M_A/a_i) mod b_j and alpha = floor(sum_i
sigma_i/a_i - 1/4), the sum in float32; r = (t + q·p)/M_A in base B; r
extended back to base A the same way with offset +1/4, which is exact.

Kernel K24 `rns_ops` (csrc/fp_rns.cu, the field in csrc/fp_rns.cuh, its
constants in the generated csrc/rns_constants.cuh) computes every op by op
code, one warp an element (lane c holds residues c and 32 + c): add, sub,
neg, mul_wide, mont_reduce, mont_mul, the power ladders for p - 2 and
(p + 1)/4 (one launch each), sum_stack (k <= 8), is_zero and is_one_mont.
`rns_ops` launches it for CUDA tensors and runs `rns_ops_plain` for CPU
tensors; a build, load or launch failure raises `kernels/build.KernelError`.
`OP_LAUNCHES` counts the launches by op code. The same device field runs
inside the BLS kernels K9-K12 (their RNS instances, ops/bls12.py), whose
plain version calls `rns_ops_plain` field op by field op; `plain_muls`
counts its Montgomery products.

The plain version computes in int64 (torch on the CPU has no unsigned
shifts) and copies the JAX package's fold-and-subtract reductions `_fold` /
`_red_full` / `_red_small`; it sums each base extension's 32 products in
int64 as the kernel does (JAX splits them into four int8 matmuls, which gives
the same canonical residue; the card-only tests and the smoke hold the
kernel and the plain version bit-equal). Both sum alpha's 32 float32 terms in channel order
0..31 (the kernel on every lane, with `__fmul_rn` / `__fadd_rn`, never
fused). `check_windows()` asserts the windows csrc/fp_rns.cuh states on
every plain reduction.

The contract with the JAX package (tests/test_torch_fp_rns.py,
tests/test_torch_bls12_field.py):
- K24 against `rns_ops_plain`, on the card: bit-equal, channel for channel,
  at every op code.
- This module against JAX's `fp_rns`, on the CPU: add, sub, neg, mul_wide
  and sum_stack are channel-equal; mont_reduce, mont_mul and the power
  ladder are equal mod p always, and channel-equal or different by exactly
  p's residue vector; is_zero and is_one_mont are equal. The one source of
  difference: JAX does not sum alpha's terms in channel order, so where
  q/M_A lies within float32 error of 1/4 the first extension can take the
  other floor, and the product is r + p instead of r (ROADMAP C7).
- ops/bls12_field.py against JAX's towers on this field: equal mod p, every
  boolean equal.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from ..kernels import build
from ..utils.device import is_cpu

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

K_PER_BASE = 32
NLIMBS = 2 * K_PER_BASE  # interface name: the trailing dim of an element
LIMB_BITS = 15
TWO15 = 1 << 15
SUPPORTS_WIDE = True


def _gen_primes(lo: int, hi: int, count: int) -> list[int]:
    """The largest `count` primes in (lo, hi), descending (numpy sieve)."""
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(hi**0.5) + 1):
        if sieve[i]:
            sieve[i * i :: i] = False
    primes = np.nonzero(sieve)[0]
    primes = primes[(primes > lo) & (primes < hi)][::-1][:count]
    assert len(primes) == count, f"only {len(primes)} primes in ({lo}, {hi})"
    return [int(q) for q in primes]


# residues <= 32511 keep the balanced int8 split in range; delta = 2^15 - m
# < 2^10 makes the folds converge
_PRIMES = _gen_primes(TWO15 - (1 << 10), TWO15 - 128, NLIMBS)
A_PRIMES = _PRIMES[:K_PER_BASE]
B_PRIMES = _PRIMES[K_PER_BASE:]
M_A = int(np.prod([int(q) for q in A_PRIMES], dtype=object))
M_B = int(np.prod([int(q) for q in B_PRIMES], dtype=object))
assert int((M_A // P) ** 0.5) > 2**40 and M_B > 1 << 400

_M_ALL = np.asarray(_PRIMES, dtype=np.int32)
_DELTA = (TWO15 - _M_ALL).astype(np.int32)  # 2^15 mod m
_MA = np.asarray(A_PRIMES, dtype=np.int32)
_MB = np.asarray(B_PRIMES, dtype=np.int32)


def _residues(x: int, moduli) -> np.ndarray:
    return np.asarray([x % int(m) for m in moduli], dtype=np.int32)


def _split8(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Entries < 2^15 -> balanced int8 halves (hi, lo), v = hi·256 + lo."""
    hi = (mat + 128) >> 8
    lo = mat - (hi << 8)
    assert hi.max() <= 127 and lo.min() >= -128 and lo.max() <= 127
    return hi.astype(np.int8), lo.astype(np.int8)


class _Ext:
    """Constants of one base extension (source base -> destination base)."""

    def __init__(self, src_primes, dst_primes, m_src_prod):
        # sigma_i = q_i·(M/m_i)^-1 mod m_i
        self.w_inv = np.asarray([pow(m_src_prod // m, -1, m) for m in src_primes],
                                dtype=np.int32)
        # C[i][j] = (M/m_i) mod dst_j
        self.C = np.asarray([[(m_src_prod // mi) % mj for mj in dst_primes]
                             for mi in src_primes], dtype=np.int64)
        self.C_hi, self.C_lo = _split8(self.C)
        self.m_src_prod_mod_dst = _residues(m_src_prod, dst_primes)
        self.inv_src_f32 = (1.0 / np.asarray(src_primes)).astype(np.float32)
        self.dst_m = np.asarray(dst_primes, dtype=np.int32)
        self.dst_delta = (TWO15 - self.dst_m).astype(np.int32)


_EXT_AB = _Ext(A_PRIMES, B_PRIMES, M_A)
_EXT_BA = _Ext(B_PRIMES, A_PRIMES, M_B)

_NEG_PINV_A = np.asarray([(-pow(P, -1, m)) % m for m in A_PRIMES], dtype=np.int32)
_P_MOD_B = _residues(P, B_PRIMES)
_MAINV_MOD_B = np.asarray([pow(M_A % m, -1, m) for m in B_PRIMES], dtype=np.int32)

R_MOD_P = M_A % P
ONE_MONT = _residues(R_MOD_P, _PRIMES)  # to_mont(1)
ZERO = np.zeros(NLIMBS, dtype=np.int32)

# a shrunk value lies in (-p/2^9, 3p); its class mod p below 3p is one of
# {v, v + p, v + 2p}
_ZERO_CLASSES = np.stack([_residues(i * P, _PRIMES) for i in range(3)])
_ONE_CLASSES = np.stack([_residues(R_MOD_P + i * P, _PRIMES) for i in range(3)])

EXP_INV = P - 2
EXP_SQRT = (P + 1) // 4

# K24 op codes (csrc/fp_rns.cu)
(OP_ADD, OP_SUB, OP_NEG, OP_MUL_WIDE, OP_MONT_REDUCE, OP_MONT_MUL, OP_POW_INV, OP_POW_SQRT,
 OP_SUM_STACK, OP_IS_ZERO, OP_IS_ONE) = range(11)
OP_NAMES = ("add", "sub", "neg", "mul_wide", "mont_reduce", "mont_mul", "pow_inv", "pow_sqrt",
            "sum_stack", "is_zero", "is_one_mont")
_BINARY = (OP_ADD, OP_SUB, OP_MUL_WIDE, OP_MONT_MUL)
_PREDICATES = (OP_IS_ZERO, OP_IS_ONE)

OP_LAUNCHES: Counter = Counter()  # K24 launches by op name (CUDA tensors only)
plain_muls = 0  # Montgomery products the plain version computed (elements)


# --- host codecs -------------------------------------------------------------

# 2^(16k) mod m for the 24 sixteen-bit limbs of a value below 2^384
_POW16 = np.asarray([[pow(2, 16 * k, int(m)) for m in _PRIMES] for k in range(24)],
                    dtype=np.int64)


def _residues_batch(xs) -> np.ndarray:
    """(n, 64) int32 residues of the ints xs (each in [0, 2^384))."""
    buf = b"".join(int(x).to_bytes(48, "little") for x in xs)
    limbs = np.frombuffer(buf, dtype="<u2").astype(np.int64).reshape(-1, 24)
    return ((limbs @ _POW16) % _M_ALL.astype(np.int64)).astype(np.int32)


def to_mont(x: int) -> np.ndarray:
    return _residues((x % P) * M_A % P, _PRIMES)


def int_to_limbs(x: int) -> np.ndarray:
    """Plain (non-Montgomery) residues."""
    return _residues(x, _PRIMES)


def limbs_to_int(limbs) -> int:
    """CRT from the base-A half (exact for values below M_A)."""
    res = np.asarray(limbs, dtype=np.int64).reshape(-1)[:K_PER_BASE]
    acc = 0
    for i, m in enumerate(A_PRIMES):
        w = M_A // m
        acc += int(res[i]) * pow(w, -1, m) % m * w
    return acc % M_A


def from_mont_int(limbs) -> int:
    """The canonical int of one element; the top half of [0, M_A) stands for
    negative values."""
    v = limbs_to_int(limbs)
    if v > M_A // 2:
        v -= M_A
    return v * pow(M_A, -1, P) % P


def ints_to_mont_batch(xs) -> np.ndarray:
    """Ints -> (n, 64) int32 Montgomery residues (host, vectorised)."""
    xs = list(xs)
    if not xs:
        return np.zeros((0, NLIMBS), np.int32)
    return _residues_batch([(int(x) % P) * M_A % P for x in xs])


def mont_batch_to_ints(arr) -> list:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr).reshape(-1, NLIMBS)
    return [from_mont_int(a[i]) for i in range(a.shape[0])]


# --- the plain version (int64) -----------------------------------------------

_CONSTS: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _CONSTS:
        arrays = {
            "m": _M_ALL, "mA": _MA, "mB": _MB, "neg_pinv_a": _NEG_PINV_A, "p_mod_b": _P_MOD_B,
            "mainv_mod_b": _MAINV_MOD_B, "one": ONE_MONT, "zero_classes": _ZERO_CLASSES,
            "one_classes": _ONE_CLASSES}
        for tag, ext in (("ab", _EXT_AB), ("ba", _EXT_BA)):
            arrays.update({f"{tag}_w_inv": ext.w_inv, f"{tag}_C": ext.C,
                           f"{tag}_mmod": ext.m_src_prod_mod_dst,
                           f"{tag}_m": ext.dst_m, f"{tag}_delta": ext.dst_delta})
        if name.endswith("_inv_f32"):
            ext = _EXT_AB if name.startswith("ab") else _EXT_BA
            _CONSTS[key] = torch.from_numpy(ext.inv_src_f32.copy()).to(device)
        else:
            _CONSTS[key] = torch.from_numpy(np.asarray(arrays[name], np.int64)).to(device)
    return _CONSTS[key]


def _fold(x, m):
    """One step of x mod m through 2^15 = delta = 2^15 - m: JAX's
    (x >> 15)·delta + (x & 32767), which is the integer x - (x >> 15)·m."""
    return torch.addcmul(x, x >> LIMB_BITS, m, value=-1)


def _cond_sub(x, m):
    return torch.where(x >= m, x - m, x)


def _red_full(x, m):
    """x in [0, 2^31) -> x mod m: four folds and one conditional subtract."""
    for _ in range(4):
        x = _fold(x, m)
    return _cond_sub(x, m)


def _red_small(x, m):
    """x in [0, ~2^18) -> x mod m: two folds and one conditional subtract."""
    return _cond_sub(_fold(_fold(x, m), m), m)


def _alpha(sigma, inv, offset: float):
    """floor(sum_i sigma_i·inv_i + offset), the sum in float32 in channel
    order 0..31 (K24's order)."""
    first, *rest = (sigma.to(torch.float32) * inv).T.contiguous().unbind(0)
    acc = first
    for term in rest:
        acc = acc + term
    return torch.floor(acc + offset).to(torch.int64)


def _extend(sigma, tag: str, offset: float):
    """sum_i sigma_i·(M/m_i) - alpha·M in the destination base, canonical
    (ops/fp_rns.py:255): the 32 products summed exactly (each below 2^30, the
    sum below 2^35: a float64 matmul is exact, on either device) and folded
    as the kernel does; JAX splits them into four int8 products for the MXU,
    which reaches the same canonical residue."""
    dev = sigma.device
    m = _const(f"{tag}_m", dev)
    acc = (sigma.double() @ _const(f"{tag}_C", dev).double()).long()
    v = _red_full((acc >> LIMB_BITS) * (TWO15 - m) + (acc & (TWO15 - 1)), m)
    alpha = _alpha(sigma, _const(f"{tag}_inv_f32", dev), offset)
    v = v + (m << 11) - alpha[:, None] * _const(f"{tag}_mmod", dev)
    return _red_full(v, m)


# --- the windows of csrc/fp_rns.cuh, checked ---------------------------------
#
# Inside `check_windows()` (off by default) every plain `_mont_reduce`
# decodes its input t by CRT over both bases as the signed integer T in
# (-M/2, M/2) and asserts -p·M_A/2^9 < T < p·M_A (the result window), and
# decodes its result r over each base apart: the two must be one integer
# (the second extension exact) in (-p/2^9, 3p). `window_checks` counts the
# elements checked.

_M_AB = M_A * M_B
_CRT = {"all": ([(_M_AB // m) * pow(_M_AB // m, -1, m) for m in _PRIMES], _M_AB),
        "a": ([(M_A // m) * pow(M_A // m, -1, m) for m in A_PRIMES], M_A),
        "b": ([(M_B // m) * pow(M_B // m, -1, m) for m in B_PRIMES], M_B)}
_checking = False
window_checks = 0


@contextmanager
def check_windows():
    """Within: assert the mont_reduce windows on every plain reduction."""
    global _checking
    saved, _checking = _checking, True
    try:
        yield
    finally:
        _checking = saved


def _signed_crt(res, base: str = "all") -> list:
    """(N, k) residues over base "a", "b" or "all" (64 channels) -> the
    signed integers they stand for, in (-M/2, M/2)."""
    weights, modulus = _CRT[base]
    out = []
    for row in res.tolist():
        v = sum(r * w for r, w in zip(row, weights)) % modulus
        out.append(v - modulus if v > modulus // 2 else v)
    return out


def _assert_windows(t, r) -> None:
    global window_checks
    lo, hi = -(P * M_A) // 2**9, P * M_A
    for x, ra, rb in zip(_signed_crt(t), _signed_crt(r[:, :K_PER_BASE], "a"),
                         _signed_crt(r[:, K_PER_BASE:], "b")):
        assert lo < x < hi, f"mont_reduce input {x} outside (-p·M_A/2^9, p·M_A)"
        assert ra == rb, f"mont_reduce: base A says {ra}, base B {rb}: extension inexact"
        assert -P // 2**9 < ra < 3 * P, f"mont_reduce result {ra} outside (-p/2^9, 3p)"
    window_checks += t.shape[0]


def _mont_reduce(t):
    """t -> t·M_A^-1 (mod p) in (-p/2^9, 3p); t (N, 64) int64 residues."""
    out = _mont_reduce_unchecked(t)
    if _checking:
        _assert_windows(t, out)
    return out


def _mont_reduce_unchecked(t):
    dev = t.device
    mA, mB = _const("mA", dev), _const("mB", dev)
    tA, tB = t[:, :K_PER_BASE], t[:, K_PER_BASE:]
    q = _red_full(tA * _const("neg_pinv_a", dev), mA)
    sigma = _red_full(q * _const("ab_w_inv", dev), mA)
    q_hat = _extend(sigma, "ab", -0.25)  # alpha may fall short by 1: r + p
    u = _red_full(tB + _red_full(q_hat * _const("p_mod_b", dev), mB), mB)
    r_b = _red_full(u * _const("mainv_mod_b", dev), mB)
    sigma2 = _red_full(r_b * _const("ba_w_inv", dev), mB)
    r_a = _extend(sigma2, "ba", 0.25)  # exact: |r| < 3p << M_B
    return torch.cat([r_a, r_b], -1)


def _mul_wide(x, y):
    return _red_full(x * y, _const("m", x.device))


def _mont_mul(x, y):
    global plain_muls
    plain_muls += x.shape[0]
    return _mont_reduce(_mul_wide(x, y))


def _pow(a, exponent: int):
    """a^exponent by the ladder of ops/fp_rns.py:325 from the top bit (the
    product is computed only where the bit is set: the same values as
    computing it always and selecting)."""
    acc = _const("one", a.device).expand_as(a)
    for bit in bin(exponent)[2:]:
        acc = _mont_mul(acc, acc)
        if bit == "1":
            acc = _mont_mul(acc, a)
    return acc


def _in_classes(a, name: str):
    small = _mont_mul(a, _const("one", a.device).expand_as(a))
    return (small[:, None, :] == _const(name, a.device)).all(-1).any(-1)


def rns_ops_plain(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K24: a (M, 64) int32 (b of the same shape for the
    binary ops; a (k, M, 64) for sum_stack) -> (M, 64) int32, or (M,) bool
    for is_zero / is_one_mont."""
    x = a.to(torch.int64)
    m = _const("m", a.device)
    if op == OP_ADD:
        out = _cond_sub(x + b.to(torch.int64), m)
    elif op == OP_SUB:
        out = _cond_sub(x + (m - b.to(torch.int64)), m)
    elif op == OP_NEG:
        out = _cond_sub(m - x, m)
    elif op == OP_MUL_WIDE:
        out = _mul_wide(x, b.to(torch.int64))
    elif op == OP_MONT_REDUCE:
        out = _mont_reduce(x)
    elif op == OP_MONT_MUL:
        out = _mont_mul(x, b.to(torch.int64))
    elif op in (OP_POW_INV, OP_POW_SQRT):
        out = _pow(x, EXP_INV if op == OP_POW_INV else EXP_SQRT)
    elif op == OP_SUM_STACK:
        out = _red_small(x.sum(0), m)
    elif op == OP_IS_ZERO:
        return _in_classes(x, "zero_classes")
    elif op == OP_IS_ONE:
        return _in_classes(x, "one_classes")
    else:
        raise ValueError(f"rns_ops: unknown op code {op}")
    return out.to(torch.int32)


# --- K24 ------------------------------------------------------------------------


def rns_ops(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """One RNS field op by op code over M elements: a (M, 64) int32 residues
    (b the same for add, sub, mul_wide, mont_mul; a (k, M, 64) with k <= 8
    for sum_stack). Returns (M, 64) int32, or (M,) bool for is_zero and
    is_one_mont. Kernel K24 on CUDA (nothing launched for M = 0), the plain
    version on the CPU."""
    if not 0 <= op < len(OP_NAMES):
        raise ValueError(f"rns_ops: unknown op code {op}")
    dims = 3 if op == OP_SUM_STACK else 2
    if a.dtype != torch.int32 or a.dim() != dims or a.shape[-1] != NLIMBS:
        raise ValueError(f"rns_ops {OP_NAMES[op]} takes a {'(k, M, 64)' if dims == 3 else '(M, 64)'}"
                         f" int32 tensor, got {tuple(a.shape)} {a.dtype}")
    if op == OP_SUM_STACK and not 1 <= a.shape[0] <= 8:
        raise ValueError(f"rns_ops sum_stack sums 1 to 8 values, got {a.shape[0]}")
    if op in _BINARY:
        if b is None or b.dtype != torch.int32 or b.shape != a.shape or b.device != a.device:
            raise ValueError(f"rns_ops {OP_NAMES[op]}: b must be int32 of a's shape on a's device")
    if is_cpu(a):
        return rns_ops_plain(op, a, b)
    a = a.contiguous()
    b = a if b is None else b.contiguous()
    n = a.shape[-2]
    if op in _PREDICATES:
        out = torch.empty(n, dtype=torch.bool, device=a.device)
    else:
        out = torch.empty((n, NLIMBS), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    fn = build.entry("fp_rns", "rns_ops", 3, 2)
    build.count_launch("rns_ops")
    OP_LAUNCHES[OP_NAMES[op]] += 1
    build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, op,
                   a.shape[0] if op == OP_SUM_STACK else 1, build.stream_ptr(a)), "rns_ops")
    return out


# --- the interface the towers call the field with (JAX's `F`) ------------------


def _flat(*xs):
    xs = torch.broadcast_tensors(*xs)
    return xs[0].shape, [x.reshape(-1, NLIMBS) for x in xs]


def _unary(op, a):
    shape, (x,) = _flat(a)
    return rns_ops(op, x).reshape(shape)


def _binary(op, a, b):
    shape, (x, y) = _flat(a, b)
    return rns_ops(op, x, y).reshape(shape)


def fp_add(a, b):
    return _binary(OP_ADD, a, b)


def fp_sub(a, b):
    """The signed integer a - b, channel by channel (no normalisation)."""
    return _binary(OP_SUB, a, b)


def fp_neg(a):
    return _unary(OP_NEG, a)


def fp_mul_wide(x, y):
    """Per-channel product, not Montgomery-reduced: stands for the integer
    x·y (double Montgomery scale); `fp_mont_reduce` brings it back."""
    return _binary(OP_MUL_WIDE, x, y)


def fp_mont_reduce(t):
    return _unary(OP_MONT_REDUCE, t)


def fp_mont_mul(x, y):
    return _binary(OP_MONT_MUL, x, y)


def fp_mont_sqr(a):
    return _binary(OP_MONT_MUL, a, a)


def fp_pow_const(a, exponent: int):
    """a^exponent for the two exponents the kernel holds: p - 2, (p + 1)/4."""
    ops = {EXP_INV: OP_POW_INV, EXP_SQRT: OP_POW_SQRT}
    if exponent not in ops:
        raise ValueError("fp_pow_const: K24 holds the exponents p - 2 and (p + 1)/4 only")
    return _unary(ops[exponent], a)


def fp_inv(a):
    """Fermat a^(p-2), one launch; zero maps to zero."""
    return _unary(OP_POW_INV, a)


def fp_sqrt_candidate(a):
    """a^((p+1)/4): the square root where a is a square (p = 3 mod 4)."""
    return _unary(OP_POW_SQRT, a)


def fp_sum_stack(arr, axis: int = 0):
    """Sum of at most 8 channel-reduced values along `axis`."""
    arr = torch.movedim(arr, axis, 0)
    k, shape = arr.shape[0], arr.shape[1:]
    return rns_ops(OP_SUM_STACK, arr.reshape(k, -1, NLIMBS)).reshape(shape)


def _predicate(op, a):
    shape, (x,) = _flat(a)
    return rns_ops(op, x).reshape(shape[:-1])


def fp_is_zero(a):
    """(...) bool: a = 0 (mod p), for any channel-reduced element."""
    return _predicate(OP_IS_ZERO, a)


def fp_is_one_mont(a):
    """(...) bool: a is the Montgomery 1 (value = R mod p)."""
    return _predicate(OP_IS_ONE, a)


# --- csrc/rns_constants.cuh -----------------------------------------------------


def cuda_constants_header() -> str:
    """The text of csrc/rns_constants.cuh, generated from these constants (a
    test holds the committed file equal to it)."""
    from ..crypto import bls12_381 as oracle

    def ints(a):
        return "{" + ", ".join(str(int(v)) for v in np.asarray(a).reshape(-1)) + "}"

    def f32_bits(a):
        return "{" + ", ".join(f"0x{int(v):08x}u" for v in
                               np.asarray(a, np.float32).view(np.uint32)) + "}"

    def words(x):
        return "{" + ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(12)) + "}"

    gamma1 = [oracle.f2_pow(oracle.XI, i * (P - 1) // 6) for i in range(6)]
    gamma2 = [oracle.f2_mul(oracle.f2_conj(g), g) for g in gamma1]

    def gammas(gs):
        return ints(np.stack([np.stack([to_mont(g[0]), to_mont(g[1])]) for g in gs]))

    ext_rows = []
    for tag, ext in (("AB", _EXT_AB), ("BA", _EXT_BA)):
        ext_rows += [
            f"__device__ const int RNS_{tag}_WINV[32] = {ints(ext.w_inv)};",
            f"// C[i][j] = (M_src / m_i) mod dst_j, row-major by source channel i",
            f"__device__ const int RNS_{tag}_C[1024] = {ints(ext.C)};",
            f"__device__ const int RNS_{tag}_MMOD[32] = {ints(ext.m_src_prod_mod_dst)};",
            f"// float32 bit patterns of 1 / m_i (numpy's float64 quotient rounded)",
            f"__device__ const unsigned RNS_{tag}_INV[32] = {f32_bits(ext.inv_src_f32)};"]
    body = "\n".join(ext_rows)
    return f"""// Generated by consensus_specs_tpu_torch.ops.fp_rns.cuda_constants_header();
// a test holds this file equal to its output. The RNS field's 64 primes
// (base A = channels 0..31, base B = 32..63), Montgomery R = M_A. The
// tables are global memory, read into shared memory by each kernel's
// prologue (fp_rns.cuh) or, the Frobenius constants, by each lane directly;
// the exponents, read at one address by a whole warp, are constant memory.
#pragma once

__device__ const int RNS_M[64] = {ints(_M_ALL)};
__device__ const int RNS_NEG_PINV_A[32] = {ints(_NEG_PINV_A)};
__device__ const int RNS_P_MOD_B[32] = {ints(_P_MOD_B)};
__device__ const int RNS_MAINV_MOD_B[32] = {ints(_MAINV_MOD_B)};
{body}
__device__ const int RNS_ONE_MONT[64] = {ints(ONE_MONT)};
__device__ const int RNS_ZERO_CLASSES[192] = {ints(_ZERO_CLASSES)};
__device__ const int RNS_ONE_CLASSES[192] = {ints(_ONE_CLASSES)};
// gamma1^k = xi^(k(p-1)/6) and gamma2^k = conj(gamma1^k)·gamma1^k, k = 0..5,
// Montgomery residues ([k][re, im][channel])
__device__ const int RNS_GAMMA1[6][2][64] = {gammas(gamma1)};
__device__ const int RNS_GAMMA2[6][2][64] = {gammas(gamma2)};
// exponents (plain integers, little-endian words): p - 2, (p + 1) / 4
__device__ __constant__ unsigned RNS_EXP_INV[12] = {words(EXP_INV)};
__device__ __constant__ unsigned RNS_EXP_SQRT[12] = {words(EXP_SQRT)};
#define RNS_EXP_INV_BITS {EXP_INV.bit_length()}
#define RNS_EXP_SQRT_BITS {EXP_SQRT.bit_length()}
"""


assert from_mont_int(to_mont(12345)) == 12345
assert from_mont_int(ONE_MONT) == 1
assert np.array_equal(ints_to_mont_batch([12345, 1]), np.stack([to_mont(12345), ONE_MONT]))
