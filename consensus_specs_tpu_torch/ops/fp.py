"""The BLS12-381 base field Fp in Montgomery form (counterpart of
ops/limb_mont.py `MontgomeryField` and ops/fp_jax.py).

Layouts. R = 2^384 in both, so a Montgomery value is the same integer
a·2^384 mod p in the JAX package's limbs and here, and every value is
canonical (in [0, p)): equality is a word compare.
- On the card and at every public boundary: (..., 12) int32, the bit
  patterns of twelve little-endian 32-bit words (`NWORDS`).
- The plain version: (..., 24) int64, sixteen-bit little-endian limbs
  (`NLIMBS`), as limb_mont.py keeps them. Products go into int64 columns
  below 2^37, so signed int64 is exact (torch on the CPU has no uint64 `+`
  or `>>`). `to_limbs` / `to_words` repack at the boundary.

The plain arithmetic is vectorised over the limbs: a product's columns come
from one outer product summed along its anti-diagonals, carries settle in
three shift passes and one carry-lookahead pass over the limbs packed as bits
of an int64, and the Montgomery reduction is REDC at full width
(m = T·(-p^-1) mod R). Every function takes any leading batch shape.

`plain_muls` counts the Fp products the plain version computes (elements,
not calls): the least-time bounds of the BLS kernels are that count times
the instructions of one product in K8's SASS.

Kernel K8 `fp_ops` (csrc/fp.cu) is the field on the card, elementwise by op
code; its wrapper `fp_ops` launches it for CUDA tensors and runs the plain
version for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..utils.device import is_cpu
from ..utils.u64 import words_i32

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
NWORDS = 12
NLIMBS = 24
MASK = 0xFFFF
R = 1 << 384
R_MOD_P = R % P
R2_MOD_P = R * R % P
N0_32 = (-pow(P, -1, 1 << 32)) % (1 << 32)  # the kernel's CIOS constant
NPRIME = (-pow(P, -1, R)) % R  # the plain version's full-width REDC constant

# K8 op codes (csrc/fp.cu)
OP_MUL, OP_SQR, OP_ADD, OP_SUB, OP_NEG, OP_INV, OP_SQRT = range(7)
_BINARY = (OP_MUL, OP_ADD, OP_SUB)

plain_muls = 0


# --- host codecs --------------------------------------------------------------


def int_to_words(x: int) -> np.ndarray:
    """(12,) uint32 little-endian words of 0 <= x < 2^384."""
    return np.frombuffer(int(x).to_bytes(48, "little"), dtype="<u4").astype(np.uint32)


def ints_to_words(xs) -> np.ndarray:
    """(n, 12) int32 word bit patterns of the ints xs (each < 2^384)."""
    buf = b"".join(int(x).to_bytes(48, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").astype(np.uint32).view(np.int32).reshape(-1, NWORDS)


def words_to_ints(arr) -> list[int]:
    """(..., 12) words (int32 or uint32, numpy or tensor) -> flat list of ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr).reshape(-1, NWORDS).view(np.uint32)).astype("<u4")
    return [int.from_bytes(row.tobytes(), "little") for row in a]


def to_mont(x: int) -> int:
    return x % P * R % P


def from_mont(x: int) -> int:
    return x * pow(R, -1, P) % P


def ints_to_mont_words(xs) -> np.ndarray:
    """Canonical ints -> (n, 12) int32 Montgomery words (host)."""
    return ints_to_words([to_mont(int(x)) for x in xs])


def mont_words_to_ints(arr) -> list[int]:
    """(..., 12) Montgomery words -> canonical ints (host)."""
    return [from_mont(x) for x in words_to_ints(arr)]


# --- words <-> limbs ------------------------------------------------------------


def to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., 12) int32 words -> (..., 24) int64 limbs."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([x & MASK, x >> 16], dim=-1).flatten(-2)


def to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 24) int64 limbs (each < 2^16) -> (..., 12) int32 words."""
    pairs = limbs.reshape(*limbs.shape[:-1], NWORDS, 2)
    return words_i32(pairs[..., 0] | (pairs[..., 1] << 16))


def int_to_limbs(x: int, n: int = NLIMBS) -> list[int]:
    return [(x >> (16 * i)) & MASK for i in range(n)]


def const_limbs(x: int, like: torch.Tensor, n: int = NLIMBS) -> torch.Tensor:
    """The constant x as an (n,) int64 limb tensor on like's device."""
    return torch.tensor(int_to_limbs(x, n), dtype=torch.int64, device=like.device)


# --- plain limb arithmetic ------------------------------------------------------

_POW2 = {}


def _pow2(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _POW2:
        _POW2[key] = torch.tensor([1 << i for i in range(n)], dtype=torch.int64, device=device)
    return _POW2[key]


def _lookahead(g: torch.Tensor, p: torch.Tensor):
    """Carry (or borrow) into each of n positions from generate bits g and
    propagate bits p (bool (..., n), n < 62), and the carry out of the top:
    the bits of (G|P) + G differ from G ^ (G|P) exactly where a carry
    arrives."""
    n = g.shape[-1]
    pw = _pow2(n, g.device)
    G = (g.to(torch.int64) * pw).sum(-1, keepdim=True)
    X = G | (p.to(torch.int64) * pw).sum(-1, keepdim=True)
    S = X + G
    carries = ((S ^ X ^ G) & pw) != 0
    return carries.to(torch.int64), (S >> n) & 1


def carry(t: torch.Tensor, n_out: int, passes: int = 3) -> torch.Tensor:
    """Nonnegative int64 columns (..., k), each below 2^41 (below 2^17 with
    passes=1) -> (..., n_out) limbs below 2^16 of the same integer mod
    2^(16·n_out)."""
    k = t.shape[-1]
    if k < n_out:
        t = torch.nn.functional.pad(t, (0, n_out - k))
    elif k > n_out:
        t = t[..., :n_out]  # columns at or above 2^(16·n_out) vanish mod it
    for _ in range(passes):  # < 2^41 -> < 2^16 + 2^25 -> < 2^16 + 2^9 + 1 -> <= 2^16
        hi = t >> 16
        t = (t & MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))
    c, _ = _lookahead(t > MASK, t == MASK)
    return (t + c) & MASK


def _product_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of two n-limb values: (..., 2n - 1), each
    below n·2^32 (the outer product skewed so that its anti-diagonals line
    up, then summed)."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    outer = torch.nn.functional.pad(a[..., :, None] * b[..., None, :], (0, n))
    skew = outer.flatten(-2)[..., : n * (2 * n - 1)].reshape(*a.shape[:-1], n, 2 * n - 1)
    return skew.sum(-2)


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(16·n) over n limbs, and the borrow out (1 where a < b)."""
    d = a - b
    borrow, out = _lookahead(d < 0, d == 0)
    return (d - borrow) & MASK, out[..., 0]


def _cond_sub_p(t: torch.Tensor) -> torch.Tensor:
    """t - p where t >= p, else t (t < 2p, canonical limbs)."""
    d, borrow = _sub_limbs(t, const_limbs(P, t))
    return torch.where(borrow[..., None] == 1, t, d)


def fp_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R^-1 mod p (REDC at full width)."""
    global plain_muls
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    # one batch axis: torch's CPU reductions over several small axes are slower
    t = carry(_product_cols(a.reshape(-1, NLIMBS), b.reshape(-1, NLIMBS)), 2 * NLIMBS)
    plain_muls += t.shape[0]
    m = carry(_product_cols(t[..., :NLIMBS], const_limbs(NPRIME, t)), NLIMBS)
    u = carry(torch.nn.functional.pad(_product_cols(m, const_limbs(P, t)), (0, 1)) + t,
              2 * NLIMBS + 1)
    return _cond_sub_p(u[..., NLIMBS:2 * NLIMBS]).reshape(shape)


def fp_sqr(a: torch.Tensor) -> torch.Tensor:
    return fp_mul(a, a)


def fp_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub_p(carry(a + b, NLIMBS, 1))


def fp_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_limbs(*torch.broadcast_tensors(a, b))
    return torch.where(borrow[..., None] == 1, carry(d + const_limbs(P, d), NLIMBS, 1), d)


def fp_neg(a: torch.Tensor) -> torch.Tensor:
    d, _ = _sub_limbs(const_limbs(P, a).expand_as(a), a)
    return torch.where(fp_is_zero(a)[..., None], a, d)


def fp_pow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e, square-and-multiply from the top bit (a multiply only where the
    bit is set, as the kernel does)."""
    acc = one_like(a)
    for bit in bin(e)[2:]:
        acc = fp_sqr(acc)
        if bit == "1":
            acc = fp_mul(acc, a)
    return acc


def fp_inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat a^(p-2); zero maps to zero (limb_mont.inv)."""
    return fp_pow(a, P - 2)


def fp_sqrt_candidate(a: torch.Tensor) -> torch.Tensor:
    """a^((p+1)/4): the square root where a is a square (p = 3 mod 4)."""
    return fp_pow(a, (P + 1) // 4)


def fp_sum_stack(arr: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum of at most 8 canonical values along `dim`, reduced mod p: one
    column sum, one carry, then 4p, 2p, p subtracted where they fit
    (fp_jax.fp_sum_stack)."""
    k = arr.shape[dim]
    assert k <= 8
    t = carry(arr.sum(dim), NLIMBS)
    for j in (2, 1, 0):
        if (1 << j) < k or j == 0:
            d, borrow = _sub_limbs(t, const_limbs(P << j, t))
            t = torch.where(borrow[..., None] == 1, t, d)
    return t


def fp_is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def fp_is_one_mont(a: torch.Tensor) -> torch.Tensor:
    return (a == const_limbs(R_MOD_P, a)).all(-1)


def one_like(a: torch.Tensor) -> torch.Tensor:
    return const_limbs(R_MOD_P, a).expand_as(a).clone()


# --- K8 -------------------------------------------------------------------------

_PLAIN_OPS = {OP_MUL: fp_mul, OP_SQR: fp_sqr, OP_ADD: fp_add, OP_SUB: fp_sub,
              OP_NEG: fp_neg, OP_INV: fp_inv, OP_SQRT: fp_sqrt_candidate}


def fp_ops_plain(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K8 on words: (M, 12) int32 (and b, broadcast to a)
    -> (M, 12) int32."""
    args = (to_limbs(a),) if op not in _BINARY else (to_limbs(a), to_limbs(b))
    return to_words(_PLAIN_OPS[op](*args))


def fp_ops(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise Fp op by op code on (M, 12) int32 Montgomery words: mul,
    sqr, add, sub (b of shape (M, 12) or (12,)), neg, inv, sqrt candidate.
    Kernel K8 on CUDA, the plain version on the CPU."""
    if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != NWORDS:
        raise ValueError(f"fp_ops takes (M, 12) int32, got {tuple(a.shape)} {a.dtype}")
    if op in _BINARY:
        if b is None or b.dtype != torch.int32 or b.shape[-1] != NWORDS or b.dim() > 2:
            raise ValueError("fp_ops: a binary op takes b of (M, 12) or (12,) int32")
        b = b.expand_as(a)
    if is_cpu(a):
        return fp_ops_plain(op, a, b)
    a = a.contiguous()
    b = a if b is None else b.contiguous()
    if b.device != a.device:
        raise ValueError("fp_ops: a and b on different devices")
    out = torch.empty_like(a)
    fn = build.entry("fp", "fp_ops", 3, 1)
    build.count_launch("fp_ops")
    build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], op,
                   build.stream_ptr(a)), "fp_ops")
    return out


def to_mont_words(words: torch.Tensor) -> torch.Tensor:
    """Canonical (M, 12) words -> Montgomery words: one K8 product by
    R^2 mod p on the card (the JAX package converts on the host,
    crypto/bls_jax.py:304)."""
    r2 = torch.from_numpy(ints_to_words([R2_MOD_P])[0]).to(words.device)
    return fp_ops(OP_MUL, words, r2)
