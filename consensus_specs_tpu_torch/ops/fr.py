"""The BLS12-381 scalar field Fr and its NTT (counterpart of the Fr instance
of ops/limb_mont.py `MontgomeryField` and of ops/fr_jax.py).

Layouts. R = 2^256 in both packages (JAX's 16 sixteen-bit limbs, the port's
8 thirty-two-bit words), so a Montgomery value is the same integer
a·2^256 mod r in both, and every value is canonical (in [0, r)).
- On the card and at every public boundary: (..., 8) int32, the bit
  patterns of eight little-endian 32-bit words (`NWORDS`).
- The plain version: (..., 16) int64 sixteen-bit limbs (`NLIMBS`), as
  ops/fp.py keeps Fp, with fp.py's width-generic carry helpers.
- JAX's (..., 16) uint32 limbs cross with engine/convert.py's
  `fp_from_jax_limbs` / `fp_to_jax_limbs`, whose repacking does not depend
  on the width.

Codecs are vectorised through bytes: `ints_to_words` / `words_to_ints` for
canonical values, `ints_to_mont` / `mont_to_ints` through the Montgomery
domain, converted on the tensor's device by one K23 product each (by R^2
mod r in, by 1 out), never by a per-element `pow(R, -1, r)` on the host.
The constant rows (R^2 mod r, 1, n^-1) are cached per device
(`const_row`), so a hot call copies nothing to the card but its data.

The NTT is JAX's `_ntt_impl`: the bit-reverse permutation, then log2 n
radix-2 DIT stages over the twiddle tables; the inverse multiplies by
1/n. The twiddles are cached per (n, inverse, device) as one flat (n - 1, 8)
table, stage s (half-size 2^s) at offset 2^s - 1. K22 runs the stages in
passes through shared memory (`ntt_passes`: pass A over the first
`ntt_tile_log(n)` stages on contiguous tiles, then passes over up to
NTT_PASS_STAGES stages on column groups; two grids at the DAS widths).

`ntt_words` is the DAS path's transform: canonical words in and out, the
conversions folded into K22's first and last stage (one entry call, no K23
launch); `inv_ints` is one K23 launch of `OP_INV_WORDS` (the conversions
inside the kernel).

Two kernels in csrc/ntt.cu, each behind its wrapper: K22 `fr_ntt` (`ntt`,
`ntt_words`) and K23 `fr_ops` (`fr_ops`). On a CPU tensor a wrapper runs
its plain version (`ntt_plain`, `ntt_words_plain`, `fr_ops_plain`); on a
CUDA tensor it launches the kernel or raises `kernels/build.KernelError`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..utils.device import is_cpu, resolve_device
from ..utils.u64 import words_i32
from .fp import _product_cols, _sub_limbs, carry, const_limbs, to_limbs
from .fr_host import R_MODULUS, root_of_unity

NWORDS = 8
NLIMBS = 16
MASK = 0xFFFF
R = 1 << 256
R_MOD_R = R % R_MODULUS
R2_MOD_R = R * R % R_MODULUS
N0_32 = (-pow(R_MODULUS, -1, 1 << 32)) % (1 << 32)  # the kernel's CIOS constant
NPRIME = (-pow(R_MODULUS, -1, R)) % R  # the plain version's full-width REDC constant

# K23 op codes (csrc/ntt.cu); OP_INV_WORDS inverts canonical words to
# canonical words (Montgomery conversions inside the kernel)
OP_MUL, OP_ADD, OP_SUB, OP_INV, OP_INV_WORDS = range(5)
_BINARY = (OP_MUL, OP_ADD, OP_SUB)

# K22's plan (csrc/ntt.cu's NTT_* constants): pass A over at most
# NTT_TILE_LOG stages, later passes over at most NTT_PASS_STAGES on
# 2^NTT_COLS_LOG columns, at most 2^NTT_GROUP_LOG elements a block
NTT_TILE_LOG = 8
NTT_PASS_STAGES = 8
NTT_COLS_LOG = 2
NTT_GROUP_LOG = 10


# --- host codecs --------------------------------------------------------------


def ints_to_words(xs) -> np.ndarray:
    """(n, 8) int32 word bit patterns of the ints xs (each in [0, 2^256))."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").astype(np.uint32).view(np.int32).reshape(-1, NWORDS)


def words_to_ints(arr) -> list[int]:
    """(..., 8) words (int32 or uint32, numpy or tensor) -> flat list of ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    buf = np.ascontiguousarray(np.asarray(arr).reshape(-1, NWORDS).view(np.uint32)).astype(
        "<u4").tobytes()
    return [int.from_bytes(buf[i:i + 32], "little") for i in range(0, len(buf), 32)]


_CONSTS: dict = {}


def const_row(x: int, device) -> torch.Tensor:
    """The (8,) words of x on `device`, cached per (x, device): a hot call
    copies no constant to the card."""
    key = (x, str(torch.device(device)))
    if key not in _CONSTS:
        _CONSTS[key] = torch.from_numpy(ints_to_words([x])[0].copy()).to(device)
    return _CONSTS[key]


def ints_words(xs, device) -> torch.Tensor:
    """Ints (reduced mod r here) -> (n, 8) canonical words on `device`."""
    return torch.from_numpy(ints_to_words([int(x) % R_MODULUS for x in xs])).to(device)


def ints_to_mont(xs, device) -> torch.Tensor:
    """Ints (reduced mod r here) -> (n, 8) Montgomery words on `device`: one
    K23 product by R^2 mod r on the card, its plain version on the CPU."""
    words = ints_words(xs, device)
    return fr_ops(OP_MUL, words, const_row(R2_MOD_R, words.device))


def mont_to_ints(t: torch.Tensor) -> list[int]:
    """(..., 8) Montgomery words -> flat list of canonical ints: one K23
    product by 1 on the tensor's device, then the bytes to the host."""
    flat = t.reshape(-1, NWORDS)
    return words_to_ints(fr_ops(OP_MUL, flat, const_row(1, flat.device)))


# --- words <-> limbs (fp.to_limbs splits any width) ------------------------------


def to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 limbs (each < 2^16) -> (..., 8) int32 words."""
    pairs = limbs.reshape(*limbs.shape[:-1], NWORDS, 2)
    return words_i32(pairs[..., 0] | (pairs[..., 1] << 16))


# --- plain field arithmetic on (..., 16) int64 limbs ---------------------------


def _limbs(x: int, like: torch.Tensor) -> torch.Tensor:
    return const_limbs(x, like, NLIMBS)


def _cond_sub_r(t: torch.Tensor) -> torch.Tensor:
    """t - r where t >= r, else t (t < 2r, canonical limbs)."""
    d, borrow = _sub_limbs(t, _limbs(R_MODULUS, t))
    return torch.where(borrow[..., None] == 1, t, d)


def fr_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R^-1 mod r (REDC at full width). Product
    columns stay below 16·2^32 = 2^36, inside `carry`'s 2^41."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    t = carry(_product_cols(a.reshape(-1, NLIMBS), b.reshape(-1, NLIMBS)), 2 * NLIMBS)
    m = carry(_product_cols(t[..., :NLIMBS], _limbs(NPRIME, t)), NLIMBS)
    u = carry(torch.nn.functional.pad(_product_cols(m, _limbs(R_MODULUS, t)), (0, 1)) + t,
              2 * NLIMBS + 1)
    return _cond_sub_r(u[..., NLIMBS:2 * NLIMBS]).reshape(shape)


def fr_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub_r(carry(a + b, NLIMBS, 1))  # a + b < 2r < 2^256


def fr_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, plus r where it borrows. b = 0 borrows nowhere and returns a,
    the value limb_mont.py:159-163 reaches through a + r and one cond_sub."""
    d, borrow = _sub_limbs(*torch.broadcast_tensors(a, b))
    return torch.where(borrow[..., None] == 1, carry(d + _limbs(R_MODULUS, d), NLIMBS, 1),
                       d)


def fr_inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat a^(r-2), square-and-multiply from the top bit; zero maps to
    zero (limb_mont.py:219-220)."""
    acc = _limbs(R_MOD_R, a).expand_as(a).clone()
    for bit in bin(R_MODULUS - 2)[2:]:
        acc = fr_mul(acc, acc)
        if bit == "1":
            acc = fr_mul(acc, a)
    return acc


def fr_inv_words(a: torch.Tensor) -> torch.Tensor:
    """Inverse of canonical values to canonical values (zero to zero): a
    product by R^2 mod r into the Montgomery domain, `fr_inv`, a product by
    1 out of it."""
    return fr_mul(fr_inv(fr_mul(a, _limbs(R2_MOD_R, a))), _limbs(1, a))


_PLAIN_OPS = {OP_MUL: fr_mul, OP_ADD: fr_add, OP_SUB: fr_sub, OP_INV: fr_inv,
              OP_INV_WORDS: fr_inv_words}


def _check_words(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.shape[-1:] != (NWORDS,):
        raise ValueError(f"{name} takes (..., 8) int32 words, got {tuple(t.shape)} {t.dtype}")


def fr_ops_plain(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K23 on words: (M, 8) int32 (and b, broadcast to a)
    -> (M, 8) int32."""
    args = (to_limbs(a),) if op not in _BINARY else (to_limbs(a), to_limbs(b))
    return to_words(_PLAIN_OPS[op](*args))


def fr_ops(op: int, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise Fr op by op code on (M, 8) int32 Montgomery words: mul,
    add, sub (b of shape (M, 8) or (8,)), inv; `OP_INV_WORDS` on canonical
    words. Kernel K23 on CUDA, the plain version on the CPU."""
    if a.dim() != 2:
        raise ValueError(f"fr_ops takes (M, 8) int32, got {tuple(a.shape)}")
    _check_words("fr_ops", a)
    if op not in _PLAIN_OPS:
        raise ValueError(f"fr_ops: unknown op code {op}")
    if op in _BINARY:
        if b is None or b.dim() > 2:
            raise ValueError("fr_ops: a binary op takes b of (M, 8) or (8,) int32")
        _check_words("fr_ops", b)
        if b.dim() == 2 and b.shape[0] != a.shape[0]:
            raise ValueError(f"fr_ops: b has {b.shape[0]} rows, a {a.shape[0]}")
        if b.device != a.device:
            raise ValueError("fr_ops: a and b on different devices")
    if is_cpu(a):
        return fr_ops_plain(op, a, None if b is None else b.expand_as(a))
    a = a.contiguous()
    b_step = 0 if b is None or b.dim() == 1 else 1  # an (8,) b is read by every thread
    b = a if b is None else b.contiguous()
    out = torch.empty_like(a)
    fn = build.entry("ntt", "fr_ops", 3, 2)
    build.count_launch("fr_ops")
    build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], op, b_step,
                   build.stream_ptr(a)), "fr_ops")
    return out


# --- the NTT --------------------------------------------------------------------

_TWIDDLES: dict = {}


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the NTT size must be a power of two >= 1, got {n}")
    if n > 1 << 32:
        raise ValueError(f"Fr has roots of unity up to order 2^32, not {n}")
    return n.bit_length() - 1


def twiddles(n: int, inverse: bool, device) -> tuple:
    """(flat (n - 1, 8) Montgomery twiddle table, (8,) Montgomery 1/n or None)
    on `device`, cached per (n, inverse, device). Stage s (blocks of 2^(s+1))
    reads the first 2^s powers of the 2^(s+1)-th root (or of its inverse)
    at offset 2^s - 1: fr_jax.py:65 `_twiddle_tables`, flattened."""
    key = (n, bool(inverse), str(torch.device(device)))
    if key not in _TWIDDLES:
        powers = []
        for s in range(_log2(n)):
            w = root_of_unity(2 << s)
            if inverse:
                w = pow(w, R_MODULUS - 2, R_MODULUS)
            acc = 1
            for _ in range(1 << s):
                powers.append(acc * R % R_MODULUS)
                acc = acc * w % R_MODULUS
        table = torch.from_numpy(ints_to_words(powers)).to(device)
        scale = (const_row(pow(n, R_MODULUS - 2, R_MODULUS) * R % R_MODULUS, device)
                 if inverse else None)
        _TWIDDLES[key] = (table, scale)
    return _TWIDDLES[key]


def bit_reverse_perm(n: int) -> torch.Tensor:
    """fr_jax.py:81 `_bit_reverse_perm` as an int64 tensor."""
    bits = _log2(n)
    idx = torch.arange(n)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt_plain(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain version of K22 on (..., n, 8) Montgomery words: the bit-reverse
    gather, log2 n DIT stages (fr_jax.py:90 `_ntt_impl`), and for the
    inverse a product by 1/n (:114, :120)."""
    _check_words("ntt_plain", values)
    n = values.shape[-2]
    table, scale = twiddles(n, inverse, values.device)
    x = to_limbs(values)[..., bit_reverse_perm(n).to(values.device), :]
    tw = to_limbs(table)
    for s in range(_log2(n)):
        half = 1 << s
        xb = x.reshape(x.shape[:-2] + (n // (2 * half), 2, half, NLIMBS))
        lo = xb[..., 0, :, :]
        hi = fr_mul(xb[..., 1, :, :], tw[half - 1:2 * half - 1])
        x = torch.stack([fr_add(lo, hi), fr_sub(lo, hi)], dim=-3).reshape(x.shape)
    if inverse:
        x = fr_mul(x, to_limbs(scale))
    return to_words(x)


def ntt_tile_log(n: int) -> int:
    """Pass A's stages for size n: NTT_TILE_LOG, or log2 n where smaller
    (n <= 2^NTT_TILE_LOG is one pass, one grid)."""
    return min(_log2(n), NTT_TILE_LOG)


def ntt_passes(logn: int, t: int) -> list:
    """K22's passes over the stages of a size-2^logn transform, pass A over
    t: [(s0, s1, logc)], each one grid over stages s0 .. s1-1 with groups of
    2^logc columns (csrc/ntt.cu's launcher runs the same loop)."""
    passes, s0, s1 = [], 0, t
    while s0 < logn:
        passes.append((s0, s1, 0 if s0 == 0 else min(s0, NTT_COLS_LOG)))
        s0, s1 = s1, min(s1 + NTT_PASS_STAGES, logn)
    return passes


def _launch_ntt(src: torch.Tensor, table, pre, post, logn: int, t: int) -> torch.Tensor:
    """One K22 entry call on (B, 2^logn, 8) contiguous words: pass A over t
    stages (1 <= t <= min(logn, NTT_GROUP_LOG); ignored at n = 1), the
    constant rows `pre` and `post` (or None)."""
    out = torch.empty_like(src)
    fn = build.entry("ntt", "fr_ntt", 5, 2)
    build.count_launch("fr_ntt")
    build.check(fn(src.data_ptr(), out.data_ptr(), table.data_ptr(),
                   None if pre is None else pre.data_ptr(),
                   None if post is None else post.data_ptr(), src.shape[0], logn, t,
                   build.stream_ptr(src)), "fr_ntt")
    return out


def _inverse_n(n: int, device) -> torch.Tensor:
    """Canonical n^-1 mod r: the canonical transform's last product, 1/n and
    the way out of the Montgomery domain at once (mont(y·R, n^-1) = y/n)."""
    return const_row(pow(n, R_MODULUS - 2, R_MODULUS), device)


def ntt_words_plain(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain version of `ntt_words`: K23's product by R^2 mod r, `ntt_plain`,
    K23's product by 1, on (..., n, 8) words."""
    _check_words("ntt_words_plain", values)
    flat = values.reshape(-1, NWORDS)
    mont = fr_ops_plain(OP_MUL, flat, const_row(R2_MOD_R, flat.device).expand_as(flat))
    out = ntt_plain(mont.reshape(values.shape), inverse).reshape(-1, NWORDS)
    return fr_ops_plain(OP_MUL, out, const_row(1, flat.device).expand_as(out)).reshape(
        values.shape)


_NTT_ROWS: dict = {}  # (n, inverse, canonical, device) -> (table, pre, post)


def _ntt_entry(name: str, values: torch.Tensor, inverse: bool, canonical: bool):
    """K22 on (..., n, 8) words, Montgomery or canonical, or its plain
    version on a CPU tensor."""
    _check_words(name, values)
    if values.dim() < 2:
        raise ValueError(f"{name} takes (..., n, 8) int32, got {tuple(values.shape)}")
    n = values.shape[-2]
    logn = _log2(n)
    if is_cpu(values):
        return (ntt_words_plain if canonical else ntt_plain)(values, inverse)
    key = (n, bool(inverse), canonical, values.device)
    rows = _NTT_ROWS.get(key)
    if rows is None:  # one lookup a hot call: the twiddles and constant rows
        dev = values.device
        table, scale = twiddles(n, inverse, dev)
        rows = (table, None, scale)
        if canonical:
            rows = (table, const_row(R2_MOD_R, dev),
                    _inverse_n(n, dev) if inverse else const_row(1, dev))
        _NTT_ROWS[key] = rows
    src = values.reshape(-1, n, NWORDS).contiguous()
    return _launch_ntt(src, *rows, logn, ntt_tile_log(n)).reshape(values.shape)


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT (or inverse NTT, 1/n included) of size n over (..., n, 8) int32
    Montgomery words, n a power of two. Kernel K22 on CUDA (one entry call:
    the bit-reverse gather folded into pass A's loads, then `ntt_passes`),
    the plain version on the CPU."""
    return _ntt_entry("ntt", values, inverse, canonical=False)


def ntt_words(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT (or inverse NTT) of size n over (..., n, 8) int32 canonical words
    (any eight words: reduced by the first product), canonical words out.
    Kernel K22 on CUDA, one entry call: pass A multiplies each gathered
    element by R^2 mod r, the last stage by 1 (forward) or by canonical
    n^-1 (inverse). The plain version on the CPU."""
    return _ntt_entry("ntt_words", values, inverse, canonical=True)


def inv_ints(values, device="cuda") -> list[int]:
    """Inverses mod r of a list of ints (zero maps to zero) on `device`: one
    K23 `OP_INV_WORDS` launch, the conversions inside it (the plain version
    on the CPU)."""
    return words_to_ints(fr_ops(OP_INV_WORDS, ints_words(values, resolve_device(device))))


def ntt_ints(values, inverse: bool = False, device="cuda") -> list[int]:
    """NTT of a list of ints (reduced mod r) on `device` ("cuda" raises
    without a card): one K22 launch of `ntt_words` (the plain version on the
    CPU), canonical ints out. The das module's one NTT path."""
    return words_to_ints(ntt_words(ints_words(values, resolve_device(device)), inverse))
