"""Batched sha256 over 32-bit word lanes (counterpart of ops/sha256_jax.py).

Words are int32 tensors holding the big-endian sha words' bit patterns:
(M, 16) message words in, (M, 8) digest words out. Two kernels in
csrc/sha256.cu, each behind a wrapper that launches it on a CUDA tensor and
runs its plain version, the same function in plain PyTorch over int64
lanes masked to 32 bits, on a CPU tensor:
- K1 `sha256_64B_words` (plain: `sha256_64B_words_plain`): sha256 of
  64-byte messages, two compressions;
- K4 `sha256_1block` (plain: `sha256_1block_plain`): one compression of a
  pre-padded single-block message.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..utils.device import is_cpu
from ..utils.u64 import MASK32, words_i32, words_i64
from .sha256_host import _H0, _K, PAD64

_KL = [int(k) for k in _K]
_H0L = [int(h) for h in _H0]


def _rotr(x, n):
    """Rotate right within 32 bits; x an int64 tensor or int in [0, 2**32)."""
    return ((x >> n) | (x << (32 - n))) & MASK32


def _schedule(w16: list) -> list:
    w = list(w16)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    return w


def _compress(state: list, w16: list) -> list:
    """state: 8 int64 lanes; w16: 16 lanes (tensors or ints) in [0, 2**32)."""
    w = _schedule(w16)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _KL[t] + w[t]) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & MASK32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & MASK32
    return [(s + v) & MASK32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _init_state(like: torch.Tensor) -> list:
    return [torch.full(like.shape, h, dtype=torch.int64, device=like.device) for h in _H0L]


def sha256_1block_plain(w16: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: sha256 of messages that fit one
    pre-padded block (the caller sets the terminator and bit length).
    (..., 16) int32 -> (..., 8) int32."""
    x = words_i64(w16)
    lanes = [x[..., i] for i in range(16)]
    return words_i32(torch.stack(_compress(_init_state(lanes[0]), lanes), dim=-1))


def sha256_64B_words_plain(w16: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: (..., 16) int32 -> (..., 8) int32."""
    x = words_i64(w16)
    lanes = [x[..., i] for i in range(16)]
    st = _compress(_init_state(lanes[0]), lanes)
    st = _compress(st, [int(p) for p in PAD64])
    return words_i32(torch.stack(st, dim=-1))


def aligned_out(out, shape, like: torch.Tensor) -> torch.Tensor:
    """`out` checked for the kernel's 16-byte stores, or a new tensor."""
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=like.device)
    if (out.dtype != torch.int32 or tuple(out.shape) != tuple(shape) or not out.is_contiguous()
            or out.data_ptr() % 16 or out.device != like.device):
        raise ValueError(f"out must be a contiguous 16-byte aligned {tuple(shape)} int32 "
                         f"tensor on {like.device}")
    return out


def _hash_kernel(fn_name: str, w16: torch.Tensor, out=None) -> torch.Tensor:
    if w16.dtype != torch.int32 or w16.shape[-1] != 16:
        raise ValueError(f"{fn_name} takes (..., 16) int32, got {tuple(w16.shape)} {w16.dtype}")
    w16 = w16.contiguous()
    if w16.data_ptr() % 16:
        w16 = w16.clone()  # the kernel reads 16-byte vectors
    out = aligned_out(out, w16.shape[:-1] + (8,), w16)
    fn = build.entry("sha256", fn_name, 2)
    build.count_launch(fn_name)
    build.check(fn(w16.data_ptr(), out.data_ptr(), w16.numel() // 16, build.stream_ptr(w16)),
                fn_name)
    return out


def sha256_64B_words(w16: torch.Tensor, out=None) -> torch.Tensor:
    """Batched sha256 of 64-byte messages, (..., 16) int32 words -> (..., 8)
    (a Merkle parent hash is left_root_words || right_root_words). Kernel K1
    on CUDA, the plain version on the CPU. `out`, if given, receives the
    digests."""
    if is_cpu(w16):
        digest = sha256_64B_words_plain(w16)
        return digest if out is None else out.copy_(digest)
    return _hash_kernel("sha256_64b", w16, out)


def sha256_1block(w16: torch.Tensor) -> torch.Tensor:
    """sha256 of pre-padded single-block messages, (..., 16) int32 ->
    (..., 8) (ops/sha256_jax.py:70). Kernel K4 on CUDA, the plain version on
    the CPU."""
    if is_cpu(w16):
        return sha256_1block_plain(w16)
    return _hash_kernel("sha256_1block", w16)


def merkle_parent_level(nodes: torch.Tensor, out=None) -> torch.Tensor:
    """One Merkle level: (2P, 8) digest-word nodes -> (P, 8) parents,
    written into `out` if given."""
    return sha256_64B_words(nodes.reshape(-1, 16), out)
