"""Roots of the device-owned BeaconState fields (counterpart of
engine/state_root.py `make_state_root_fn` -> `field_roots`).

`field_roots(st, static01)` returns the 14 field roots of DEVICE_FIELDS as
(8,) int32 word tensors. The per-validator container roots come from kernel
K2 (`validator_roots`, csrc/state_root.cu), every Merkle level and every
single hash from kernel K1 (`sha256_64B_words`); chunk packing, zero-chunk
padding and concatenation are PyTorch glue. On CPU tensors both wrappers run
their plain versions.

Byte order: words are big-endian sha words. SSZ packs a uint64 as 8
little-endian bytes, so one uint64 becomes the two words
bswap32(low half), bswap32(high half); a boolean leaf is its byte in the
top bits of word 0 (x << 24).

List limits are VALIDATOR_REGISTRY_LIMIT = 2**40 entries for every
registry-scale list, so chunk trees fold to depth 38 (uint64 bodies),
35 (uint8 bodies) and 40 (validator containers) against zero-subtree roots
before the length mix-in.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..kernels import build
from ..ops.sha256 import aligned_out, sha256_64B_words, sha256_64B_words_plain
from ..ops.sha256_host import zero_hash_words
from ..utils.device import is_cpu
from ..utils.u64 import MASK32, bswap32, words_i32, words_i64
from .state import EpochState

DEPTH_U64 = 38
DEPTH_U8 = 35
DEPTH_VALIDATORS = 40

DEVICE_FIELDS = frozenset({
    "slot", "validators", "balances", "inactivity_scores",
    "previous_epoch_participation", "current_epoch_participation",
    "slashings", "randao_mixes", "block_roots", "state_roots",
    "justification_bits", "previous_justified_checkpoint",
    "current_justified_checkpoint", "finalized_checkpoint",
})

_ZERO_WORDS = torch.from_numpy(zero_hash_words().view("int32").copy())  # (65, 8)


# Constants reach the device once per (value, device) and are only read
# afterwards: a blocking host-to-device copy would stall the stream in the
# middle of a root computation.
@lru_cache(maxsize=None)
def _zero_words_on(device: torch.device) -> torch.Tensor:
    return _ZERO_WORDS.to(device)


@lru_cache(maxsize=256)
def _length_chunk_on(n: int, device: torch.device) -> torch.Tensor:
    return _u64_single_chunk(torch.tensor(n, dtype=torch.int64)).to(device)


def _u64_words(a: torch.Tensor) -> torch.Tensor:
    """(...,) int64 (uint64) -> (..., 2) int64 words [bswap(lo), bswap(hi)]."""
    lo = bswap32(a & MASK32)
    hi = bswap32((a >> 32) & MASK32)
    return torch.stack([lo, hi], dim=-1)


def _u64_chunk_words(a: torch.Tensor) -> torch.Tensor:
    """(N,) int64 (uint64) -> (ceil(N/4), 8) int32 chunk words."""
    pad = (-a.shape[0]) % 4
    if pad:
        a = torch.cat([a, a.new_zeros(pad)])
    return words_i32(_u64_words(a).reshape(-1, 8))


def _u64_single_chunk(x) -> torch.Tensor:
    """() int64 tensor -> (8,) int32 chunk."""
    return _u64_chunk_words(x.reshape(1))[0]


def _u8_chunk_words(a: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 (or bool) -> (ceil(N/32), 8) int32 chunk words."""
    a = a.to(torch.int64)
    pad = (-a.shape[0]) % 32
    if pad:
        a = torch.cat([a, a.new_zeros(pad)])
    b = a.reshape(-1, 8, 4)
    return words_i32((b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3])


def _tree_root(chunks: torch.Tensor, h):
    """(C, 8) chunk words -> ((8,) root of the 2**ceil(log2 C) tree, depth).
    Padding is zero CHUNKS (leaves), not zero hashes. `h` hashes (M, 16)
    words to (M, 8): K1's wrapper, or its plain version."""
    c = chunks.shape[0]
    depth = (c - 1).bit_length() if c > 1 else 0
    full = 1 << depth
    if full != c:
        chunks = torch.cat([chunks, chunks.new_zeros(full - c, 8)])
    nodes = chunks
    for _ in range(depth):
        nodes = h(nodes.reshape(-1, 16))
    return nodes[0], depth


def _extend(root: torch.Tensor, from_depth: int, to_depth: int, h) -> torch.Tensor:
    """Fold the root up to `to_depth` against zero-subtree roots."""
    zw = _zero_words_on(root.device)
    for d in range(from_depth, to_depth):
        root = h(torch.cat([root, zw[d]])[None])[0]
    return root


def _mix_len(root: torch.Tensor, n: int, h) -> torch.Tensor:
    return h(torch.cat([root, _length_chunk_on(n, root.device)])[None])[0]


def _list_root_u64(a: torch.Tensor, h) -> torch.Tensor:
    root, depth = _tree_root(_u64_chunk_words(a), h)
    return _mix_len(_extend(root, depth, DEPTH_U64, h), a.shape[0], h)


def _list_root_u8(a: torch.Tensor, h) -> torch.Tensor:
    root, depth = _tree_root(_u8_chunk_words(a), h)
    return _mix_len(_extend(root, depth, DEPTH_U8, h), a.shape[0], h)


def _vector_root_words(rows: torch.Tensor, h) -> torch.Tensor:
    """(S, 8) chunk/root words, S = 2**k -> (8,)."""
    return _tree_root(rows, h)[0]


# ---------------------------------------------------------------------------
# Kernel K2 and its plain version

_ROOT_COLUMNS = ("effective_balance", "activation_eligibility_epoch", "activation_epoch",
                 "exit_epoch", "withdrawable_epoch")


# The six columns a container root reads besides static01, in the order of
# the JAX package's `_registry_cols` (engine/incremental_root.py).
REGISTRY_COLUMNS = ("effective_balance", "slashed", "activation_eligibility_epoch",
                    "activation_epoch", "exit_epoch", "withdrawable_epoch")


def container_roots_plain(static01: torch.Tensor, cols) -> torch.Tensor:
    """(K, 8) int32 Validator container roots of K rows, in plain PyTorch
    (engine/incremental_root.py:102 `_validator_rows_roots`): leaves 0-1
    from static01 (K, 16) (hash_tree_root(pubkey) || withdrawal
    credentials), leaves 2-7 from the six REGISTRY_COLUMNS values (K,)
    each, folded as the 8-leaf container tree."""
    eff, slashed, aee, act, ext, wd = cols
    k = eff.shape[0]
    zeros6 = torch.zeros((k, 6), dtype=torch.int64, device=eff.device)

    def chunk(col):
        return torch.cat([_u64_words(col), zeros6], dim=1)

    def bchunk(col):  # boolean leaf: one byte
        b = (col.to(torch.int64) & 1) << 24
        return torch.cat([b[:, None], torch.zeros((k, 7), dtype=torch.int64, device=eff.device)],
                         dim=1)

    def h(*parts):
        return words_i64(sha256_64B_words_plain(words_i32(torch.cat(parts, dim=1))))

    h01 = words_i64(sha256_64B_words_plain(static01))
    h23 = h(chunk(eff), bchunk(slashed))
    h45 = h(chunk(aee), chunk(act))
    h67 = h(chunk(ext), chunk(wd))
    return words_i32(h(h(h01, h23), h(h45, h67)))


def registry_columns(st: EpochState) -> tuple:
    return tuple(getattr(st, name) for name in REGISTRY_COLUMNS)


def validator_roots_plain(static01: torch.Tensor, st: EpochState) -> torch.Tensor:
    """(N, 8) int32 roots of the N Validator containers, in plain PyTorch."""
    return container_roots_plain(static01, registry_columns(st))


def _validator_roots_kernel(static01: torch.Tensor, st: EpochState, out=None) -> torch.Tensor:
    n = st.num_validators
    if static01.dtype != torch.int32 or tuple(static01.shape) != (n, 16):
        raise ValueError(f"validator_roots: static01 must be ({n}, 16) int32, "
                         f"got {tuple(static01.shape)} {static01.dtype}")
    cols = [getattr(st, name) for name in _ROOT_COLUMNS]
    for name, t in zip(_ROOT_COLUMNS, cols):
        if t.dtype != torch.int64 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"validator_roots: {name} must be contiguous ({n},) int64")
    if st.slashed.dtype != torch.bool or not st.slashed.is_contiguous():
        raise ValueError("validator_roots: slashed must be contiguous bool")
    for t in (static01, *cols, st.slashed):
        if t.device != st.device:
            raise ValueError("validator_roots: inputs on different devices")
    static01 = static01.contiguous()
    if static01.data_ptr() % 16:
        static01 = static01.clone()  # the kernel reads 16-byte vectors
    out = aligned_out(out, (n, 8), static01)
    fn = build.entry("state_root", "validator_roots", 8)
    build.count_launch("validator_roots")
    build.check(fn(static01.data_ptr(), *[t.data_ptr() for t in cols], st.slashed.data_ptr(),
                   out.data_ptr(), n, build.stream_ptr(out)), "validator_roots")
    return out


def validator_roots(static01: torch.Tensor, st: EpochState, out=None) -> torch.Tensor:
    """Kernel K2 on CUDA tensors, `validator_roots_plain` on CPU tensors;
    `out`, if given, receives the roots."""
    if is_cpu(st.balances):
        roots = validator_roots_plain(static01, st)
        return roots if out is None else out.copy_(roots)
    return _validator_roots_kernel(static01, st, out)


def _validators_root(static01: torch.Tensor, st: EpochState, h, vroots) -> torch.Tensor:
    """Registry list root: container roots (K2), then the list tree (K1)."""
    root, depth = _tree_root(vroots(static01, st), h)
    return _mix_len(_extend(root, depth, DEPTH_VALIDATORS, h), st.num_validators, h)


def _checkpoint_root(epoch: torch.Tensor, root_words: torch.Tensor, h) -> torch.Tensor:
    return h(torch.cat([_u64_single_chunk(epoch), root_words])[None])[0]


def light_field_roots(st: EpochState, h=sha256_64B_words) -> dict:
    """Roots of the fields an epoch rewrites wholesale plus the O(1) fields."""
    shifts = torch.arange(4, device=st.device)
    jb_byte = (st.justification_bits.to(torch.int64) << shifts).sum()
    return {
        "balances": _list_root_u64(st.balances, h),
        "inactivity_scores": _list_root_u64(st.inactivity_scores, h),
        "previous_epoch_participation": _list_root_u8(st.prev_participation, h),
        "current_epoch_participation": _list_root_u8(st.curr_participation, h),
        "justification_bits": _u8_chunk_words(jb_byte.reshape(1))[0],
        "previous_justified_checkpoint": _checkpoint_root(
            st.prev_justified_epoch, st.prev_justified_root, h),
        "current_justified_checkpoint": _checkpoint_root(
            st.curr_justified_epoch, st.curr_justified_root, h),
        "finalized_checkpoint": _checkpoint_root(st.finalized_epoch, st.finalized_root, h),
    }


def _field_roots(st: EpochState, static01: torch.Tensor, h, vroots) -> dict:
    roots = light_field_roots(st, h)
    roots.update({
        "slot": _u64_single_chunk(st.slot),
        "validators": _validators_root(static01, st, h, vroots),
        "slashings": _vector_root_words(_u64_chunk_words(st.slashings), h),
        "randao_mixes": _vector_root_words(st.randao_mixes, h),
        "block_roots": _vector_root_words(st.block_roots, h),
        "state_roots": _vector_root_words(st.state_roots, h),
    })
    return roots


def field_roots(st: EpochState, static01: torch.Tensor) -> dict:
    """{DEVICE_FIELDS name: (8,) int32 root words} of the device-owned
    BeaconState fields. static01: (N, 16) int32 words, hash_tree_root(pubkey)
    || withdrawal_credentials per validator (immutable per index). Kernels
    K2 and K1 on CUDA tensors, their plain versions on CPU tensors."""
    return _field_roots(st, static01, sha256_64B_words, validator_roots)


def field_roots_plain(st: EpochState, static01: torch.Tensor) -> dict:
    """`field_roots` through the plain versions only, on any device: the
    reference the kernels are held against on the card."""
    return _field_roots(st, static01, sha256_64B_words_plain, validator_roots_plain)
