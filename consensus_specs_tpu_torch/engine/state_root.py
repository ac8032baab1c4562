"""Roots of the device-owned BeaconState fields (counterpart of
engine/state_root.py `make_state_root_fn` -> `field_roots`).

`field_roots(st, static01)` returns the 14 field roots of DEVICE_FIELDS as
(8,) int32 word tensors. `tree_root_batch` (kernel K19, csrc/tree_root.cu)
folds K power-of-two trees at once; `multiproof_batch` (kernels K20 +
K21, `ops/multiproof.py`) is the read lane's host entry;
`validator_static_leaves` and `assemble_state_root` join the device roots to a spec BeaconState's
host-owned fields. The per-validator container roots come from kernel
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

import numpy as np
import torch

from ..kernels import build
from ..obs import trace as obs_trace
from ..ops.multiproof import sibling_rows_batch
from ..ops.sha256 import aligned_out, sha256_64B_words, sha256_64B_words_plain
from ..ops.sha256_host import words_to_bytes, zero_hash_words
from ..utils.device import is_cpu, resolve_device
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


# ---------------------------------------------------------------------------
# Kernel K19 and its plain version

TREE_FOLD_MAX_LEVELS = 10  # levels one K19 launch folds: 2^10 rows a block


def _check_tree_chunks(chunks: torch.Tensor) -> tuple:
    if chunks.dim() != 3 or chunks.shape[2] != 8 or chunks.dtype != torch.int32:
        raise ValueError(f"tree_root_batch takes (K, C, 8) int32 chunk words, got "
                         f"{tuple(chunks.shape)} {chunks.dtype}")
    k, c, _ = chunks.shape
    if c < 1 or c & (c - 1):
        raise ValueError(f"tree_root_batch: the chunk count a tree must be a power of two, "
                         f"got {c}")
    return k, c


def tree_root_batch_plain(chunks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K19 (engine/state_root.py:114
    `_tree_root_batch_impl`): (K, C, 8) int32 chunk words, C a power of
    two -> (K, 8) int32 roots. The K trees fold as one flat (K*C, 8) array,
    one level at a time: a level's adjacent pairs never cross a tree."""
    k, c = _check_tree_chunks(chunks)
    nodes = chunks.reshape(k * c, 8)
    for _ in range((c - 1).bit_length()):
        nodes = sha256_64B_words_plain(nodes.reshape(-1, 16))
    return nodes.reshape(k, 8).clone()


def _tree_root_batch_kernel(chunks: torch.Tensor) -> torch.Tensor:
    k, c = _check_tree_chunks(chunks)
    nodes = chunks.contiguous().reshape(k * c, 8)
    if nodes.data_ptr() % 16:
        nodes = nodes.clone()  # the kernel reads 16-byte vectors
    fn = build.entry("tree_root", "tree_root_fold", 2, 1)
    per_tree = c
    while per_tree > 1:
        s = min(TREE_FOLD_MAX_LEVELS, (per_tree - 1).bit_length())
        per_tree >>= s
        out = torch.empty((k * per_tree, 8), dtype=torch.int32, device=nodes.device)
        build.count_launch("tree_root_batch")
        build.check(fn(nodes.data_ptr(), out.data_ptr(), k * per_tree, s,
                       build.stream_ptr(out)), "tree_root_batch")
        nodes = out
    return nodes.reshape(k, 8) if c > 1 else nodes.reshape(k, 8).clone()


def tree_root_batch(chunks: torch.Tensor) -> torch.Tensor:
    """Roots of K Merkle trees of C chunks each (C a power of two):
    (K, C, 8) int32 words -> (K, 8). Kernel K19 on CUDA tensors (one launch
    a 10 levels), `tree_root_batch_plain` on CPU tensors. C = 1 hashes
    nothing: the roots are the chunks."""
    if is_cpu(chunks):
        return tree_root_batch_plain(chunks)
    return _tree_root_batch_kernel(chunks)


def multiproof_batch(chunk_words, tree_ids, gindices, device="cuda") -> tuple:
    """Host entry of the batched multiproof kernels (engine/state_root.py:135):
    numpy in, numpy out. chunk_words (K, C, 8) uint32 with C a power of two
    (K and Q are the caller's buckets); tree_ids and gindices (Q,) select
    (tree, node) per query. Returns (siblings (Q, D, 8), nodes (Q, 8),
    roots (K, 8)) uint32; a query at depth d uses siblings[:d], deepest
    first (`ssz/proofs.build_chunk_proof` order). K20 + K21 on the card
    (`ops/multiproof.sibling_rows_batch`), the plain version with
    device="cpu"; raises without a card unless asked for the CPU.

    With a tracer installed (obs/trace.py) and a CUDA device, the copies in,
    the kernels and the copies out are timed with CUDA events, and the
    enclosing span gets `device_event_ms`."""
    dev = resolve_device(device)
    words = torch.from_numpy(np.ascontiguousarray(chunk_words, dtype=np.uint32).view(np.int32))
    tids = torch.from_numpy(np.ascontiguousarray(tree_ids, dtype=np.int32))
    gidx = torch.from_numpy(np.ascontiguousarray(gindices, dtype=np.int32))
    events = None
    if dev.type == "cuda" and obs_trace.current_tracer() is not None:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    out = sibling_rows_batch(words.to(dev), tids.to(dev), gidx.to(dev))
    host = tuple(t.cpu().numpy().view(np.uint32) for t in out)
    if events is not None:
        events[1].record()
        events[1].synchronize()
        obs_trace.annotate(device_event_ms=events[0].elapsed_time(events[1]))
    return host


# ---------------------------------------------------------------------------
# The spec state's root from device field roots


def validator_static_leaves(state) -> np.ndarray:
    """(N, 16) uint32 words: hash_tree_root(pubkey) || withdrawal_credentials
    of every validator of a spec BeaconState (engine/state_root.py:274):
    the two immutable leaves of each Validator container, the pubkey roots
    (sha256 of the 48 key bytes and 16 zero bytes) in one native pair-hasher
    call. As int32 words, `static01` of `field_roots`."""
    from ..ssz.merkle import hash_pairs_blob

    vals = state.validators
    n = len(vals)
    pk_roots = hash_pairs_blob(b"".join(bytes(v.pubkey) + b"\x00" * 16 for v in vals))
    wc_blob = b"".join(bytes(v.withdrawal_credentials) for v in vals)
    out = np.zeros((n, 16), dtype=np.uint32)
    out[:, :8] = np.frombuffer(pk_roots, dtype=">u4").reshape(n, 8)
    out[:, 8:] = np.frombuffer(wc_blob, dtype=">u4").reshape(n, 8)
    return out


def assemble_state_root(spec, state, device_roots: dict) -> bytes:
    """hash_tree_root(state) from the device-owned field roots
    (`field_roots`' {name: (8,) int32 words}) and the port ssz's roots of
    the fields the host owns (engine/state_root.py:303)."""
    from ..ssz import hash_tree_root
    from ..ssz.merkle import merkleize_chunks

    chunks = []
    for name in type(state).fields():
        if name in DEVICE_FIELDS:
            chunks.append(words_to_bytes(device_roots[name].cpu().numpy()))
        else:
            chunks.append(bytes(hash_tree_root(getattr(state, name))))
    return merkleize_chunks(chunks)
