"""Batched LMD-GHOST head selection (counterpart of ops/forkchoice_jax.py).

The spec's `get_head` (phase0/fork-choice.md: the greedy child walk from the
justified root maximizing `(get_latest_attesting_balance, root)` over
`filter_block_tree`'s tree) over Q padded store snapshots at once, in the
JAX program's layout (`_ghost_head_impl`, vmapped):

- `parent` (Q, B) int32 parent index in [0, B) (the anchor and pads
  self-looped); `root_words` (Q, B, 8) int64, the big-endian uint32 root
  words as values in [0, 2**32) (CPU torch has no uint32 compares);
- `ck_epochs` (Q, B, 2) int64 and `ck_rids` (Q, B, 2) int32, each block's
  (justified, finalized) checkpoint epoch and interned root id;
  `is_real` (Q, B) bool;
- `votes` (Q, V) int32 latest-message block index (-1 = none), `balances`
  (Q, V) int64 effective Gwei (not negative; sums below 2**63);
- `idx_scalars` (Q, 4) int32 [justified_idx, boost_idx (-1 = off),
  store_justified_rid, store_finalized_rid]; `ep_scalars` (Q, 4) int64
  [store_justified_epoch, store_finalized_epoch, GENESIS_EPOCH,
  boost_weight].

Four stages, each a kernel of csrc/forkchoice.cu on CUDA tensors and its
plain PyTorch version on CPU tensors:

- K15 `ancestors`: (Q, B, W) int32 ancestor-or-self bitsets, W =
  ceil(B / 32), bit c of row i set when c is i or an ancestor of i (within
  2**ceil(log2 B) - 1 steps, as JAX's pointer doubling reaches);
- K16 `vote_weights`: (Q, B) int64 exact direct weight a block;
- K17 `subtree`: (Q, B) int64 subtree weight with the proposer boost, and
  (Q, B) bool viability (an FFG-agreeing leaf below or at the block);
- K18 `head_walk`: (Q, B) bool filter (viable, real, at or below the
  justified block) and the (Q,) int32 head.

`ghost_head_parts` runs the plain versions on any device and returns every
stage's output, so that a kernel can be held against them on its own output;
`ghost_head` runs the stages through the wrappers. No path falls back from a
kernel to its plain version.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..utils.device import is_cpu
from ..utils.u64 import MASK32, words_i32

# Largest B whose per-block tables K15, K16 and K18 keep in shared memory
# (csrc/forkchoice.cu FC_SMEM_ROWS); above it they use global scratch.
SMEM_ROWS = 8192
ROW_CHUNK = 1024  # rows a plain subtree pass unpacks at once


def n_words(b: int) -> int:
    return (b + 31) // 32


def doubling_levels(b: int) -> int:
    """ceil(log2 b): the doubling steps that saturate any chain of b blocks."""
    return (b - 1).bit_length() if b > 1 else 0


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(Q, B, C) bool -> (Q, B, ceil(C/32)) int32 bitsets (bit k of word w is
    column 32 w + k)."""
    q, b, c = mask.shape
    w = n_words(c)
    padded = torch.zeros((q, b, 32 * w), dtype=torch.bool, device=mask.device)
    padded[..., :c] = mask
    acc = torch.zeros((q, b, w), dtype=torch.int64, device=mask.device)
    for k in range(32):
        acc |= padded[..., k::32].to(torch.int64) << k
    return words_i32(acc)


def unpack_bits(words: torch.Tensor, c: int) -> torch.Tensor:
    """(Q, R, W) int32 bitsets -> (Q, R, c) bool."""
    q, r, w = words.shape
    w64 = words.to(torch.int64) & MASK32
    out = torch.empty((q, r, 32 * w), dtype=torch.bool, device=words.device)
    for k in range(32):
        out[..., k::32] = ((w64 >> k) & 1).bool()
    return out[..., :c]


# --- the plain versions ------------------------------------------------------


def ancestors_plain(parent: torch.Tensor) -> torch.Tensor:
    """K15's function: pointer doubling from the identity, ceil(log2 B)
    steps of anc |= anc[jump]; jump = jump[jump]."""
    q, b = parent.shape
    dev = parent.device
    anc = torch.eye(b, dtype=torch.bool, device=dev).expand(q, b, b).clone()
    jump = parent.to(torch.int64)
    rows = torch.arange(q, device=dev)[:, None]
    for _ in range(doubling_levels(b)):
        anc = anc | anc[rows, jump]
        jump = torch.gather(jump, 1, jump)
    return pack_bits(anc)


def vote_weights_plain(votes: torch.Tensor, balances: torch.Tensor, b: int) -> torch.Tensor:
    """K16's function: direct[q, c] = sum of balances[q, k] over votes[q, k]
    == c (votes outside [0, b) match nothing)."""
    q = votes.shape[0]
    v = votes.to(torch.int64)
    live = (v >= 0) & (v < b)
    out = torch.zeros((q, b + 1), dtype=torch.int64, device=votes.device)
    out.scatter_add_(1, torch.where(live, v, b), torch.where(live, balances, 0))
    return out[:, :b].contiguous()


def _leaf_ok(parent, ck_epochs, ck_rids, is_real, idx_scalars, ep_scalars) -> torch.Tensor:
    """filter_block_tree's leaf rule: a real block with no real child other
    than itself whose checkpoints agree with the store's (GENESIS_EPOCH
    short-circuits each)."""
    q, b = parent.shape
    par = parent.to(torch.int64)
    idx = torch.arange(b, device=parent.device)
    child = is_real & (par != idx) & (par >= 0) & (par < b)
    has_child = torch.zeros((q, b + 1), dtype=torch.int64, device=parent.device)
    has_child.scatter_add_(1, torch.where(child, par, b), torch.ones_like(par))
    sje, sfe, ge = ep_scalars[:, 0:1], ep_scalars[:, 1:2], ep_scalars[:, 2:3]
    sjr, sfr = idx_scalars[:, 2:3], idx_scalars[:, 3:4]
    ok_just = (sje == ge) | ((ck_epochs[..., 0] == sje) & (ck_rids[..., 0] == sjr))
    ok_fin = (sfe == ge) | ((ck_epochs[..., 1] == sfe) & (ck_rids[..., 1] == sfr))
    return (has_child[:, :b] == 0) & is_real & ok_just & ok_fin


def subtree_plain(anc: torch.Tensor, direct: torch.Tensor, parent: torch.Tensor,
                  ck_epochs: torch.Tensor, ck_rids: torch.Tensor, is_real: torch.Tensor,
                  idx_scalars: torch.Tensor, ep_scalars: torch.Tensor) -> tuple:
    """K17's function: (weight, viable). weight[c] = sum of direct[i] over
    the rows i whose bitset holds c, plus boost_weight where the boost
    block's bitset holds c; viable[c] = some leaf_ok row i holds c."""
    q, b = parent.shape
    leaf_ok = _leaf_ok(parent, ck_epochs, ck_rids, is_real, idx_scalars, ep_scalars)
    weight = torch.zeros((q, b), dtype=torch.int64, device=parent.device)
    viable = torch.zeros((q, b), dtype=torch.bool, device=parent.device)
    for i0 in range(0, b, ROW_CHUNK):
        rows = unpack_bits(anc[:, i0:i0 + ROW_CHUNK], b)
        weight += torch.where(rows, direct[:, i0:i0 + ROW_CHUNK, None], 0).sum(1)
        viable |= (rows & leaf_ok[:, i0:i0 + ROW_CHUNK, None]).any(1)
    boost = idx_scalars[:, 1].to(torch.int64)
    on = (boost >= 0) & (boost < b)
    boost_row = unpack_bits(anc[torch.arange(q, device=anc.device), boost.clamp(0, b - 1)][:, None],
                            b)[:, 0]
    weight += torch.where(on[:, None] & boost_row, ep_scalars[:, 3:4], 0)
    return weight, viable


def head_walk_plain(anc: torch.Tensor, weight: torch.Tensor, viable: torch.Tensor,
                    parent: torch.Tensor, root_words: torch.Tensor, is_real: torch.Tensor,
                    idx_scalars: torch.Tensor) -> tuple:
    """K18's function: (filtered, head). The JAX walk step for step: from the
    justified block, the filtered children's mask refined by weight (against
    a -1 floor), then each root word, the lowest index of what is left (0 of
    an empty mask, as argmax); at most B steps, ending early once no
    snapshot's head has a child."""
    q, b = parent.shape
    dev = parent.device
    j = idx_scalars[:, 0].to(torch.int64)
    word = torch.gather(anc, 2, (j // 32)[:, None, None].expand(q, b, 1))[..., 0]
    in_just = (((word.to(torch.int64) & MASK32) >> (j % 32)[:, None]) & 1).bool()
    filtered = viable & is_real & in_just
    par = parent.to(torch.int64)
    idx = torch.arange(b, device=dev)
    head = j.clone()
    for _ in range(b):
        kids = (par == head[:, None]) & (idx != head[:, None]) & filtered
        has = kids.any(1)
        if not bool(has.any()):
            break
        m = kids & (weight == torch.where(kids, weight, -1).max(1, keepdim=True).values)
        for t in range(8):
            wt = root_words[..., t]
            m = m & (wt == torch.where(m, wt, 0).max(1, keepdim=True).values)
        head = torch.where(has, m.to(torch.uint8).argmax(1), head)
    return filtered, head.to(torch.int32)


# --- the kernels -------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, dev) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _ancestors_kernel(parent: torch.Tensor) -> torch.Tensor:
    q, b = parent.shape
    parent = _check("parent", parent, torch.int32, (q, b), parent.device)
    out = torch.empty((q, b, n_words(b)), dtype=torch.int32, device=parent.device)
    scratch = (None if b <= SMEM_ROWS else
               torch.empty(16 * b * n_words(b) * q, dtype=torch.uint8, device=parent.device))
    fn = build.entry("forkchoice", "fc_ancestors", 3, 1)
    build.count_launch("fc_ancestors")
    build.check(fn(parent.data_ptr(), out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), q, b,
                   build.stream_ptr(out)), "fc_ancestors")
    return out


def _vote_weights_kernel(votes: torch.Tensor, balances: torch.Tensor, b: int) -> torch.Tensor:
    q, v = votes.shape
    dev = votes.device
    votes = _check("votes", votes, torch.int32, (q, v), dev)
    balances = _check("balances", balances, torch.int64, (q, v), dev)
    out = torch.zeros((q, b), dtype=torch.int64, device=dev)
    fn = build.entry("forkchoice", "fc_vote_weights", 3, 2)
    build.count_launch("fc_vote_weights")
    build.check(fn(votes.data_ptr(), balances.data_ptr(), out.data_ptr(), q, v, b,
                   build.stream_ptr(out)), "fc_vote_weights")
    return out


def _subtree_kernel(anc, direct, parent, ck_epochs, ck_rids, is_real, idx_scalars,
                    ep_scalars) -> tuple:
    q, b = parent.shape
    dev = parent.device
    args = [_check("anc", anc, torch.int32, (q, b, n_words(b)), dev),
            _check("direct", direct, torch.int64, (q, b), dev),
            _check("parent", parent, torch.int32, (q, b), dev),
            _check("ck_epochs", ck_epochs, torch.int64, (q, b, 2), dev),
            _check("ck_rids", ck_rids, torch.int32, (q, b, 2), dev),
            _check("is_real", is_real, torch.bool, (q, b), dev),
            _check("idx_scalars", idx_scalars, torch.int32, (q, 4), dev),
            _check("ep_scalars", ep_scalars, torch.int64, (q, 4), dev)]
    weight = torch.zeros((q, b), dtype=torch.int64, device=dev)
    viable = torch.zeros((q, b), dtype=torch.bool, device=dev)
    fn = build.entry("forkchoice", "fc_subtree", 10, 1)
    build.count_launch("fc_subtree")
    build.check(fn(*(t.data_ptr() for t in args), weight.data_ptr(), viable.data_ptr(), q, b,
                   build.stream_ptr(weight)), "fc_subtree")
    return weight, viable


def _head_walk_kernel(anc, weight, viable, parent, root_words, is_real, idx_scalars) -> tuple:
    q, b = parent.shape
    dev = parent.device
    args = [_check("anc", anc, torch.int32, (q, b, n_words(b)), dev),
            _check("weight", weight, torch.int64, (q, b), dev),
            _check("viable", viable, torch.bool, (q, b), dev),
            _check("parent", parent, torch.int32, (q, b), dev),
            _check("root_words", root_words, torch.int64, (q, b, 8), dev),
            _check("is_real", is_real, torch.bool, (q, b), dev),
            _check("idx_scalars", idx_scalars, torch.int32, (q, 4), dev)]
    filtered = torch.empty((q, b), dtype=torch.bool, device=dev)
    head = torch.empty(q, dtype=torch.int32, device=dev)
    scratch = (None if b <= SMEM_ROWS else
               torch.empty(q * ((18 * b + 7) // 8 * 8), dtype=torch.uint8, device=dev))
    fn = build.entry("forkchoice", "fc_head_walk", 10, 1)
    build.count_launch("fc_head_walk")
    build.check(fn(*(t.data_ptr() for t in args), filtered.data_ptr(), head.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), q, b,
                   build.stream_ptr(head)), "fc_head_walk")
    return filtered, head


# --- the wrappers: the kernel on CUDA tensors, the plain version on CPU ones -


def ancestors(parent: torch.Tensor) -> torch.Tensor:
    """K15 on a CUDA tensor, `ancestors_plain` on a CPU tensor."""
    return ancestors_plain(parent) if is_cpu(parent) else _ancestors_kernel(parent)


def vote_weights(votes: torch.Tensor, balances: torch.Tensor, b: int) -> torch.Tensor:
    """K16 on CUDA tensors, `vote_weights_plain` on CPU tensors."""
    if is_cpu(votes):
        return vote_weights_plain(votes, balances, b)
    return _vote_weights_kernel(votes, balances, b)


def subtree(anc, direct, parent, ck_epochs, ck_rids, is_real, idx_scalars, ep_scalars) -> tuple:
    """K17 on CUDA tensors, `subtree_plain` on CPU tensors."""
    fn = subtree_plain if is_cpu(parent) else _subtree_kernel
    return fn(anc, direct, parent, ck_epochs, ck_rids, is_real, idx_scalars, ep_scalars)


def head_walk(anc, weight, viable, parent, root_words, is_real, idx_scalars) -> tuple:
    """K18 on CUDA tensors, `head_walk_plain` on CPU tensors."""
    fn = head_walk_plain if is_cpu(parent) else _head_walk_kernel
    return fn(anc, weight, viable, parent, root_words, is_real, idx_scalars)


def _stages(parent, root_words, ck_epochs, ck_rids, is_real, votes, balances, idx_scalars,
            ep_scalars, anc_fn, votes_fn, subtree_fn, walk_fn) -> dict:
    b = parent.shape[1]
    anc = anc_fn(parent)
    direct = votes_fn(votes, balances, b)
    weight, viable = subtree_fn(anc, direct, parent, ck_epochs, ck_rids, is_real, idx_scalars,
                                ep_scalars)
    filtered, head = walk_fn(anc, weight, viable, parent, root_words, is_real, idx_scalars)
    return dict(anc=anc, direct=direct, weight=weight, viable=viable, filtered=filtered,
                head=head)


def ghost_head_stages(*args) -> dict:
    """Every stage's output through the wrappers (K15-K18 on CUDA tensors)."""
    return _stages(*args, ancestors, vote_weights, subtree, head_walk)


def ghost_head_parts(*args) -> dict:
    """Every stage's output through the plain versions, on any device:
    {anc, direct, weight, viable, filtered, head}."""
    return _stages(*args, ancestors_plain, vote_weights_plain, subtree_plain, head_walk_plain)


def ghost_head(*args) -> torch.Tensor:
    """(Q,) int32 heads: K15-K18 on CUDA tensors, the plain versions on CPU
    tensors. Arguments as the module docstring lists them."""
    return ghost_head_stages(*args)["head"]


def ghost_head_plain(*args) -> torch.Tensor:
    """(Q,) int32 heads through the plain versions only, on any device."""
    return ghost_head_parts(*args)["head"]
