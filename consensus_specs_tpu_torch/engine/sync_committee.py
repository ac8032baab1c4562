"""Batched sync-committee sampling (counterpart of engine/sync_committee.py,
altair `get_next_sync_committee_indices`).

The spec samples with replacement: candidate i is `active[shuffled(i % n)]`,
accepted iff `effective_balance * 255 >= MAX_EFFECTIVE_BALANCE *
random_byte(i)` where `random_byte(i) = sha256(seed || u64_le(i // 32))[i %
32]`. The rejection loop has no fixed trip count, so it stays on the host
in chunks of 1024 candidates, as in the JAX package; each ingredient runs
on the device: the shuffled index map through K4 + K5 (ops/shuffle.py), the
candidate bytes through K4, the gathers and the compare in PyTorch glue.
One count crosses to the host a chunk.

The seed, `get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE)` =
sha256(domain || u64_le(epoch) || mix), is one 44-byte block through K4
(`sync_committee_seed`). The SyncCommittee's pubkeys and aggregate pubkey
need BLS and the SSZ tree; they are not computed here.
"""
from __future__ import annotations

import torch

from ..ops.sha256 import sha256_1block, sha256_1block_plain
from ..ops.shuffle import shuffled_index_map, shuffled_index_map_plain
from ..utils.u64 import MASK32, bswap32, ule, ult, words_i32, words_i64
from .state import EpochConfig, EpochState

DOMAIN_SYNC_COMMITTEE = 0x07000000  # DomainType('0x07000000') as a big-endian word
_CHUNK = 1024  # candidates evaluated per host round trip


def _u64_le_words(x: torch.Tensor) -> tuple:
    """int64 values -> the two big-endian message words of u64_le(x)."""
    return bswap32(x & MASK32), bswap32((x >> 32) & MASK32)


def sync_committee_seed(epoch: int, mix: torch.Tensor, h=sha256_1block) -> torch.Tensor:
    """(8,) int32 words of sha256(DOMAIN_SYNC_COMMITTEE || u64_le(epoch) ||
    mix) for the (8,) int32 randao mix row `mix`, on mix's device: 44
    bytes, one padded block (terminator in word 11, bit length 352)."""
    msg = torch.zeros(16, dtype=torch.int64)
    msg[0] = DOMAIN_SYNC_COMMITTEE
    msg[1], msg[2] = _u64_le_words(torch.tensor(epoch, dtype=torch.int64))
    msg[11] = 0x80000000
    msg[15] = 352
    msg = words_i32(msg).to(mix.device)
    msg[3:11] = mix
    return h(msg[None])[0]


def _candidate_random_bytes(seed_words: torch.Tensor, first_bucket: int, num_buckets: int,
                            h) -> torch.Tensor:
    """(num_buckets * 32,) int64 random bytes: the digests
    sha256(seed || u64_le(bucket)) for consecutive buckets, byte by byte.
    40-byte messages (terminator in word 10, bit length 320)."""
    dev = seed_words.device
    bucket = torch.arange(first_bucket, first_bucket + num_buckets, dtype=torch.int64,
                          device=dev)
    msg = torch.zeros((num_buckets, 16), dtype=torch.int64, device=dev)
    msg[:, :8] = words_i64(seed_words)
    msg[:, 8], msg[:, 9] = _u64_le_words(bucket)
    msg[:, 10] = 0x80000000
    msg[:, 15] = 320
    digest = words_i64(h(words_i32(msg)))  # (B, 8) big-endian words
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=dev)
    return ((digest[..., None] >> shifts) & 0xFF).reshape(-1)


def _sample(active: torch.Tensor, effective_balance: torch.Tensor, seed_words: torch.Tensor,
            size: int, max_effective_balance: int, rounds: int, h, index_map) -> torch.Tensor:
    n = active.shape[0]
    if n == 0:
        raise ValueError("sync committee sampling needs at least one active validator")
    shuffled = index_map(n, seed_words, rounds).to(torch.int64)
    dev = active.device
    out, have, i = [], 0, 0
    while have < size:
        iv = torch.arange(i, i + _CHUNK, dtype=torch.int64, device=dev)
        # i is a multiple of 32, so candidate iv's byte is byte iv - i of the chunk's digests
        random_bytes = _candidate_random_bytes(seed_words, i // 32, _CHUNK // 32, h)
        cand = active[shuffled[iv % n]]
        accept = effective_balance[cand] * 255 >= max_effective_balance * random_bytes
        taken = cand[accept]
        out.append(taken)
        have += taken.shape[0]
        i += _CHUNK
    return torch.cat(out)[:size]


def next_sync_committee_indices(active: torch.Tensor, effective_balance: torch.Tensor,
                                seed_words: torch.Tensor, *, sync_committee_size: int,
                                max_effective_balance: int,
                                shuffle_round_count: int) -> torch.Tensor:
    """(sync_committee_size,) int64 validator indices, the
    effective-balance-weighted sample with replacement, bit-identical to the
    spec's scalar loop (engine/sync_committee.py:44).

    active: (n,) int64 indices of the validators active in the target
    epoch; effective_balance: (N,) int64 registry column; seed_words: (8,)
    int32 seed words; all on one device. K4 and K5 on CUDA, their plain
    versions on the CPU."""
    return _sample(active, effective_balance, seed_words, sync_committee_size,
                   max_effective_balance, shuffle_round_count, sha256_1block,
                   shuffled_index_map)


def next_sync_committee_indices_plain(active: torch.Tensor, effective_balance: torch.Tensor,
                                      seed_words: torch.Tensor, *, sync_committee_size: int,
                                      max_effective_balance: int,
                                      shuffle_round_count: int) -> torch.Tensor:
    """`next_sync_committee_indices` through the plain versions only, on any
    device: the reference the kernels are held against on the card."""
    return _sample(active, effective_balance, seed_words, sync_committee_size,
                   max_effective_balance, shuffle_round_count, sha256_1block_plain,
                   shuffled_index_map_plain)


def sync_committee_for_state(cfg: EpochConfig, st: EpochState, next_epoch: int,
                             plain: bool = False) -> tuple:
    """(indices, n_active): the next sync committee's validator indices for
    `next_epoch`, sampled from the columns of `st` on its device
    (engine/resident.py:343 `_rotate_sync_committees_resident` of the JAX
    package, without pubkeys): the validators with activation_epoch <=
    next_epoch < exit_epoch, and the seed over the randao row
    (next_epoch + EPV - MIN_SEED_LOOKAHEAD - 1) % EPV. `plain` takes the
    plain versions of K4 and K5 on any device."""
    active = torch.nonzero(ule(st.activation_epoch, next_epoch)
                           & ult(next_epoch, st.exit_epoch)).flatten()
    epv = cfg.epochs_per_historical_vector
    mix = st.randao_mixes[(next_epoch + epv - cfg.min_seed_lookahead - 1) % epv]
    seed = sync_committee_seed(next_epoch, mix, sha256_1block_plain if plain else sha256_1block)
    sample = next_sync_committee_indices_plain if plain else next_sync_committee_indices
    indices = sample(active, st.effective_balance, seed,
                     sync_committee_size=cfg.sync_committee_size,
                     max_effective_balance=cfg.max_effective_balance,
                     shuffle_round_count=cfg.shuffle_round_count)
    return indices, active.shape[0]
