"""Card-only tests of the port's CUDA kernels: each kernel bit-equal to its
plain PyTorch version on the same CUDA tensors, and each launch counted.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX; there, without this repo's conftest
(which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips with its reason (decided in the fixture).
"""
import hashlib

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.engine import epoch as tepoch
from consensus_specs_tpu_torch.engine import incremental_root as tinc
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.engine import sync_committee as tsync
from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy
from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop
from consensus_specs_tpu_torch.engine.state import EpochConfig
from consensus_specs_tpu_torch.engine.synthetic import (
    EDGE_STATES,
    edge_epoch_state_numpy,
    synthetic_epoch_state_numpy,
)
from consensus_specs_tpu_torch.kernels import build
from consensus_specs_tpu_torch.ops import sha256 as tsha
from consensus_specs_tpu_torch.ops import shuffle as tshuffle
from consensus_specs_tpu_torch.ops.sha256_host import words_to_bytes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _dev(words, dev):
    return torch.from_numpy(words.view(np.int32).copy()).to(dev)


CASES = {"synthetic": synthetic_epoch_state_numpy, **EDGE_STATES}


@pytest.mark.parametrize("m", [1, 3, 4096, 70_001])
def test_sha256_kernel_matches_plain(cuda, m):
    w = _words((m, 16), m)
    w[-1] = 0xFFFFFFFF
    w[0] = 0
    x = _dev(w, cuda)
    before = build.LAUNCHES["sha256_64b"]
    out = tsha.sha256_64B_words(x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sha256_64b"] == before + 1
    assert torch.equal(out, tsha.sha256_64B_words_plain(x))
    assert words_to_bytes(out[0].cpu().numpy()) == hashlib.sha256(b"\x00" * 64).digest()


def test_sha256_kernel_takes_unaligned_views(cuda):
    w = _dev(_words((65, 16), 1), cuda).reshape(-1)[16:].reshape(64, 16)
    assert torch.equal(tsha.sha256_64B_words(w), tsha.sha256_64B_words_plain(w))
    odd = _dev(_words((1, 20), 2), cuda)[0, 1:17]  # 4-byte offset
    assert torch.equal(tsha.sha256_64B_words(odd), tsha.sha256_64B_words_plain(odd))


def test_sha256_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        tsha.sha256_64B_words(torch.zeros((4, 15), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        tsha.sha256_64B_words(torch.zeros((4, 16), dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_validator_roots_kernel_matches_plain(cuda, n):
    cfg = EpochConfig.altair_mainnet()
    st = epoch_state_from_numpy(edge_epoch_state_numpy(cfg, "ejections_and_queue", n, 7), cuda)
    s01 = _dev(_words((n, 16), n), cuda)
    before = build.LAUNCHES["validator_roots"]
    out = troot.validator_roots(s01, st)
    torch.cuda.synchronize()
    assert build.LAUNCHES["validator_roots"] == before + 1
    assert torch.equal(out, troot.validator_roots_plain(s01, st))


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_kernel_matches_plain(cuda, case, preset):
    cfg = getattr(EpochConfig, f"bellatrix_{preset}")()
    st = epoch_state_from_numpy(CASES[case](cfg, 4096, seed=5), cuda)
    ref, ref_aux = tepoch.process_epoch_plain(cfg, st)
    before = build.LAUNCHES["epoch_sweep"]
    out, aux = tepoch.make_epoch_fn(cfg)(st)
    torch.cuda.synchronize()
    assert out is st and build.LAUNCHES["epoch_sweep"] == before + 1
    for name, t in out.items():
        assert torch.equal(t, getattr(ref, name)), name
    assert torch.equal(aux.flat(), ref_aux.flat())


def test_field_roots_on_card_match_plain(cuda):
    cfg = EpochConfig.altair_mainnet()
    st = epoch_state_from_numpy(synthetic_epoch_state_numpy(cfg, 3000, 3), cuda)
    s01 = _dev(_words((3000, 16), 4), cuda)
    got = troot.field_roots(st, s01)
    ref = troot.field_roots_plain(st, s01)
    assert got.keys() == ref.keys() == troot.DEVICE_FIELDS
    for k in got:
        assert torch.equal(got[k], ref[k]), k


def test_resident_loop_on_card_matches_cpu(cuda):
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, 4096, seed=4, epoch=100)
    build.reset_launches()
    on_card = ResidentEpochLoop(cfg, epoch_state_from_numpy(d, "cpu"), device=cuda)
    on_card.run_epochs(9)
    on_card.flush()
    assert build.LAUNCHES["epoch_sweep"] == 9 and build.LAUNCHES["sha256_64b"] > 0
    on_cpu = ResidentEpochLoop(cfg, epoch_state_from_numpy(d, "cpu"), device="cpu")
    on_cpu.run_epochs(9)
    on_cpu.flush()
    for name, t in on_card.state.items():
        assert torch.equal(t.cpu(), getattr(on_cpu.state, name)), name
    np.testing.assert_array_equal(on_card.dirty, on_cpu.dirty)
    assert [r.cpu().tolist() for r in on_card.historical_roots] == \
        [r.tolist() for r in on_cpu.historical_roots]
    assert (on_card.eth1_votes_resets, on_card.sync_committee_updates) == (2, 1)
    assert torch.equal(on_card.next_sync_committee.cpu(), on_cpu.next_sync_committee)
    assert build.LAUNCHES["shuffle_rounds"] == 1 and build.LAUNCHES["sha256_1block"] >= 4


@pytest.mark.parametrize("m", [1, 3, 4096, 70_001])
def test_sha256_1block_kernel_matches_plain(cuda, m):
    w = _words((m, 16), m + 1)
    w[0] = 0
    w[0, 0] = 0x80000000  # the padded empty message
    x = _dev(w, cuda)
    before = build.LAUNCHES["sha256_1block"]
    out = tsha.sha256_1block(x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sha256_1block"] == before + 1
    assert torch.equal(out, tsha.sha256_1block_plain(x))
    assert words_to_bytes(out[0].cpu().numpy()) == hashlib.sha256(b"").digest()


@pytest.mark.parametrize("rounds", [10, 90])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 65_537])
def test_shuffle_kernel_matches_plain_and_host_twin(cuda, n, rounds):
    seed = hashlib.sha256(n.to_bytes(4, "little")).digest()
    words = tshuffle.seed_words_tensor(seed, cuda)
    before = build.LAUNCHES["shuffle_rounds"]
    got = tshuffle.shuffled_index_map(n, words, rounds)
    torch.cuda.synchronize()
    assert build.LAUNCHES["shuffle_rounds"] == before + 1
    assert torch.equal(got, tshuffle.shuffled_index_map_plain(n, words, rounds))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  tshuffle.compute_shuffled_indices_np(n, seed, rounds))


def test_sync_committee_on_card_matches_plain(cuda):
    cfg = EpochConfig.altair_mainnet()
    rng = np.random.default_rng(5)
    eff = torch.from_numpy(rng.integers(0, 33, 50_000) * 10**9).to(cuda)
    active = torch.from_numpy(np.sort(rng.choice(50_000, 40_000, replace=False))).to(cuda)
    seed = tshuffle.seed_words_tensor(b"\x33" * 32, cuda)
    kw = dict(sync_committee_size=cfg.sync_committee_size,
              max_effective_balance=cfg.max_effective_balance,
              shuffle_round_count=cfg.shuffle_round_count)
    got = tsync.next_sync_committee_indices(active, eff, seed, **kw)
    assert torch.equal(got, tsync.next_sync_committee_indices_plain(active, eff, seed, **kw))
    assert got.shape == (cfg.sync_committee_size,)


def _perturbed_cache(st, dirty: int, seed: int):
    """(copies of the six registry columns with `dirty` random rows changed,
    those rows)."""
    cols = [c.clone() for c in troot.registry_columns(st)]
    rows = torch.from_numpy(np.random.default_rng(seed).choice(
        st.num_validators, dirty, replace=False)).to(st.device)
    for j in range(6):
        pick = rows[j::6]
        cols[j][pick] = ~cols[j][pick] if cols[j].dtype == torch.bool else cols[j][pick] ^ 1
    return tuple(cols), rows


@pytest.mark.parametrize("dirty", [0, 7, 1024, 3000])
def test_dirty_scan_kernel_matches_plain(cuda, dirty):
    cfg = EpochConfig.altair_mainnet()
    st = epoch_state_from_numpy(synthetic_epoch_state_numpy(cfg, 20_000, 6), cuda)
    fresh = troot.registry_columns(st)
    cache_k, rows = _perturbed_cache(st, dirty, dirty)
    cache_p = tuple(c.clone() for c in cache_k)
    before = build.LAUNCHES["dirty_scan"]
    count, idx = tinc.dirty_scan(fresh, cache_k)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dirty_scan"] == before + 1
    pcount, pidx = tinc.dirty_scan_plain(fresh, cache_p)
    assert int(count[0]) == int(pcount[0]) == dirty
    take = min(dirty, tinc.MAX_DIRTY_VALIDATORS)
    if dirty <= tinc.MAX_DIRTY_VALIDATORS:
        assert torch.equal(torch.sort(idx[:take]).values, pidx[:take])
    else:  # the first cap slots: distinct dirty rows, in no fixed order
        assert torch.unique(idx[:take]).shape[0] == take
        assert bool(torch.isin(idx[:take], rows).all())
    for a, b, f in zip(cache_k, cache_p, fresh):
        assert torch.equal(a, b) and torch.equal(a, f)


@pytest.mark.parametrize("k", [1, 33, 1024])
def test_path_fold_kernel_matches_plain(cuda, k):
    cfg = EpochConfig.altair_mainnet()
    n = 5000
    st = epoch_state_from_numpy(synthetic_epoch_state_numpy(cfg, n, 7), cuda)
    s01 = _dev(_words((n, 16), 8), cuda)
    rng = np.random.default_rng(k)
    idx = torch.from_numpy(rng.integers(0, n, k)).to(cuda)  # duplicates included
    cases = [(lambda: tinc.build_tree_levels(troot.validator_roots(s01, st)),
              dict(mode=tinc.FOLD_VALIDATORS, validators=(s01, troot.registry_columns(st)))),
             (lambda: tinc.build_tree_levels(st.randao_mixes),
              dict(mode=tinc.FOLD_ROWS, src=torch.flip(st.randao_mixes, [0]).contiguous())),
             (lambda: tinc.build_tree_levels(troot._u64_chunk_words(st.slashings)),
              dict(mode=tinc.FOLD_U64_CHUNKS, src=st.slashings.flip(0).contiguous()))]
    for make, kw in cases:
        a, b = make(), make()
        width = a.level(0).shape[0]
        at = idx % width if kw["mode"] != tinc.FOLD_VALIDATORS else idx
        before = build.LAUNCHES["path_fold"]
        tinc.path_fold(a, at, **kw)
        torch.cuda.synchronize()
        assert build.LAUNCHES["path_fold"] == before + 1
        tinc.path_fold_plain(b, at, **kw)
        assert torch.equal(a.buf, b.buf), kw["mode"]
    levels = tinc.build_tree_levels(st.state_roots)
    node = _dev(_words((1, 8), 9), cuda)[0]
    tinc.path_update(levels, 5, node)
    st.state_roots[5] = node
    assert torch.equal(levels.buf, tinc.build_tree_levels(st.state_roots).buf)


def test_device_roots_on_card_match_field_roots(cuda):
    """The loop's Merkle cache on the card over a rotation: roots equal to
    field_roots and field_roots_plain at every refresh, both branches."""
    cfg = EpochConfig.altair_minimal()
    n = 4096
    d = synthetic_epoch_state_numpy(cfg, n, seed=8, epoch=100)
    s01 = _dev(_words((n, 16), 10), cuda)
    loop = ResidentEpochLoop(cfg, epoch_state_from_numpy(d, "cpu"), device=cuda)
    branches = []
    for count in (0, 1, 3, 6):
        loop.run_epochs(count)
        roots = loop.device_roots(s01)
        branches.append(loop.root_cache.last_branch)
        for ref in (troot.field_roots(loop.state, s01), troot.field_roots_plain(loop.state, s01)):
            for key in troot.DEVICE_FIELDS:
                assert torch.equal(roots[key], ref[key]), (count, key)
    assert branches[1] == "full" and loop.sync_committee_updates == 1
