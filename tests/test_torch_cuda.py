"""Card-only tests of the port's CUDA kernels: each kernel bit-equal to its
plain PyTorch version on the same CUDA tensors, and each launch counted.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no JAX; there, without this repo's conftest
(which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips with its reason (decided in the fixture).
"""
import hashlib
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.crypto import bls12_381 as bls_oracle
from consensus_specs_tpu_torch.crypto import bls_torch
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch import forkchoice as tfc
from consensus_specs_tpu_torch.engine import epoch as tepoch
from consensus_specs_tpu_torch.engine import fork_choice as tfc_engine
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
from consensus_specs_tpu_torch.ops import bls12 as tbls
from consensus_specs_tpu_torch.forkchoice import synthetic as tfc_synthetic
from consensus_specs_tpu_torch.ops import forkchoice as tfc_ops
from consensus_specs_tpu_torch.ops import fp as tfp
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


# --- the BLS kernels (K8-K12) ---------------------------------------------------------


def _counted(name):
    """Context: the test body must launch kernel `name` exactly once."""
    class _Count:
        def __enter__(self):
            self.before = build.LAUNCHES[name]

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            assert exc[0] is not None or build.LAUNCHES[name] == self.before + 1
            return False
    return _Count()


def _bls_items(n, messages, seed):
    """n (pk, H(m), sig) Montgomery words on the CPU over `messages` messages,
    and the oracle's points."""
    rng = np.random.default_rng(seed)
    F1, F2 = bls_oracle.FP_FIELD, bls_oracle.FP2_FIELD
    ks = [int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)]
    hs = [hash_to_curve_g2(b"card %d" % (i % messages)) for i in range(n)]
    pks = [bls_oracle.pt_to_affine(F1, bls_oracle.pt_mul(F1, bls_oracle.G1_GEN, k)) for k in ks]
    sigs = [bls_oracle.pt_to_affine(F2, bls_oracle.pt_mul(F2, bls_oracle.pt_from_affine(F2, h), k))
            for h, k in zip(hs, ks)]
    return tbls.g1_to_words(pks), tbls.g2_to_words(hs), tbls.g2_to_words(sigs)


@pytest.mark.parametrize("op", range(7))
@pytest.mark.parametrize("m", [1, 130])
def test_fp_ops_kernel_matches_plain(cuda, op, m):
    rng = np.random.default_rng(op + m)
    vals = [int.from_bytes(rng.bytes(48), "little") % tfp.P for _ in range(2 * m)]
    vals[:2] = [0, tfp.P - 1] if m > 1 else vals[:2]
    w = torch.from_numpy(tfp.ints_to_words(vals))
    a, b = w[:m], w[m:]
    binary = op in tfp._BINARY
    with _counted("fp_ops"):
        got = tfp.fp_ops(op, a.to(cuda), b.to(cuda) if binary else None)
    assert torch.equal(got.cpu(), tfp.fp_ops_plain(op, a, b if binary else None))


def test_to_mont_words_on_card(cuda):
    vals = [0, 1, tfp.P - 1, 12345]
    got = tfp.to_mont_words(torch.from_numpy(tfp.ints_to_words(vals)).to(cuda))
    assert tfp.words_to_ints(got) == [tfp.to_mont(v) for v in vals]


@pytest.mark.parametrize("affine", [True, False])
def test_rlc_ladders_kernel_matches_plain(cuda, affine):
    p, _, s = _bls_items(6, 6, 1)
    zb = bls_torch.zbits_from_ints([0, 1, 2, 2**64 - 1, 2**32, 987654321987654321])
    with _counted("rlc_ladders"):
        got = tbls.rlc_ladders(p.to(cuda), s.to(cuda), zb.to(cuda), affine)
    for g, w in zip(got, tbls.rlc_ladders_plain(p, s, zb, affine)):
        assert torch.equal(g.cpu(), w)
    g1_only = tbls.rlc_ladders(p.to(cuda), None, zb.to(cuda), affine)
    assert g1_only[1] is None and torch.equal(g1_only[0], got[0])


@pytest.mark.parametrize("g2", [False, True])
def test_point_sums_kernel_matches_plain(cuda, g2):
    p, _, s = _bls_items(70, 70, 2)
    zb = bls_torch.zbits_from_ints(list(range(1, 71)))
    g1, g2j = tbls.rlc_ladders_plain(p, s, zb, affine_g1=False)
    pts = g2j if g2 else g1
    off = torch.tensor([0, 70] if g2 else [0, 3, 3, 68, 70])  # an empty segment, one of 65
    with _counted("point_sums"):
        got = tbls.point_sums(pts.to(cuda), off.to(cuda))
    assert torch.equal(got.cpu(), tbls.point_sums_plain(pts, off))


def test_miller_and_final_exp_kernels_match_plain(cuda):
    p, q, s = _bls_items(5, 5, 3)
    with _counted("miller_loop"):
        m = tbls.miller_loop(q.to(cuda), p.to(cuda))
    mp = tbls.miller_loop_plain(q, p)
    assert torch.equal(m.cpu(), mp)
    with _counted("final_exp"):
        cube, ok = tbls.final_exp_batch(m[:2], m[2:4])
    wc, wok = tbls.final_exp_batch_plain(mp[:2], mp[2:4])
    assert torch.equal(cube.cpu(), wc) and torch.equal(ok.cpu(), wok)
    with _counted("final_exp"):
        cube, ok = tbls.final_exp_tail(m[:-1], m[-1])
    wc, wok = tbls.final_exp_tail_plain(mp[:-1], mp[-1])
    assert torch.equal(cube.cpu(), wc) and bool(ok) == bool(wok)


@pytest.mark.parametrize("grouped", [False, True])
def test_pairing_check_rlc_on_card(cuda, grouped):
    """Both randomized-check paths on the card: a valid batch passes, a bad
    signature fails, an empty segment fails; the batch check flags the bad
    item."""
    p, q, s = _bls_items(12, 3 if grouped else 12, 4)
    zb = bls_torch.zbits_from_ints(np.random.default_rng(5).integers(1, 2**63, 12))
    seg = torch.tensor([i % 3 for i in range(12)], device=cuda) if grouped else None
    reps = q[:3] if grouped else q
    args = (reps.to(cuda), p.to(cuda))
    assert bool(tbls.pairing_check_rlc(*args, s.to(cuda), zb.to(cuda), seg))
    bad = s.clone()
    bad[7] = s[6]
    assert not bool(tbls.pairing_check_rlc(*args, bad.to(cuda), zb.to(cuda), seg))
    if grouped:
        extra = torch.cat([reps, q[:1]]).to(cuda)  # a fourth message, no member
        assert not bool(tbls.pairing_check_rlc(extra, p.to(cuda), s.to(cuda), zb.to(cuda), seg))
    neg = tbls.neg_g1_words(cuda)[None].expand(12, 2, 12).contiguous()
    ok = tbls.pairing_check_batch(q.to(cuda), p.to(cuda), bad.to(cuda), neg)
    assert ok.cpu().tolist() == [i != 7 for i in range(12)]


def test_run_checks_on_card(cuda):
    """The flush on the card: 20 checks take the randomized path; one bad
    signature is attributed to its index."""
    p, q, s = _bls_items(20, 20, 6)
    pts = tbls.affine_from_words(p, False)
    hs = tbls.affine_from_words(q, True)
    sigs = tbls.affine_from_words(s, True)
    checks = [bls_torch.QueuedCheck(a, h, bls_torch._NEG_G1, g) for a, h, g in zip(pts, hs, sigs)]
    assert bls_torch.run_checks(checks, cuda).all()
    assert bls_torch.LAST_FLUSH["path"] == "rlc"
    checks[13] = bls_torch.QueuedCheck(pts[13], hs[13], bls_torch._NEG_G1, sigs[12])
    assert np.flatnonzero(~bls_torch.run_checks(checks, cuda)).tolist() == [13]


def test_bls_stack_limit_covers_the_kernels(cuda):
    """The stack limit the BLS entries set holds K12's 10,160 bytes of
    cumulative stack (ptxas) and is never lowered."""
    limit = tbls.stack_limit()
    assert 10_160 <= limit < 16_384
    assert tbls.stack_limit() == limit


def _msm_items(n, nbits, seed):
    """n seeded Jacobian points (a repeated point and a P + (-P) pair among
    them) and scalars with 0, 1 and 2^64 - 1, as words on the CPU."""
    rng = np.random.default_rng(seed)
    F1 = bls_oracle.FP_FIELD
    ks = [int(k) for k in rng.integers(1, 2**62, n - 3, dtype=np.int64)]
    pts = [bls_oracle.pt_to_affine(F1, bls_oracle.pt_mul(F1, bls_oracle.G1_GEN, k)) for k in ks]
    pts += [pts[0], pts[1], (pts[1][0], (-pts[1][1]) % bls_oracle.P)]
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    scalars[:3] = [0, 1, 2**64 - 1]
    scalars[-2] = scalars[-1]  # the cancelling pair
    return tbls._jacobian_words(pts, 0, "cpu"), tbls.scalar_words(scalars, nbits)


@pytest.mark.parametrize("nbits,window", [(64, 4), (255, 4), (64, 3), (255, 5), (255, 8)])
@pytest.mark.parametrize("n", [8, 100])
def test_g1_msm_kernel_matches_plain(cuda, n, nbits, window):
    pts, sc = _msm_items(n, nbits, n + nbits + window)
    with _counted("g1_msm"):
        got = tbls.g1_msm(pts.to(cuda), sc.to(cuda), nbits, window)
    assert torch.equal(got.cpu(), tbls.g1_msm_plain(pts, sc, nbits, window))


def test_g1_msm_kernel_identity(cuda):
    pts, _ = _msm_items(8, 64, 1)
    got = tbls.g1_msm(pts.to(cuda), tbls.scalar_words([0] * 8, 64).to(cuda), 64)
    assert torch.equal(got.cpu(), torch.zeros((2, 12), dtype=torch.int32))


def test_g1_subgroup_kernel_matches_plain(cuda):
    pts, _ = _msm_items(10, 64, 2)
    pts = torch.cat([pts, tbls._jacobian_words([(0, 2)], 2, "cpu")])  # (0, 2) and two pads
    with _counted("g1_subgroup"):
        got = tbls.g1_subgroup_check(pts.to(cuda))
    want = tbls.g1_subgroup_check_plain(pts)
    assert torch.equal(got.cpu(), want) and want.tolist() == [True] * 10 + [False, True, True]


def test_device_key_aggregation_on_card(cuda):
    """A cold committee of 40 keys: one K14 and one K10 launch, the sum equal
    to the oracle's; again: the committee cache, no launch."""
    sks = [int(k) for k in np.random.default_rng(9).integers(1, 2**62, 40, dtype=np.int64)]
    pks = [bls_oracle.g1_to_bytes(bls_oracle.pt_to_affine(
        bls_oracle.FP_FIELD, bls_oracle.pt_mul(bls_oracle.FP_FIELD, bls_oracle.G1_GEN, k)))
        for k in sks]
    want = bls_oracle.pt_to_affine(bls_oracle.FP_FIELD, bls_oracle.pt_mul(
        bls_oracle.FP_FIELD, bls_oracle.G1_GEN, sum(sks) % bls_oracle.R))
    bls_torch.clear_caches()
    before = dict(build.LAUNCHES)
    assert bls_torch._aggregate_pubkeys_affine(pks, cuda) == want
    assert build.LAUNCHES["g1_subgroup"] == before["g1_subgroup"] + 1
    assert build.LAUNCHES["point_sums"] == before["point_sums"] + 1
    before = dict(build.LAUNCHES)
    assert bls_torch._aggregate_pubkeys_affine(pks, cuda) == want
    assert build.LAUNCHES == before
    bls_torch.clear_caches()
    assert bls_torch._aggregate_pubkeys_device_impl(
        pks[:39] + [bls_oracle.g1_to_bytes((0, 2))], cuda) == (
        "bad_encoding", "G1 point not in r-subgroup")
    bls_torch.clear_caches()


# --- the fork-choice head (K15-K18) ---------------------------------------------------

FC_KERNELS = ("fc_ancestors", "fc_vote_weights", "fc_subtree", "fc_head_walk")


def _fc_mirror(seed, nb, nv):
    """A seeded random tree in the port's StoreMirror: random branching (so a
    shallow tree), mixed per-block checkpoints (some leaves disagree with the
    store), 16-32 ETH balances, 70 % participation, a boost on odd seeds."""
    rng = random.Random(seed)
    m = tfc.StoreMirror()
    anchor = rng.randbytes(32)
    ck = (0, anchor)
    m.add_block(anchor, anchor, 0, justified=ck, finalized=ck)
    roots, slots = [anchor], {anchor: 0}
    for _ in range(nb - 1):
        parent = roots[rng.randrange(len(roots))]
        root = rng.randbytes(32)
        slots[root] = slots[parent] + rng.randrange(1, 3)
        jc = ck if rng.random() < 0.8 else (1, roots[0])
        m.add_block(root, parent, slots[root], justified=jc, finalized=ck)
        roots.append(root)
    nprng = np.random.default_rng(seed)
    m.set_registry(nprng.integers(16, 33, nv, dtype=np.int64) * 10**9)
    for k in range(min(nb, 64)):  # every vote on one of 64 random blocks
        pick = np.flatnonzero(nprng.integers(0, 64, nv) == k)
        pick = pick[nprng.random(pick.size) < 0.7]
        m.set_votes(pick, roots[rng.randrange(len(roots))])
    m.set_checkpoints((seed % 2, anchor), ck)
    if seed % 2:
        m.set_boost(roots[rng.randrange(len(roots))], 3 * 10**11)
    return m


def _fc_cases(case):
    if case.startswith("storm"):
        storm = tfc_synthetic.build_storm(int(case[5:]), 1 << 16)
        return [storm.mirror.snapshot()] + storm.perturbed(2, 3)
    nb, nv = (int(x) for x in case.split("x"))
    return [_fc_mirror(seed, nb, nv).snapshot() for seed in range(3)]


@pytest.mark.parametrize("case", ["5x40", "300x5000", "storm512", "8000x65536", "storm8192",
                                  "9000x4096"])
def test_forkchoice_kernels_match_plain(cuda, case):
    """K15-K18 each bit-equal to its plain version on the card, on the same
    inputs (B = 8, 512, 8192 and 16384, the last through global scratch);
    votes outside [0, B) are skipped; heads = the host oracle's."""
    snaps = _fc_cases(case)
    [(_, members, batch)] = tfc_engine.group_tensors(snaps, cuda)
    parent, root_words, ck_epochs, ck_rids, is_real, votes, balances, idx_s, ep_s = batch
    votes[0, :3] = torch.tensor([-1, -7, parent.shape[1] + 3], dtype=torch.int32)
    want = tfc_ops.ghost_head_parts(*batch)
    b = parent.shape[1]
    with _counted("fc_ancestors"):
        anc = tfc_ops.ancestors(parent)
    with _counted("fc_vote_weights"):
        direct = tfc_ops.vote_weights(votes, balances, b)
    with _counted("fc_subtree"):
        weight, viable = tfc_ops.subtree(anc, direct, parent, ck_epochs, ck_rids, is_real, idx_s,
                                         ep_s)
    with _counted("fc_head_walk"):
        filtered, head = tfc_ops.head_walk(anc, weight, viable, parent, root_words, is_real,
                                           idx_s)
    for name, got in (("anc", anc), ("direct", direct), ("weight", weight),
                      ("viable", viable), ("filtered", filtered), ("head", head)):
        assert torch.equal(got, want[name]), name
    heads = tfc_engine.ghost_head_batch(snaps[1:], cuda)
    assert heads.tolist() == [tfc.host_head(s) for s in snaps[1:]]
    assert len(members) == len(snaps)


def test_forkchoice_batch_launches_once_a_kernel(cuda):
    """One ghost_head_batch over three snapshots of one bucket: one launch of
    each of K15-K18; two buckets: two of each."""
    snaps = [_fc_mirror(seed, 40, 300).snapshot() for seed in range(3)]
    before = dict(build.LAUNCHES)
    heads = tfc_engine.ghost_head_batch(snaps, cuda)
    assert {k: build.LAUNCHES[k] - before[k] for k in FC_KERNELS} == dict.fromkeys(FC_KERNELS, 1)
    assert heads.tolist() == [tfc.host_head(s) for s in snaps]
    snaps.append(_fc_mirror(7, 200, 300).snapshot())
    before = dict(build.LAUNCHES)
    heads = tfc_engine.ghost_head_batch(snaps, cuda)
    assert {k: build.LAUNCHES[k] - before[k] for k in FC_KERNELS} == dict.fromkeys(FC_KERNELS, 2)
    assert heads.tolist() == [tfc.host_head(s) for s in snaps]


def test_forkchoice_kernels_check_their_inputs(cuda):
    parent = torch.arange(8, dtype=torch.int64, device=cuda)[None]
    with pytest.raises(ValueError):
        tfc_ops.ancestors(parent)
    votes = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tfc_ops.vote_weights(votes, torch.zeros((1, 64), dtype=torch.int32, device=cuda), 8)
