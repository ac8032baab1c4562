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
from consensus_specs_tpu_torch.crypto import bls_torch, msm_synthetic
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
from consensus_specs_tpu_torch.ops import fr as tfr
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
    # the one historical append (epoch 104) is one K19 launch (128 rows)
    assert build.LAUNCHES["epoch_sweep"] == 9 and build.LAUNCHES["tree_root_batch"] == 1
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


def _counted(name, times=1):
    """Context: the test body must launch kernel `name` exactly `times`
    times (once by default)."""
    class _Count:
        def __enter__(self):
            self.before = build.LAUNCHES[name]

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            assert exc[0] is not None or build.LAUNCHES[name] == self.before + times
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


_FP_EDGES = [0, 1, tfp.P - 1, tfp.R_MOD_P, 2, 1 << 380, tfp.P - 2, (tfp.P - 1) // 2]


@pytest.mark.parametrize("op", range(7))
@pytest.mark.parametrize("m", [1, 130])
def test_fp_ops_kernel_matches_plain(cuda, op, m):
    rng = np.random.default_rng(op + m)
    vals = [int.from_bytes(rng.bytes(48), "little") % tfp.P for _ in range(2 * m)]
    if m > 1:  # the field's edges (op 5, the divstep inverse: 0 maps to 0)
        vals[:len(_FP_EDGES)] = _FP_EDGES
    w = torch.from_numpy(tfp.ints_to_words(vals))
    a, b = w[:m], w[m:]
    binary = op in tfp._BINARY
    with _counted("fp_ops"):
        got = tfp.fp_ops(op, a.to(cuda), b.to(cuda) if binary else None)
    assert torch.equal(got.cpu(), tfp.fp_ops_plain(op, a, b if binary else None))


def test_fp_inverse_kernel_is_the_divstep_inverse(cuda):
    """K8 op 5 (csrc/fp.cuh's divstep inverse, then a product by R^3) on the
    edges, the powers of two and 64 seeded values: the plain version's
    Fermat words, and the host mirror's inverse of the same Montgomery
    value."""
    rng = np.random.default_rng(55)
    vals = _FP_EDGES + [1 << k for k in range(0, 381, 19)] + [
        int.from_bytes(rng.bytes(48), "little") % tfp.P for _ in range(64)]
    w = torch.from_numpy(tfp.ints_to_words(vals))
    with _counted("fp_ops"):
        got = tfp.fp_ops(tfp.OP_INV, w.to(cuda))
    assert torch.equal(got.cpu(), tfp.fp_ops_plain(tfp.OP_INV, w))
    mirror = [tfp.gcd_inverse_int(x)[0] * tfp.R % tfp.P * tfp.R % tfp.P for x in vals]
    assert tfp.words_to_ints(got.cpu()) == mirror


def test_to_mont_words_on_card(cuda):
    vals = [0, 1, tfp.P - 1, 12345]
    got = tfp.to_mont_words(torch.from_numpy(tfp.ints_to_words(vals)).to(cuda))
    assert tfp.words_to_ints(got) == [tfp.to_mont(v) for v in vals]


# z with 0, 1, all digits 3, a zero top window (and digits 3 below it), a
# top window 3 over zeros, then seeded
_LADDER_Z = [0, 1, 2, 2**64 - 1, 2**32, 987654321987654321, (1 << 62) - 1, 3 << 62]


def _ladder_inputs(n, field, seed):
    """n (pk, sig) items (8 distinct, tiled) and zbits, on the CPU."""
    p, _, s = (_rns_bls_items if field == "rns" else _bls_items)(8, 8, seed)
    idx = torch.arange(n) % 8
    rng = np.random.default_rng(n)
    zs = (_LADDER_Z + [int(v) for v in rng.integers(1, 2**63, max(n - 8, 0), dtype=np.int64)])[:n]
    return p[idx].contiguous(), s[idx].contiguous(), bls_torch.zbits_from_ints(zs)


def _check_ladders(cuda, field, n, affine, seed):
    """K9 at n items against its plain version on the card's tensors (G1
    affine or Jacobian, and G2, in one launch), and the G1-only and G2-only
    launches give the same points."""
    p, s, zb = (t.to(cuda) for t in _ladder_inputs(n, field, seed))
    name = "rlc_ladders_rns" if field == "rns" else "rlc_ladders"
    with _counted(name):
        got = tbls.rlc_ladders(p, s, zb, affine)
    for g, w in zip(got, tbls.rlc_ladders_plain(p, s, zb, affine)):
        assert torch.equal(g, w)
    g1_only = tbls.rlc_ladders(p, None, zb, affine)
    assert g1_only[1] is None and torch.equal(g1_only[0], got[0])
    g2_only = tbls.rlc_ladders(None, s, zb, affine)
    assert g2_only[0] is None and torch.equal(g2_only[1], got[1])


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n", [1, 3, 33, 256, 1024])
def test_rlc_ladders_kernel_matches_plain(cuda, affine, n):
    """K9's limb instance (G1 on four lanes, G2 on lane groups) across
    warp and block boundaries."""
    _check_ladders(cuda, "limb", n, affine, 1)


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


@pytest.mark.parametrize("field", ["limb", "rns"])
@pytest.mark.parametrize("n", [27, 256, 1024])
def test_g2_collapse_kernel_matches_plain(cuda, field, n):
    """K10's G2 collapse (K9's G2 groups over g2_sum_units(N) units, the
    blocks' partials meeting by tickets) bit-equal to the plain version in
    its order at the main path's N = 256 and 1,024 and at 27 (a partial last
    round): random points with infinity among them over one segment and
    over three (one empty), and P + P, P + (-P) meeting in a unit's fold, at
    the tree's first level and at its last, and all at infinity."""
    from consensus_specs_tpu_torch.engine.convert import rns_from_words

    units = tbls.g2_sum_units(n)
    cases = msm_synthetic.g2_sum_cases(n, units, n)
    name = "point_sums_rns" if field == "rns" else "point_sums"
    for case, pts in cases.items():
        if field == "rns":
            pts = rns_from_words(pts)
        pts = pts.to(cuda)
        segments = [[0, n]] + ([[0, 5, 5, n]] if case == "random" else [])
        for seg in segments:
            off = torch.tensor(seg, device=cuda)
            with _counted(name):
                got = tbls.point_sums(pts, off)
            assert torch.equal(got, tbls.point_sums_plain(pts, off)), (case, seg)
        if case in ("infinity", "last_cancel") and field == "limb":
            assert not got.any()  # (0, 0)


def _edge_segments():
    """K10's G1 edge segments: P + (-P), Q + Q + S, pads among keys, pads
    alone, and the block's first 512-key committee; (Jacobian words,
    offsets)."""
    F1 = bls_oracle.FP_FIELD
    rng = np.random.default_rng(41)
    keys = [bls_oracle.pt_to_affine(F1, bls_oracle.pt_mul(F1, bls_oracle.G1_GEN, int(k)))
            for k in rng.integers(1, 2**62, 5, dtype=np.int64)]
    neg = (keys[0][0], (-keys[0][1]) % bls_oracle.P)
    edge = tbls._jacobian_words([keys[0], neg, keys[1], keys[1], keys[2], keys[3], keys[4]],
                                8, "cpu")
    edge = torch.cat([edge[:5], edge[7:11], edge[5:7], edge[11:]])  # pads among keys
    committee = tbls._jacobian_words(msm_synthetic.committee_keys(0)[0], 0, "cpu")
    pts = torch.cat([edge, committee])
    return pts, torch.tensor([0, 2, 5, 11, 15, 527])


def test_point_sums_kernel_on_a_committee_and_edge_segments(cuda):
    """K10's limb G1 instance (four-lane groups, 256 threads a segment) on
    the edge segments and a 512-key committee, bit-equal to the plain
    version; the committee also alone, as g1_aggregate sums it, equal to
    the oracle's [sum sk]·G1."""
    pts, off = _edge_segments()
    with _counted("point_sums"):
        got = tbls.point_sums(pts.to(cuda), off.to(cuda))
    want = tbls.point_sums_plain(pts, off)
    assert torch.equal(got.cpu(), want)
    assert tbls._affine_or_none(want[0]) is None
    agg = tbls.g1_aggregate(pts[15:].to(cuda))
    assert torch.equal(agg.cpu(), want[-1])
    assert tbls._affine_or_none(agg.cpu()) == msm_synthetic.committee_keys(0)[1]


def _final_exp_inputs(field, b, cuda):
    """b Miller values on the card (8 distinct pairs' values, tiled) and b
    more for m2, in the limb field or as RNS residues."""
    items = (_rns_bls_items if field == "rns" else _bls_items)(8, 8, 36)
    p, q, _ = items
    m = tbls.miller_loop(q.to(cuda), p.to(cuda))
    idx = torch.arange(2 * b, device=cuda) % 8
    rolled = torch.roll(m, 3, 0)[idx]
    return m[idx[:b]].contiguous(), rolled[b:].contiguous()


@pytest.mark.parametrize("field", ["limb", "rns"])
@pytest.mark.parametrize("b", [1, 3, 64, 257])
def test_final_exp_kernel_at_batch_and_tail_sizes(cuda, field, b):
    """K12's group exponentiation (16 lanes under limb, 8 warps under RNS)
    bit-equal to the plain version on the card's tensors: batch mode at 1, 3
    and 64 items (with m2 at 3), and the tail at 257 values (256 and the
    extra), as the block flush gives it."""
    m1, m2 = _final_exp_inputs(field, b, cuda)
    name = "final_exp_rns" if field == "rns" else "final_exp"
    with _counted(name):
        if b == 257:
            got = tbls.final_exp_tail(m1[:-1], m1[-1])
        else:
            got = tbls.final_exp_batch(m1, m2 if b == 3 else None)
    want = (tbls.final_exp_tail_plain(m1[:-1], m1[-1]) if b == 257 else
            tbls.final_exp_batch_plain(m1, m2 if b == 3 else None))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _miller_inputs(b, field, seed):
    """b (Q, P) pairs (8 distinct, tiled), the last two (for b >= 3) the
    affine (0, 0) operands of test_affine_infinity_operands: P = (0, 0) and
    Q = (0, 0)."""
    p, q, _ = (_rns_bls_items if field == "rns" else _bls_items)(8, 8, seed)
    idx = torch.arange(b) % 8
    p, q = p[idx].contiguous(), q[idx].contiguous()
    if b >= 3:
        p[-2] = 0
        q[-1] = 0
    return p, q


@pytest.mark.parametrize("b", [1, 3, 65, 257, 1025])
def test_miller_loop_kernel_at_the_paths_sizes(cuda, b):
    """K11's limb instance (a warp a pairing, four a block) bit-equal to the
    plain version on the card's tensors at 1, 3, 65, 257 and 1,025 pairs."""
    p, q = (t.to(cuda) for t in _miller_inputs(b, "limb", 3))
    with _counted("miller_loop"):
        m = tbls.miller_loop(q, p)
    assert torch.equal(m, tbls.miller_loop_plain(q, p))


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


@pytest.mark.parametrize("window", [4, 5])
@pytest.mark.parametrize("n,nbits", [(128, 64), (512, 255)])
def test_g1_msm_kernel_at_the_kzg_shapes(cuda, n, nbits, window):
    """K13 (four-lane tables and window sums, the tail's chains on one warp)
    at the KZG batch's two shapes: scalars 0, 1, 2^64 - 1 and 2^nbits - 1
    among random ones, a repeated point and a cancelling pair; all-zero
    scalars give the identity, (0, 0)."""
    pts, sc = _msm_items(n, nbits, n + window)
    sc[3] = tbls.scalar_words([(1 << nbits) - 1], nbits)[0]
    pts, sc = pts.to(cuda), sc.to(cuda)
    with _counted("g1_msm"):
        got = tbls.g1_msm(pts, sc, nbits, window)
    assert torch.equal(got, tbls.g1_msm_plain(pts, sc, nbits, window))
    zero = torch.zeros_like(sc)
    assert not tbls.g1_msm(pts, zero, nbits, window).any()


def test_g1_msm_kernel_identity(cuda):
    pts, _ = _msm_items(8, 64, 1)
    got = tbls.g1_msm(pts.to(cuda), tbls.scalar_words([0] * 8, 64).to(cuda), 64)
    assert torch.equal(got.cpu(), torch.zeros((2, 12), dtype=torch.int32))


def test_g1_subgroup_kernel_matches_plain(cuda):
    """K14 (four lanes a key) bit-equal to the plain chain on keys, (0, 2) and
    two pads, and on the edge points: (0, +-2), random curve points, cofactor
    parts and keys plus (0, 2)."""
    pts, _ = _msm_items(10, 64, 2)
    pts = torch.cat([pts, tbls._jacobian_words([(0, 2)], 2, "cpu")])  # (0, 2) and two pads
    edge, member = msm_synthetic.subgroup_edge_points(11)
    edge_words = tbls._jacobian_words(edge, 12, "cpu")
    want = tbls.g1_subgroup_check_plain(pts)
    want_edge = tbls.g1_subgroup_check_plain(edge_words)
    assert want.tolist() == [True] * 10 + [False, True, True]
    assert want_edge.tolist() == member + [True] * 12
    with _counted("g1_subgroup"):
        got = tbls.g1_subgroup_check(pts.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tbls.g1_subgroup_check(edge_words.to(cuda)).cpu(), want_edge)


def test_g1_subgroup_kernel_committee_with_pads(cuda):
    """A committee's 512 keys, then 4 random curve points (outside the
    subgroup) and 60 pads: one launch, bit-equal to the plain chain."""
    rng = np.random.default_rng(21)
    F1 = bls_oracle.FP_FIELD
    keys = [bls_oracle.pt_to_affine(F1, bls_oracle.pt_mul(F1, bls_oracle.G1_GEN, int(k)))
            for k in rng.integers(1, 2**62, 512, dtype=np.int64)]
    edge, member = msm_synthetic.subgroup_edge_points(12, keys=0, curve=4, cofactor=0, mixed=0)
    words = tbls._jacobian_words(keys + edge[2:], 60, cuda)
    with _counted("g1_subgroup"):
        got = tbls.g1_subgroup_check(words)
    want = tbls.g1_subgroup_check_plain(words)
    assert torch.equal(got, want)
    assert want.tolist() == [True] * 512 + member[2:] + [True] * 60


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


# --- the read lane: K20 multiproof_heap, K21 multiproof_siblings ------------

from consensus_specs_tpu_torch.ops import multiproof as tmultiproof  # noqa: E402
from consensus_specs_tpu_torch.sched import MerkleWorkClass, Request, Scheduler  # noqa: E402
from consensus_specs_tpu_torch.ssz.proofs import build_chunk_proof  # noqa: E402


def _multiproof_inputs(k, c, q, seed, shallow=False):
    rng = np.random.default_rng(seed)
    words = _words((k, c, 8), seed)
    tree_ids = rng.integers(0, k, q).astype(np.int32)
    low = 1 if shallow else c
    gidx = rng.integers(low, max(low + 1, 2 * c if not shallow else min(2 * c, 8)), q)
    gidx = gidx.astype(np.int32)
    gidx[0], tree_ids[0] = 1, 0  # a pad: the root of tree 0
    return words, tree_ids, gidx


@pytest.mark.parametrize("k,c,q,shallow", [(1, 1, 4, False), (2, 2, 8, False),
                                           (4, 64, 16, True), (3, 4096, 64, False),
                                           (8, 1 << 18, 512, False), (8, 1 << 18, 64, True)])
def test_multiproof_kernels_match_plain(cuda, k, c, q, shallow):
    words, tree_ids, gidx = _multiproof_inputs(k, c, q, k * 1009 + c + q, shallow)
    args = (_dev(words, cuda), torch.from_numpy(tree_ids).to(cuda),
            torch.from_numpy(gidx).to(cuda))
    build.reset_launches()
    heap = tmultiproof.multiproof_heap(args[0])
    got = tmultiproof.sibling_rows_batch(*args)
    launches = dict(build.LAUNCHES)
    torch.cuda.synchronize()
    assert torch.equal(heap, tmultiproof.multiproof_heap_plain(args[0]))
    for a, b in zip(got, tmultiproof.sibling_rows_batch_plain(*args)):
        assert torch.equal(a, b)
    per_heap = max(1, -(-(c - 1).bit_length() // tmultiproof.HEAP_FOLD_MAX_LEVELS))
    assert launches["multiproof_heap"] == 2 * per_heap
    assert launches["multiproof_siblings"] == 1
    t, g = int(tree_ids[-1]), int(gidx[-1])
    d = g.bit_length() - 1
    assert [words_to_bytes(r) for r in got[0][-1, :d].cpu().numpy()] == build_chunk_proof(
        [words_to_bytes(r) for r in words[t]], g)


@pytest.mark.parametrize("k,c,q,shallow", [(4, 64, 16, True), (8, 1 << 18, 512, False),
                                           (37, 8, 5, False)])
def test_multiproof_gather_outputs_are_views_of_one_buffer(cuda, k, c, q, shallow):
    """K21 alone: siblings, nodes and roots equal the plain version's and are
    consecutive views of one (Q*D + Q + K, 8) buffer (37 trees: roots over
    three warps)."""
    words, tree_ids, gidx = _multiproof_inputs(k, c, q, k + c + q, shallow)
    heap = tmultiproof.multiproof_heap_plain(torch.from_numpy(words.view(np.int32)))
    d = max((c - 1).bit_length(), 1)
    args = (torch.from_numpy(tree_ids), torch.from_numpy(gidx), d)
    with _counted("multiproof_siblings"):
        got = tmultiproof.multiproof_gather(heap.to(cuda), *(a.to(cuda) for a in args[:2]), d)
    want = tmultiproof.multiproof_gather_plain(heap, *args)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b) and a.dtype == torch.int32
    assert [tuple(t.shape) for t in got] == [(q, d, 8), (q, 8), (k, 8)]
    base = got[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in got)
    assert [t.storage_offset() for t in got] == [0, q * d * 8, (q * d + q) * 8]


def test_multiproof_kernels_check_their_inputs(cuda):
    words, tree_ids, gidx = _multiproof_inputs(2, 4, 4, 5)
    chunks = _dev(words, cuda)
    bad = torch.from_numpy(gidx).to(cuda)
    bad[1] = 8
    with pytest.raises(ValueError):
        tmultiproof.sibling_rows_batch(chunks, torch.from_numpy(tree_ids).to(cuda), bad)


def test_multiproof_launches_pinned_per_bucket(cuda):
    """The port's counterpart of tests/test_proofs.py's
    test_multiproof_compile_pinned_one_per_bucket: launches per (K, C, Q)
    bucket, the same again on replay, and a new bucket adds exactly its
    own."""

    def run(counts, per_tree):
        sch = Scheduler(classes=[MerkleWorkClass(device=cuda)])
        handles = []
        for i, n in enumerate(counts):
            chunks = [bytes([(11 * i + j) % 251 + 1] * 32) for j in range(n)]
            c_full = 1 if n <= 1 else 1 << (n - 1).bit_length()
            for q in range(per_tree):
                handles.append(sch.submit(Request(work_class="merkle", kind="multiproof",
                                                  payload=(chunks, c_full + q % c_full))))
        build.reset_launches()
        sch.drain()
        for h in handles:
            assert isinstance(h.result(), tuple)
        return build.LAUNCHES["multiproof_heap"], build.LAUNCHES["multiproof_siblings"]

    first = run((3, 4, 2), 3)  # buckets (K=2, C=4, Q=8) and (K=1, C=2, Q=2)
    assert first == (2, 2)
    assert run((3, 4, 2), 3) == first
    assert run((3,) * 9, 1) == (1, 1)  # (K=16, C=4, Q=16)


def _mixed_merkle(seed, counts):
    """tests/test_torch_proofs.py's `_mixed` workload (that file imports the
    JAX package, which the card-only tests do not): tree_root and multiproof
    requests over random trees in several leaf-count buckets, odd query
    counts forcing pad queries."""
    rng = np.random.RandomState(seed)
    items = []
    for i, n in enumerate(counts):
        chunks = [rng.randint(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
        c_full = 1 if n <= 1 else 1 << (n - 1).bit_length()
        if i % 3 == 2:
            items.append(("tree_root", (chunks,)))
        for _ in range(int(rng.randint(1, 4))):
            items.append(("multiproof", (chunks, int(rng.randint(1, 2 * c_full)))))
    return items


@pytest.mark.parametrize("counts", [(1, 3, 8, 5, 16, 2, 3), (4, 4, 7), (1, 2, 2000, 9, 6, 1500)])
def test_merkle_class_mixed_kinds_on_the_card_match_cpu(cuda, counts):
    """Both kinds of MerkleWorkClass on the card, tree_root (K19) beside
    multiproof (K20 + K21) in one drained batch, equal to the same batch on
    MerkleWorkClass(device="cpu"), with the launches each bucket implies."""
    items = _mixed_merkle(42 + len(counts), counts)

    def run(device):
        sch = Scheduler(classes=[MerkleWorkClass(device=device)])
        handles = [sch.submit(Request(work_class="merkle", kind=k, payload=p)) for k, p in items]
        build.reset_launches()
        sch.drain()
        return [h.result() for h in handles], dict(build.LAUNCHES)

    got, launches = run(cuda)
    want, _ = run("cpu")
    assert got == want

    def buckets(kind):
        return {1 if len(p[0]) <= 1 else 1 << (len(p[0]) - 1).bit_length()
                for k, p in items if k == kind}

    def levels(c, per_launch):
        return -(-(c - 1).bit_length() // per_launch)

    assert launches["tree_root_batch"] == sum(
        levels(c, troot.TREE_FOLD_MAX_LEVELS) for c in buckets("tree_root")) > 0
    assert launches["multiproof_heap"] == sum(
        max(1, levels(c, tmultiproof.HEAP_FOLD_MAX_LEVELS)) for c in buckets("multiproof"))
    assert launches["multiproof_siblings"] == len(buckets("multiproof"))


# --- K22 fr_ntt and K23 fr_ops -------------------------------------------------


def _fr_words(m, seed, dev):
    """m canonical Montgomery words on dev, the edge values 0, 1, r - 1 and
    R mod r first."""
    rng = np.random.default_rng(seed)
    r = tfr.R_MODULUS
    vals = [0, 1, r - 1, tfr.R_MOD_R] + [int.from_bytes(rng.bytes(32), "little") % r
                                          for _ in range(max(m - 4, 0))]
    return torch.from_numpy(tfr.ints_to_words(vals[:m])).to(dev)


# the plain inverse costs 380 plain products: held at M <= 1000
@pytest.mark.parametrize("op,m", [(op, m) for op in (tfr.OP_MUL, tfr.OP_ADD, tfr.OP_SUB)
                                  for m in (1, 1000, 32768)]
                         + [(op, m) for op in (tfr.OP_INV, tfr.OP_INV_WORDS) for m in (1, 1000)])
def test_fr_ops_kernel_matches_plain(cuda, op, m):
    a = _fr_words(m, m + op, cuda)
    b = _fr_words(m, m + 7, cuda).flip(0).contiguous()
    unary = op in (tfr.OP_INV, tfr.OP_INV_WORDS)
    if op == tfr.OP_INV_WORDS:  # words at or above r, reduced by the kernel
        a[-1] = -1
    if not unary:
        b[-1] = 0  # sub with b = 0
    bb = None if unary else b
    build.reset_launches()
    got = tfr.fr_ops(op, a, bb)
    assert build.LAUNCHES["fr_ops"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, tfr.fr_ops_plain(op, a, bb))
    if not unary:  # b as one (8,) row, read by every thread
        assert torch.equal(tfr.fr_ops(op, a, b[0]), tfr.fr_ops_plain(op, a, b[0].expand_as(a)))


@pytest.mark.parametrize("shape,inverse", [((64, 32768), False), ((1, 16384), True),
                                           ((1, 32768), False), ((3, 1), False), ((3, 1), True),
                                           ((3, 2), False), ((3, 2), True), ((5, 16), True),
                                           ((2, 4096), True), ((64, 32768), True),
                                           ((3, 16384), False), ((3, 256), True),
                                           ((64, 256), False), ((3, 512), False),
                                           ((1, 512), True), ((1, 65536), True),
                                           ((2, 131072), False)])
def test_fr_ntt_kernel_matches_plain(cuda, shape, inverse):
    """K22 at the DAS lane's shapes (a slot's 64 extensions, a blob's
    inverse, one extension), batches of 3 and 64, at the split points of
    its passes (n = 2^8 pass A alone, 2^9 a pass B of one stage, 2^16 two
    full passes, 2^17 three) and at the edges n = 1 and n = 2."""
    x = _fr_words(shape[0] * shape[1], shape[1] + int(inverse), cuda).reshape(*shape, 8)
    build.reset_launches()
    got = tfr.ntt(x, inverse)
    assert build.LAUNCHES["fr_ntt"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, tfr.ntt_plain(x, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_fr_ntt_kernel_at_every_tile_log(cuda, inverse):
    """K22's entry at every pass A split t = 1 .. 10 for n = 2^10 (the
    wrapper's own t is 8), Montgomery and canonical."""
    n = 1 << 10
    x = _fr_words(3 * n, 40 + int(inverse), cuda).reshape(3, n, 8)
    table, scale = tfr.twiddles(n, inverse, cuda)
    want = tfr.ntt_plain(x, inverse)
    want_words = tfr.ntt_words_plain(x, inverse)
    pre = tfr.const_row(tfr.R2_MOD_R, cuda)
    post = tfr._inverse_n(n, cuda) if inverse else tfr.const_row(1, cuda)
    for t in range(1, 11):
        assert torch.equal(tfr._launch_ntt(x, table, None, scale, 10, t), want), t
        assert torch.equal(tfr._launch_ntt(x, table, pre, post, 10, t), want_words), t


@pytest.mark.parametrize("shape,inverse", [((1, 16384), True), ((1, 32768), False),
                                           ((64, 32768), False), ((3, 1), True),
                                           ((3, 2), False), ((2, 512), True)])
def test_fr_ntt_words_matches_its_plain_composition(cuda, shape, inverse):
    """The canonical entry (one K22 launch, the conversions folded in)
    against K23's product by R^2, `ntt_plain`, K23's product by 1, with
    words at or above r among the inputs."""
    x = _fr_words(shape[0] * shape[1], shape[1] + 3 * int(inverse), cuda).reshape(*shape, 8)
    x.view(-1, 8)[-1] = -1  # 2^256 - 1
    x.view(-1, 8)[0] = torch.tensor(tfr.ints_to_words([tfr.R_MODULUS])[0], device=cuda)
    build.reset_launches()
    got = tfr.ntt_words(x, inverse)
    assert (build.LAUNCHES["fr_ntt"], build.LAUNCHES["fr_ops"]) == (1, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, tfr.ntt_words_plain(x, inverse))


def test_das_entries_launch_k22_once_and_k23_once(cuda):
    """`ntt_ints` is one K22 launch and no K23; `inv_ints` one K23."""
    from consensus_specs_tpu_torch.ops.fr_host import host_ntt

    rng = np.random.default_rng(15)
    vals = [0, tfr.R_MODULUS] + [int.from_bytes(rng.bytes(32), "little") for _ in range(62)]
    for inverse in (False, True):
        build.reset_launches()
        got = tfr.ntt_ints(vals, inverse, cuda)
        assert (build.LAUNCHES["fr_ntt"], build.LAUNCHES["fr_ops"]) == (1, 0)
        assert got == host_ntt([v % tfr.R_MODULUS for v in vals], inverse=inverse)
    build.reset_launches()
    got = tfr.inv_ints(vals, cuda)
    assert (build.LAUNCHES["fr_ntt"], build.LAUNCHES["fr_ops"]) == (0, 1)
    assert got == [pow(v % tfr.R_MODULUS, tfr.R_MODULUS - 2, tfr.R_MODULUS) for v in vals]


def test_fr_ntt_round_trip_and_host_dft_on_card(cuda):
    x = _fr_words(4 * 256, 11, cuda).reshape(4, 256, 8)
    assert torch.equal(tfr.ntt(tfr.ntt(x), inverse=True), x)
    vals = [int(v) for v in np.random.default_rng(12).integers(0, 2**62, 16)]
    from consensus_specs_tpu_torch.ops.fr_host import host_ntt

    assert tfr.ntt_ints(vals, False, cuda) == host_ntt(vals)
    assert tfr.ntt_ints(vals, True, cuda) == host_ntt(vals, inverse=True)


def test_fr_kernels_check_their_inputs(cuda):
    with pytest.raises(ValueError, match="power of two"):
        tfr.ntt(torch.zeros((2, 12, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        tfr.fr_ops(tfr.OP_MUL, torch.zeros((4, 8), dtype=torch.int32, device=cuda),
                   torch.zeros((4, 8), dtype=torch.int32))


def test_das_on_card_matches_cpu(cuda):
    """The port's das module and compiled das spec on the card (K22 + K23)
    equal the same on the CPU (the plain versions), with the launches the
    path implies: two K22 and no K23 an extension, six K22 a recovery."""
    from consensus_specs_tpu_torch.compiler import spec_compiler as tcomp
    from consensus_specs_tpu_torch.crypto import das as tdas

    rng = np.random.default_rng(13)
    data = [int.from_bytes(rng.bytes(32), "little") % tdas.MODULUS for _ in range(1024)]
    build.reset_launches()
    full = tdas.extend_data(data, device=cuda)
    assert (build.LAUNCHES["fr_ntt"], build.LAUNCHES["fr_ops"]) == (2, 0)
    assert full == tdas.extend_data(data, device="cpu")
    keep = {i: full[i] for i in sorted(random.Random(14).sample(range(2048), 1100))}
    build.reset_launches()
    assert tdas.recover_data(keep, 2048, device=cuda) == full
    assert build.LAUNCHES["fr_ntt"] == 6
    spec = tcomp.build_spec("das", "minimal", device=cuda)
    cpu_spec = tcomp.build_spec("das", "minimal", device="cpu")
    published = spec.extend_data(data[:256])
    assert published == cpu_spec.extend_data(data[:256])
    pps = int(spec.POINTS_PER_SAMPLE)
    subgroups = [spec.reverse_bit_order_list(published[i * pps:(i + 1) * pps])
                 for i in range(len(published) // pps)]
    partial = [sg if i % 3 else None for i, sg in enumerate(subgroups)]
    assert spec.recover_data(partial) == published


# --- K24 rns_ops: the RNS field ---------------------------------------------------------


def _rns_residues(values, dev):
    from consensus_specs_tpu_torch.ops import fp_rns as R

    mab = R.M_A * R.M_B
    return torch.from_numpy(np.stack([R._residues(v % mab, R._PRIMES) for v in values])).to(dev)


def _rns_operands(m, seed, dev):
    """m seeded Montgomery values with the field's edges first (0, 1, p, 2p,
    -1, -p, R mod p, 3p - 1), and a second operand."""
    from consensus_specs_tpu_torch.ops import fp_rns as R

    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % R.P * R.M_A % R.P for _ in range(2 * m)]
    edges = [0, 1, R.P, 2 * R.P, -1, -R.P, R.R_MOD_P, 3 * R.P - 1]
    vals[:min(m, 8)] = edges[:m]
    return _rns_residues(vals[:m], dev), _rns_residues(vals[m:], dev)


@pytest.mark.parametrize("op", range(11))
@pytest.mark.parametrize("m", [1, 2, 33, 130, 256, 1024])
def test_rns_ops_kernel_matches_plain(cuda, op, m):
    """Every op code of K24 bit-equal, channel for channel, to its plain
    version on the same CUDA tensors; one counted launch."""
    from consensus_specs_tpu_torch.ops import fp_rns as R

    a, b = _rns_operands(m, op + m, cuda)
    if op == R.OP_SUM_STACK:
        args = (torch.stack([a, b, a, b, a, b, a, b]),)
    elif op in R._BINARY:
        args = (a, b)
    elif op == R.OP_MONT_REDUCE:
        args = (R.rns_ops_plain(R.OP_MUL_WIDE, a, b),)
    else:
        args = (a,)
    by_op = R.OP_LAUNCHES[R.OP_NAMES[op]]
    with _counted("rns_ops"):
        got = R.rns_ops(op, *args)
    assert R.OP_LAUNCHES[R.OP_NAMES[op]] == by_op + 1
    assert torch.equal(got, R.rns_ops_plain(op, *args))


def test_rns_mont_reduce_at_the_alpha_boundary(cuda):
    """Inputs whose q = -t·p^-1 mod M_A lies next to M_A/4, where the first
    extension's float32 alpha decides a floor: K24 equals its plain version
    (both sum alpha in channel order) and Python's value mod p."""
    from consensus_specs_tpu_torch.ops import fp_rns as R

    qs = [R.M_A // 4 + k for k in range(-60, 61)]
    t = _rns_residues([(-q * R.P) % R.M_A for q in qs], cuda)
    got = R.rns_ops(R.OP_MONT_REDUCE, t)
    assert torch.equal(got, R.rns_ops_plain(R.OP_MONT_REDUCE, t))
    ints = [R.from_mont_int(r) for r in t.cpu().numpy()]
    assert R.mont_batch_to_ints(got) == [x * pow(R.M_A, -1, R.P) % R.P for x in ints]


def test_rns_mont_reduce_at_the_alpha_boundary_in_a_warp_block(cuda):
    """The alpha-boundary inputs again, at M = 1,024 (256 blocks of four
    warps), beside wide products: the warp-wide K24 equals its plain
    version on every element."""
    from consensus_specs_tpu_torch.ops import fp_rns as R

    qs = [R.M_A // 4 + k for k in range(-60, 61)]
    qs += [R.M_A // 4 + int(R.M_A * f) for f in (2**-20, -2**-20, 2**-23, -2**-23)]
    t = _rns_residues([(-q * R.P) % R.M_A for q in qs], cuda)
    a, b = _rns_operands(1024 - t.shape[0], 7, cuda)
    t = torch.cat([t, R.rns_ops_plain(R.OP_MUL_WIDE, a, b)])
    assert torch.equal(R.rns_ops(R.OP_MONT_REDUCE, t), R.rns_ops_plain(R.OP_MONT_REDUCE, t))


def test_rns_ops_wrapper_on_the_card(cuda):
    """M = 0 launches nothing; strided and broadcast inputs are made
    contiguous; a CPU operand beside a CUDA one raises."""
    from consensus_specs_tpu_torch.ops import fp_rns as R

    a, b = _rns_operands(8, 3, cuda)
    before = build.LAUNCHES["rns_ops"]
    assert R.rns_ops(R.OP_MONT_MUL, a[:0], b[:0]).shape == (0, 64)
    assert build.LAUNCHES["rns_ops"] == before
    got = R.fp_mont_mul(a[::2], b[0])
    assert torch.equal(got, R.rns_ops_plain(R.OP_MONT_MUL, a[::2].contiguous(),
                                            b[0].expand(4, 64).contiguous()))
    with pytest.raises(ValueError):
        R.rns_ops(R.OP_ADD, a, b.cpu())


def test_rns_towers_on_card_equal_cpu(cuda):
    """ops/bls12_field on the card (every field op a K24 launch) gives the
    same residues as on the CPU: a Miller loop and a final exponentiation."""
    from consensus_specs_tpu_torch.ops import bls12_field as BF
    from consensus_specs_tpu_torch.ops import fp_rns as R

    p, q, _ = _bls_items(2, 2, 21)
    pts = tbls.affine_from_words(p, False)
    hs = tbls.affine_from_words(q, True)

    def enc(vals):
        return torch.from_numpy(R.ints_to_mont_batch(vals))

    args = ((enc([h[0][0] for h in hs]), enc([h[0][1] for h in hs])),
            (enc([h[1][0] for h in hs]), enc([h[1][1] for h in hs])),
            enc([a[0] for a in pts]), enc([a[1] for a in pts]))

    def to(x, dev):
        return tuple(to(c, dev) for c in x) if isinstance(x, tuple) else x.to(dev)

    before = build.LAUNCHES["rns_ops"]
    on_card = BF.pairing_cube_batch(*to(args, cuda))
    assert build.LAUNCHES["rns_ops"] > before
    on_cpu = BF.pairing_cube_batch(*args)
    for c_card, c_cpu in zip(on_card, on_cpu):
        assert torch.equal(c_card[0].cpu(), c_cpu[0]) and torch.equal(c_card[1].cpu(), c_cpu[1])


def test_rns_flush_on_card_matches_limb(cuda):
    """The flush under the "rns" field backend on the card: the randomized
    check over 20 checks passes and records as the limb path, one bad
    signature is attributed to its index as on the limb path; it runs on
    K9-K12's RNS instances (K24 launches no more than the conversions: the
    packing is on the host, so none) and no limb K8-K12 launch."""
    p, q, s = _bls_items(20, 20, 22)
    pts = tbls.affine_from_words(p, False)
    hs = tbls.affine_from_words(q, True)
    sigs = tbls.affine_from_words(s, True)
    checks = [bls_torch.QueuedCheck(a, h, bls_torch._NEG_G1, g) for a, h, g in zip(pts, hs, sigs)]
    bad = list(checks)
    bad[13] = bls_torch.QueuedCheck(pts[13], hs[13], bls_torch._NEG_G1, sigs[12])
    limb = (bls_torch.run_checks(checks, cuda), dict(bls_torch.LAST_FLUSH),
            bls_torch.run_checks(bad, cuda))
    tbls.set_field_backend("rns")
    try:
        build.reset_launches()
        got = (bls_torch.run_checks(checks, cuda), dict(bls_torch.LAST_FLUSH),
               bls_torch.run_checks(bad, cuda))
        torch.cuda.synchronize()
    finally:
        tbls.set_field_backend("limb")
    assert got[0].all() and limb[0].all() and got[1] == limb[1]
    assert np.flatnonzero(~got[2]).tolist() == np.flatnonzero(~limb[2]).tolist() == [13]
    assert build.LAUNCHES["rns_ops"] == 0
    assert all(build.LAUNCHES[f"{k}_rns"] > 0 for k in ("rlc_ladders", "point_sums",
                                                        "miller_loop", "final_exp"))
    assert not any(build.LAUNCHES[k] for k in ("fp_ops", "rlc_ladders", "point_sums",
                                                "miller_loop", "final_exp"))


# --- K9-K12's RNS instances (one warp an item over csrc/fp_rns.cuh) -----------


def _rns_bls_items(n, messages, seed):
    """`_bls_items` as RNS residues (the same points)."""
    from consensus_specs_tpu_torch.engine.convert import rns_from_words

    return tuple(rns_from_words(t) for t in _bls_items(n, messages, seed))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("n", [1, 5, 3, 33, 256, 1024])
def test_rns_ladders_kernel_matches_plain(cuda, affine, n):
    """K9's RNS instance (G1 on 4 warps, two a block; G2 on a block's 8
    warps) bit-equal to the RNS plain version across block boundaries, z
    with 0, 1, all digits 3 and a zero top window; the G1-only and G2-only
    launches give the same points."""
    _check_ladders(cuda, "rns", n, affine, 31)


@pytest.mark.parametrize("g2", [False, True])
def test_rns_point_sums_kernel_matches_plain(cuda, g2):
    """K10's RNS instance (16 warps a segment) bit-equal to the plain
    version in its order: an empty segment, segments of 3 and 37 (more
    points than warps), and a point at infinity (z = 0) among them."""
    p, _, s = _rns_bls_items(40, 40, 32)
    zb = bls_torch.zbits_from_ints([0] + list(range(2, 41)))
    g1, g2j = tbls.rlc_ladders_plain(p, s, zb, affine_g1=False)
    pts = g2j if g2 else g1
    off = torch.tensor([0, 40] if g2 else [0, 3, 3, 40])
    with _counted("point_sums_rns"):
        got = tbls.point_sums(pts.to(cuda), off.to(cuda))
    assert torch.equal(got.cpu(), tbls.point_sums_plain(pts, off))


@pytest.mark.parametrize("b", [1, 3, 65, 257, 1025])
def test_rns_miller_loop_kernel_at_the_paths_sizes(cuda, b):
    """K11's RNS instance (a block of 8 warps a pairing) bit-equal to the
    RNS plain version on the card's tensors, the (0, 0) operands among the
    pairs."""
    p, q = (t.to(cuda) for t in _miller_inputs(b, "rns", 33))
    with _counted("miller_loop_rns"):
        m = tbls.miller_loop(q, p)
    assert torch.equal(m, tbls.miller_loop_plain(q, p))


def test_rns_miller_and_final_exp_kernels_match_plain(cuda):
    """K11 and K12's RNS instances bit-equal to the plain version: 5 Miller
    loops (a block of four warps and one more), the batch mode with m2, the
    tail over 4 values and an extra; the verdicts agree with the limb
    kernels'."""
    p, q, _ = _rns_bls_items(5, 5, 33)
    with _counted("miller_loop_rns"):
        m = tbls.miller_loop(q.to(cuda), p.to(cuda))
    mp = tbls.miller_loop_plain(q, p)
    assert torch.equal(m.cpu(), mp)
    with _counted("final_exp_rns"):
        cube, ok = tbls.final_exp_batch(m[:2], m[2:4])
    wc, wok = tbls.final_exp_batch_plain(mp[:2], mp[2:4])
    assert torch.equal(cube.cpu(), wc) and torch.equal(ok.cpu(), wok)
    with _counted("final_exp_rns"):
        cube, ok = tbls.final_exp_tail(m[:-1], m[-1])
    wc, wok = tbls.final_exp_tail_plain(mp[:-1], mp[-1])
    assert torch.equal(cube.cpu(), wc) and bool(ok) == bool(wok)


@pytest.mark.parametrize("grouped", [False, True])
def test_rns_pairing_check_rlc_on_card(cuda, grouped):
    """Both randomized-check paths on the RNS instances: a valid batch
    passes, a bad signature fails, an empty segment fails; the batch check
    flags the bad item; no limb K9-K12 launch."""
    p, q, s = _rns_bls_items(12, 3 if grouped else 12, 4)
    zb = bls_torch.zbits_from_ints(np.random.default_rng(5).integers(1, 2**63, 12))
    seg = torch.tensor([i % 3 for i in range(12)], device=cuda) if grouped else None
    reps = q[:3] if grouped else q
    args = (reps.to(cuda), p.to(cuda))
    build.reset_launches()
    assert bool(tbls.pairing_check_rlc(*args, s.to(cuda), zb.to(cuda), seg))
    bad = s.clone()
    bad[7] = s[6]
    assert not bool(tbls.pairing_check_rlc(*args, bad.to(cuda), zb.to(cuda), seg))
    if grouped:
        extra = torch.cat([reps, q[:1]]).to(cuda)  # a fourth message, no member
        assert not bool(tbls.pairing_check_rlc(extra, p.to(cuda), s.to(cuda), zb.to(cuda), seg))
    neg = tbls.neg_g1_words(cuda, 64)[None].expand(12, 2, 64).contiguous()
    ok = tbls.pairing_check_batch(q.to(cuda), p.to(cuda), bad.to(cuda), neg)
    assert ok.cpu().tolist() == [i != 7 for i in range(12)]
    torch.cuda.synchronize()
    assert not any(build.LAUNCHES[k] for k in ("rlc_ladders", "point_sums", "miller_loop",
                                                "final_exp", "rns_ops"))


# --- slice 10: K25, K3's phases, the mesh path at world size 1 on NCCL ------


class _OneRank:
    """A one-rank stand-in for parallel/mesh.MeshComm."""

    size, rank = 1, 0

    @staticmethod
    def all_gather(t):
        return t[None].clone()


@pytest.mark.parametrize("b", [1, 2, 3, 256, 257, 1025])
def test_f12_product_kernel_matches_plain(cuda, b):
    rng = np.random.default_rng(b)
    ints = [int.from_bytes(rng.bytes(48), "little") % tfp.P for _ in range(12 * b)]
    m = torch.from_numpy(tfp.ints_to_mont_words(ints)).reshape(b, 12, tfp.NWORDS)
    md = m.to(cuda)
    with _counted("f12_product"):
        got = tbls.f12_product(md)
    assert torch.equal(md.cpu(), m), "f12_product must leave its input as it was"
    assert torch.equal(got.cpu(), tbls.f12_product_plain(m))


@pytest.mark.parametrize("case", ["synthetic", "ejections_and_queue", "slashing_hit", "boundary"])
def test_epoch_phase_entries_compose(cuda, case):
    """epoch_reduce -> epoch_sweep_a equals epoch_phase1 on every output,
    and the whole sharded composition on one rank (the combine, mark,
    sweep B and finalize entries) equals K3's two-launch step."""
    import ctypes

    cfg = EpochConfig.altair_mainnet()
    d = CASES[case](cfg, 4096, seed=3)
    a, b = epoch_state_from_numpy(d, cuda), epoch_state_from_numpy(d, cuda)
    n = a.num_validators
    buf_a, buf_b = tepoch._buffers(n, cuda), tepoch._buffers(n, cuda)
    tepoch.epoch_reduce(cfg, a, buf_a[0])
    tepoch.epoch_sweep_a(cfg, a, *buf_a)
    ckpts = tepoch._ckpts(b)
    build.check(build.entry("epoch", "epoch_phase1", 20)(
        ctypes.addressof(tepoch._kernel_params(cfg)), b.slot.data_ptr(), b.balances.data_ptr(),
        b.effective_balance.data_ptr(), b.activation_eligibility_epoch.data_ptr(),
        b.activation_epoch.data_ptr(), b.exit_epoch.data_ptr(), b.withdrawable_epoch.data_ptr(),
        b.slashed.data_ptr(), b.prev_participation.data_ptr(), b.curr_participation.data_ptr(),
        b.inactivity_scores.data_ptr(), b.slashings.data_ptr(), b.block_roots.data_ptr(),
        b.justification_bits.data_ptr(), ctypes.addressof(ckpts), buf_b[0].data_ptr(),
        buf_b[1].data_ptr(), buf_b[2].data_ptr(), buf_b[3].data_ptr(), n,
        build.stream_ptr(b.balances)), "epoch_phase1")
    torch.cuda.synchronize()
    for x, y in zip(buf_a, buf_b):
        assert torch.equal(x, y)
    for name, t in a.items():
        assert torch.equal(t, getattr(b, name)), name
    one, two = epoch_state_from_numpy(d, cuda), epoch_state_from_numpy(d, cuda)
    with _counted("epoch_combine", 3):
        aux = tepoch.sharded_epoch_step(cfg, one, _OneRank())
    want_aux = tepoch.epoch_sweep(cfg, two)
    for name, t in one.items():
        assert torch.equal(t, getattr(two, name)), name
    assert torch.equal(aux.flat(), want_aux.flat())


def test_epoch_combine_kernel_matches_plain(cuda):
    parts = torch.tensor(np.random.default_rng(2).integers(-2**62, 2**62, (5, 32)),
                         dtype=torch.int64)
    for stage in range(3):
        got = tepoch.epoch_combine(parts.to(cuda), stage)
        assert torch.equal(got.cpu(), tepoch.epoch_combine_plain(parts, stage)), stage


def test_mesh_path_world_one_on_nccl(cuda):
    """World size 1 on NCCL in this process: the G1 sum, both randomized
    checks and the sharded epoch step equal the single-device path's."""
    import torch.distributed as dist

    from consensus_specs_tpu_torch.parallel import collectives as C
    from consensus_specs_tpu_torch.parallel.mesh import (
        gather_epoch_state,
        make_mesh,
        shard_epoch_state,
    )

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        pts, _ = C.g1_small_multiples(1100, cuda)
        with _counted("point_sums", 3):
            got = C.g1_mesh_sum(pts, mesh)
        whole = torch.tensor([0, 1100], device=cuda)
        assert torch.equal(got, tbls.point_sums(pts, whole)[0])
        p, q, s = _bls_items(12, 12, 4)
        zb = bls_torch.zbits_from_ints(np.random.default_rng(5).integers(1, 2**63, 12)).to(cuda)
        neg = tbls.neg_g1_words(cuda)[None].expand(12, 2, 12).contiguous()
        bad = s.clone()
        bad[7] = s[6]
        for sig, want in ((s, True), (bad, False)):
            args = (q.to(cuda), p.to(cuda), sig.to(cuda))
            with _counted("f12_product"):
                ok = C.pairing_check_rlc_mesh(mesh, *args, neg, zb, p2_is_neg_g1=True)
            assert bool(ok) == bool(tbls.pairing_check_rlc(*args, zb)) == want
            assert bool(C.pairing_check_rlc_mesh(mesh, *args, neg, zb)) == want
        seg = torch.tensor([i % 3 for i in range(12)], device=cuda)
        pg, qg, sg = _bls_items(12, 3, 4)
        args = (qg[:3].to(cuda), pg.to(cuda), sg.to(cuda), zb, seg)
        assert bool(C.pairing_check_rlc_grouped_mesh(mesh, *args))
        assert bool(tbls.pairing_check_rlc(*args))
        cfg = EpochConfig.altair_mainnet()
        d = CASES["ejections_and_queue"](cfg, 4096, seed=3)
        shard = shard_epoch_state(epoch_state_from_numpy(d, cuda), mesh)
        ref = epoch_state_from_numpy(d, cuda)
        _, aux = tepoch.make_epoch_fn(cfg, mesh)(shard)
        want_aux = tepoch.epoch_sweep(cfg, ref)
        whole_state = gather_epoch_state(shard, mesh)
        for name, t in whole_state.items():
            assert torch.equal(t, getattr(ref, name)), name
        assert torch.equal(aux.flat(), want_aux.flat())
    finally:
        dist.destroy_process_group()
