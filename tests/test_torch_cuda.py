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
from consensus_specs_tpu_torch.engine import state_root as troot
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
