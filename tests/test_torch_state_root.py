"""The port's device field roots (consensus_specs_tpu_torch/engine/
state_root.py, plain versions on the CPU) against the JAX package's
`state_root_fn()`: all 14 DEVICE_FIELDS roots bit-equal, on a synthetic
altair-mainnet state and on its successor after one epoch. The JAX
program compiles once per module, at the N = 1024 mainnet shape
tests/test_mesh_epoch.py already uses. Also `historical_batch_root`, the
chunk packing and the validator container roots against the JAX program
and hashlib."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.engine import epoch as jepoch
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.engine import state_root as jroot
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy, epoch_state_to_numpy
from consensus_specs_tpu_torch.engine.epoch import historical_batch_root, make_epoch_fn
from consensus_specs_tpu_torch.engine.state import EpochConfig
from consensus_specs_tpu_torch.engine.synthetic import synthetic_epoch_state_numpy
from consensus_specs_tpu_torch.kernels import build
from consensus_specs_tpu_torch.ops.sha256_host import merkle_root_hashlib, words_to_bytes

N = 1024
FAR = 2**64 - 1


def _static01(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)


def _jax_state(d: dict):
    return jstate.EpochState(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module", params=["synthetic", "after_one_epoch"])
def roots_pair(request):
    """(JAX roots, port roots) as numpy uint32 words, one pair per state."""
    cfg = EpochConfig.altair_mainnet()
    d = synthetic_epoch_state_numpy(cfg, N, seed=3)
    st = epoch_state_from_numpy(d, "cpu")
    if request.param == "after_one_epoch":
        st, _ = make_epoch_fn(cfg)(st)
        d = epoch_state_to_numpy(st)
    s01 = _static01(N)
    ref = jroot.state_root_fn()(_jax_state(d), jnp.asarray(s01))
    ours = troot.field_roots(st, torch.from_numpy(s01.view(np.int32)))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy().view(np.uint32) for k, v in ours.items()})


@pytest.mark.parametrize("field", sorted(jroot.DEVICE_FIELDS))
def test_field_root_matches_jax(roots_pair, field):
    ref, ours = roots_pair
    assert set(ours) == set(ref) == troot.DEVICE_FIELDS
    np.testing.assert_array_equal(ours[field], ref[field])


def test_historical_batch_root_matches_jax_and_hashlib():
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, 8, seed=4)
    ours = historical_batch_root(torch.from_numpy(d["block_roots"].view(np.int32)),
                                 torch.from_numpy(d["state_roots"].view(np.int32)))
    ref = jepoch.historical_batch_root(jnp.asarray(d["block_roots"]), jnp.asarray(d["state_roots"]))
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), np.asarray(ref))
    br = merkle_root_hashlib([words_to_bytes(r) for r in d["block_roots"]])
    sr = merkle_root_hashlib([words_to_bytes(r) for r in d["state_roots"]])
    assert words_to_bytes(ours.numpy()) == hashlib.sha256(br + sr).digest()


@pytest.mark.parametrize("n", [1, 3, 4, 9])
def test_u64_chunk_packing_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**64, n, dtype=np.uint64)
    a[0] = FAR
    ours = troot._u64_chunk_words(torch.from_numpy(a.view(np.int64)))
    ref = jax.jit(jroot._u64_chunk_words)(jnp.asarray(a))
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("n", [1, 31, 32, 70])
def test_u8_chunk_packing_matches_jax(n):
    a = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    ours = troot._u8_chunk_words(torch.from_numpy(a))
    ref = jax.jit(jroot._u8_chunk_words)(jnp.asarray(a))
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), np.asarray(ref))


def test_validator_container_roots_match_hashlib():
    """Each container root equals the SSZ 8-leaf tree built with hashlib:
    uint64 leaves little-endian, the boolean leaf one byte."""
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, 5, seed=6)
    d["slashed"][:] = [True, False, True, False, False]
    d["exit_epoch"][1] = np.uint64(FAR)
    st = epoch_state_from_numpy(d, "cpu")
    s01 = _static01(5, seed=2)
    roots = troot.validator_roots(torch.from_numpy(s01.view(np.int32)), st)

    def u64_leaf(v):
        return int(v).to_bytes(8, "little") + b"\x00" * 24

    for i in range(5):
        leaves = [words_to_bytes(s01[i, :8]), words_to_bytes(s01[i, 8:]),
                  u64_leaf(d["effective_balance"][i]),
                  bytes([int(d["slashed"][i])]) + b"\x00" * 31,
                  u64_leaf(d["activation_eligibility_epoch"][i]),
                  u64_leaf(d["activation_epoch"][i]),
                  u64_leaf(d["exit_epoch"][i]), u64_leaf(d["withdrawable_epoch"][i])]
        assert words_to_bytes(roots[i].numpy()) == merkle_root_hashlib(leaves)


def test_field_roots_use_no_kernel_on_cpu():
    cfg = EpochConfig.altair_minimal()
    st = epoch_state_from_numpy(synthetic_epoch_state_numpy(cfg, 8, seed=0), "cpu")
    before = dict(build.LAUNCHES)
    roots = troot.field_roots(st, torch.from_numpy(_static01(8).view(np.int32)))
    assert build.LAUNCHES == before
    assert all(r.shape == (8,) and r.dtype == torch.int32 for r in roots.values())
