"""The port's one-block sha256 and swap-or-not shuffle
(consensus_specs_tpu_torch/ops/sha256.py `sha256_1block`, ops/shuffle.py;
plain versions on the CPU) against the JAX package's `sha256_1block` and
`shuffled_index_map` (jitted on the CPU), its host numpy/hashlib twin
`compute_shuffled_indices_np`, hashlib, and the compiled spec's scalar
`compute_shuffled_index`. Every comparison is exact."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.compiler.spec_compiler import get_spec
from consensus_specs_tpu.ops import sha256_jax
from consensus_specs_tpu.ops import shuffle as jshuffle
from consensus_specs_tpu_torch.ops import sha256 as tsha
from consensus_specs_tpu_torch.ops import shuffle as tshuffle
from consensus_specs_tpu_torch.ops.sha256_host import bytes_to_words, words_to_bytes

SIZES = [1, 2, 255, 256, 257, 1000]


def _padded_block(msg: bytes) -> np.ndarray:
    """(16,) uint32 words of the one-block sha256 padding of msg (< 56 B)."""
    block = msg + b"\x80" + b"\x00" * (55 - len(msg)) + (8 * len(msg)).to_bytes(8, "big")
    return bytes_to_words(block)


def _seed(n: int, rounds: int) -> bytes:
    return hashlib.sha256(n.to_bytes(4, "little") + bytes([rounds])).digest()


def test_sha256_1block_plain_matches_jax_and_hashlib():
    """Every one-block length, with the 33-, 37-, 40- and 44-byte messages
    of the shuffle pivots and sources, the sampler and the seed among them."""
    rng = np.random.default_rng(11)
    msgs = [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for size in range(56)]
    msgs += [b"\xff" * 55, b"\x00" * 44]
    w = np.stack([_padded_block(m) for m in msgs])
    t = torch.from_numpy(w.view(np.int32).copy())
    plain = tsha.sha256_1block_plain(t)
    assert torch.equal(tsha.sha256_1block(t), plain)  # the wrapper on a CPU tensor
    out = plain.numpy().view(np.uint32)
    ref = np.asarray(jax.jit(sha256_jax.sha256_1block)(jnp.asarray(w)))
    np.testing.assert_array_equal(out, ref)
    for m, digest in zip(msgs, out):
        assert words_to_bytes(digest) == hashlib.sha256(m).digest()


@pytest.mark.parametrize("rounds", [10, 90])
@pytest.mark.parametrize("n", SIZES)
def test_shuffle_matches_jax_and_host_twin(n, rounds):
    seed = _seed(n, rounds)
    words = tshuffle.seed_words_tensor(seed, "cpu")
    got = tshuffle.shuffled_index_map(n, words, rounds).numpy().view(np.uint32)
    ref = np.asarray(jshuffle.shuffled_index_map(n, jnp.asarray(jshuffle.seed_to_words(seed)),
                                                 rounds))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jshuffle.compute_shuffled_indices_np(n, seed, rounds))
    np.testing.assert_array_equal(got, tshuffle.compute_shuffled_indices_np(n, seed, rounds))
    np.testing.assert_array_equal(got, tshuffle.compute_shuffled_indices(n, seed, rounds, "cpu"))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("n", [1, 255, 257, 1000])
def test_round_pivots_and_sources_match_jax(n):
    seed, rounds = _seed(n, 90), 90
    words = tshuffle.seed_words_tensor(seed, "cpu")
    jw = jnp.asarray(jshuffle.seed_to_words(seed))
    buckets = (n + 255) // 256
    pivots = tshuffle.round_pivots(words, n, rounds, tsha.sha256_1block)
    np.testing.assert_array_equal(pivots.numpy(),
                                  np.asarray(jshuffle._round_pivots(jw, n, rounds)))
    sources = tshuffle.round_sources(words, rounds, buckets, tsha.sha256_1block)
    np.testing.assert_array_equal(sources.numpy().view(np.uint32),
                                  np.asarray(jshuffle._round_sources(jw, rounds, buckets)))
    # the rounds alone, fed the same pivots and sources, give the JAX map
    got = tshuffle.shuffle_rounds(pivots, sources, n).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jshuffle.shuffled_index_map(n, jw, rounds)))


@pytest.mark.parametrize("fork,preset", [("phase0", "minimal"), ("phase0", "mainnet")])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257])
def test_shuffle_matches_compiled_spec(fork, preset, n):
    spec = get_spec(fork, preset)
    rounds = int(spec.SHUFFLE_ROUND_COUNT)
    seed = _seed(n, rounds)
    got = tshuffle.compute_shuffled_indices(n, seed, rounds, "cpu")
    want = [int(spec.compute_shuffled_index(spec.uint64(i), spec.uint64(n), spec.Bytes32(seed)))
            for i in range(n)]
    assert got.tolist() == want


def test_shuffle_plain_entry_equals_wrapper():
    words = tshuffle.seed_words_tensor(b"\x5a" * 32, "cpu")
    assert torch.equal(tshuffle.shuffled_index_map(777, words, 90),
                       tshuffle.shuffled_index_map_plain(777, words, 90))


def test_shuffle_rejects_bad_arguments():
    words = tshuffle.seed_words_tensor(b"\x00" * 32, "cpu")
    with pytest.raises(ValueError):
        tshuffle.shuffled_index_map(0, words, 10)
    with pytest.raises(ValueError):
        tshuffle.shuffled_index_map(2**31, words, 10)
    with pytest.raises(ValueError):
        tshuffle.seed_to_words(b"\x00" * 31)
    assert tshuffle.compute_shuffled_indices(0, b"\x00" * 32, 10, "cpu").shape == (0,)
    assert tshuffle.compute_shuffled_indices_np(0, b"\x00" * 32, 10).shape == (0,)
