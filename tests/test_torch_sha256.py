"""The port's sha256 (consensus_specs_tpu_torch/ops/sha256.py) against the
JAX package's `sha256_64B_words`, `merkle_parent_level` and `sha256_1block`
(jitted on the CPU) and against hashlib. All comparisons are exact: the
arithmetic is 32-bit integer throughout."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256_jax
from consensus_specs_tpu.ssz.merkle import zerohashes
from consensus_specs_tpu_torch.kernels import build
from consensus_specs_tpu_torch.ops import sha256 as tsha
from consensus_specs_tpu_torch.ops import sha256_host


def _messages(m: int, seed: int) -> np.ndarray:
    """(m, 16) uint32 words: seeded random rows plus an all-zero row and an
    all-0xFFFFFFFF row (the carry and rotate extremes)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (m, 16), dtype=np.uint64).astype(np.uint32)
    w[0] = 0
    w[1:2] = 0xFFFFFFFF
    return w


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("m,seed", [(1, 0), (2, 1), (64, 2), (257, 3)])
def test_sha256_64B_words_matches_jax(m, seed):
    w = _messages(m, seed)
    ref = np.asarray(jax.jit(sha256_jax.sha256_64B_words)(jnp.asarray(w)))
    np.testing.assert_array_equal(_np(tsha.sha256_64B_words(_t(w))), ref)


def test_sha256_64B_words_matches_hashlib():
    w = _messages(16, 4)
    out = _np(tsha.sha256_64B_words(_t(w)))
    for row, digest in zip(w, out):
        msg = sha256_host.words_to_bytes(row)
        assert sha256_host.words_to_bytes(digest) == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("levels", [1, 3, 6])
def test_merkle_parent_level_matches_jax(levels):
    nodes = _messages(1 << levels, 5)[:, :8].copy()
    nodes = np.concatenate([nodes, _messages(1 << levels, 6)[:, :8]])
    jn, tn = jnp.asarray(nodes), _t(nodes)
    level = jax.jit(sha256_jax.merkle_parent_level)
    while jn.shape[0] > 1:
        jn, tn = level(jn), tsha.merkle_parent_level(tn)
        np.testing.assert_array_equal(_np(tn), np.asarray(jn))


def test_sha256_1block_matches_jax_and_hashlib():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (9, 40), dtype=np.uint8)
    blocks = np.zeros((9, 64), dtype=np.uint8)
    blocks[:, :40] = data
    blocks[:, 40] = 0x80
    blocks[:, 62:64] = np.frombuffer((40 * 8).to_bytes(2, "big"), dtype=np.uint8)
    w = np.stack([sha256_host.bytes_to_words(b.tobytes()) for b in blocks])
    out = _np(tsha.sha256_1block(_t(w)))
    np.testing.assert_array_equal(out, np.asarray(jax.jit(sha256_jax.sha256_1block)(jnp.asarray(w))))
    for row, digest in zip(data, out):
        assert sha256_host.words_to_bytes(digest) == hashlib.sha256(row.tobytes()).digest()


def test_host_constants_and_zero_hashes_match_reference():
    from consensus_specs_tpu.ops.sha256_np import _H0, _K

    np.testing.assert_array_equal(sha256_host._K, _K)
    np.testing.assert_array_equal(sha256_host._H0, _H0)
    assert sha256_host.ZERO_HASHES[:65] == zerohashes[:65]
    zw = sha256_host.zero_hash_words()
    assert sha256_host.words_to_bytes(zw[40]) == zerohashes[40]


def test_bytes_words_round_trip():
    data = bytes(range(256)) * 2
    words = sha256_host.bytes_to_words(data)
    np.testing.assert_array_equal(words, sha256_jax.bytes_to_words(data))
    assert sha256_host.words_to_bytes(words) == data
    assert sha256_host.words_to_bytes(words.view(np.int32)) == data


def test_merkle_root_hashlib_matches_jax_fold():
    nodes = _messages(8, 8)[:, :8].copy()
    jn = jnp.asarray(nodes)
    while jn.shape[0] > 1:
        jn = sha256_jax.merkle_parent_level(jn)
    chunks = [sha256_host.words_to_bytes(r) for r in nodes]
    assert sha256_host.merkle_root_hashlib(chunks) == sha256_host.words_to_bytes(np.asarray(jn[0]))
    with pytest.raises(ValueError):
        sha256_host.merkle_root_hashlib(chunks[:3])


def test_cpu_tensor_takes_plain_version_without_launch():
    w = _t(_messages(4, 9))
    before = dict(build.LAUNCHES)
    np.testing.assert_array_equal(_np(tsha.sha256_64B_words(w)),
                                  _np(tsha.sha256_64B_words_plain(w)))
    assert build.LAUNCHES == before
