"""Kernel K19's plain version, `engine/state_root.tree_root_batch_plain`,
against the JAX package's `tree_root_batch` (engine/state_root.py:132) at
(K, C) = (1, 1), (2, 2), (4, 64) and (1, 16,384), the historical append's
shape, and against `historical_batch_root` (the port's and the JAX
package's). Seeded words from numpy; bit-exact."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.engine import epoch as jepoch
from consensus_specs_tpu.engine import state_root as jroot
from consensus_specs_tpu_torch.engine import epoch as tepoch
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.ops.sha256_host import merkle_root_hashlib, words_to_bytes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' tensors are small, so one
    thread is faster, and parallel test workers do not oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("k,c", [(1, 1), (2, 2), (4, 64), (1, 16384)])
def test_tree_root_batch_plain_matches_jax(k, c):
    words = _words((k, c, 8), k * 1000 + c)
    ours = troot.tree_root_batch(torch.from_numpy(words.view(np.int32)))
    ref = np.asarray(jroot.tree_root_batch(jnp.asarray(words)))
    assert np.array_equal(ours.numpy().view(np.uint32), ref)
    assert torch.equal(ours, troot.tree_root_batch_plain(torch.from_numpy(words.view(np.int32))))
    for i in range(min(k, 2)):
        assert words_to_bytes(ours[i].numpy()) == (
            merkle_root_hashlib([words_to_bytes(r) for r in words[i]]) if c > 1
            else words_to_bytes(words[i, 0]))


def test_historical_append_root_is_historical_batch_root():
    words = _words((2, 64, 8), 77)  # minimal SLOTS_PER_HISTORICAL_ROOT
    block_roots, state_roots = (torch.from_numpy(w.view(np.int32)) for w in words)
    ours = tepoch.historical_append_root(block_roots, state_roots)
    assert torch.equal(ours, tepoch.historical_batch_root(block_roots, state_roots))
    ref = np.asarray(jepoch.historical_batch_root(jnp.asarray(words[0]), jnp.asarray(words[1])))
    assert np.array_equal(ours.numpy().view(np.uint32), ref)
    top = b"".join(merkle_root_hashlib([words_to_bytes(r) for r in w]) for w in words)
    assert words_to_bytes(ours.numpy()) == hashlib.sha256(top).digest()


@pytest.mark.parametrize("bad", [(3,), (1, 3, 8), (2, 4, 7)])
def test_tree_root_batch_rejects_bad_shapes(bad):
    with pytest.raises(ValueError):
        troot.tree_root_batch(torch.zeros(bad, dtype=torch.int32))
