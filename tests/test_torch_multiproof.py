"""Kernels K20 + K21's plain version, `ops/multiproof.sibling_rows_batch_plain`,
and the host entry `engine/state_root.multiproof_batch(device="cpu")` against
the JAX package's `sibling_rows_batch` (ops/multiproof_jax.py:74) at
(K, C, Q) = (1, 1, 1), (2, 2, 4), (4, 64, 16) and (1, 2^14, 64), with root,
interior, leaf and pad gindices and tree slots repeated across queries;
every leaf branch against the port's `build_chunk_proof`; and the wrapper's
input checks (which the JAX function leaves to its caller). Seeded words
from numpy; bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops.multiproof_jax import sibling_rows_batch as jax_sibling_rows
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.ops import multiproof as tmp
from consensus_specs_tpu_torch.ops.sha256_host import words_to_bytes
from consensus_specs_tpu_torch.ssz.merkle import merkleize_chunks
from consensus_specs_tpu_torch.ssz.proofs import build_chunk_proof


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain version's tensors are small, and
    parallel test workers do not oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(k, c, q, seed):
    """Seeded chunk words and queries: the root, interior nodes, leaves and
    a pad (a root query on tree 0, as the scheduler pads), tree slots
    repeated across queries."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (k, c, 8), dtype=np.uint64).astype(np.uint32)
    tree_ids = rng.integers(0, k, q).astype(np.int32)
    gidx = rng.integers(1, 2 * c, q).astype(np.int32)
    fixed = [(0, 1), (k - 1, 2 * c - 1), (0, max(c // 2, 1)), (k - 1, c)]
    for i, (t, g) in enumerate(fixed[:q]):
        tree_ids[i], gidx[i] = t, g
    if q >= 2:
        tree_ids[-1] = tree_ids[-2]  # one tree slot serves two queries
    return words, tree_ids, gidx


SHAPES = [(1, 1, 1), (2, 2, 4), (4, 64, 16), (1, 1 << 14, 64)]


@pytest.mark.parametrize("k,c,q", SHAPES)
def test_sibling_rows_plain_and_entry_match_jax(k, c, q):
    words, tree_ids, gidx = _inputs(k, c, q, seed=k * 1000 + c + q)
    ref = [np.asarray(a) for a in jax_sibling_rows(
        jnp.asarray(words), jnp.asarray(tree_ids), jnp.asarray(gidx))]
    plain = tmp.sibling_rows_batch_plain(torch.from_numpy(words.view(np.int32)),
                                         torch.from_numpy(tree_ids), torch.from_numpy(gidx))
    wrapped = tmp.sibling_rows_batch(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(tree_ids), torch.from_numpy(gidx))
    entry = troot.multiproof_batch(words, tree_ids, gidx, device="cpu")
    for name, r, p, w, e in zip(("siblings", "nodes", "roots"), ref, plain, wrapped, entry):
        assert p.shape == r.shape and e.shape == r.shape, name
        assert np.array_equal(p.numpy().view(np.uint32), r), name
        assert torch.equal(w, p), name
        assert e.dtype == np.uint32 and np.array_equal(e, r), name


@pytest.mark.parametrize("k,c,q", SHAPES[1:3])
def test_sibling_rows_are_host_branches(k, c, q):
    """Every query's first depth(g) sibling rows are `build_chunk_proof`'s
    branch, the rows past it zero, its node the subtree's root and each
    root `merkleize_chunks`' root."""
    words, tree_ids, gidx = _inputs(k, c, q, seed=7 + c)
    sib, nodes, roots = troot.multiproof_batch(words, tree_ids, gidx, device="cpu")
    chunks = [[words_to_bytes(r) for r in tree] for tree in words]
    for t in range(k):
        assert words_to_bytes(roots[t]) == merkleize_chunks(chunks[t])
    for i, (t, g) in enumerate(zip(tree_ids, gidx)):
        d = int(g).bit_length() - 1
        branch = [words_to_bytes(r) for r in sib[i, :d]]
        assert branch == build_chunk_proof(chunks[t], int(g))
        assert not sib[i, d:].any()
        if g >= c:
            assert words_to_bytes(nodes[i]) == chunks[t][g - c]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", [
    "chunks_dtype", "chunks_rank", "chunks_width", "chunks_not_pow2", "ids_dtype",
    "gidx_dtype", "shapes_differ", "tree_negative", "tree_too_big", "gindex_zero",
    "gindex_too_big", "not_contiguous"])
def test_sibling_rows_wrapper_rejects(case):
    words, tree_ids, gidx = _inputs(2, 4, 4, seed=3)
    chunks, ids, g = _t(words.view(np.int32)), _t(tree_ids), _t(gidx)
    if case == "chunks_dtype":
        chunks = chunks.long()
    elif case == "chunks_rank":
        chunks = chunks.reshape(8, 8)
    elif case == "chunks_width":
        chunks = chunks[..., :7].contiguous()
    elif case == "chunks_not_pow2":
        chunks = chunks[:, :3].contiguous()
    elif case == "ids_dtype":
        ids = ids.long()
    elif case == "gidx_dtype":
        g = g.long()
    elif case == "shapes_differ":
        ids = ids[:3].contiguous()
    elif case == "tree_negative":
        ids[0] = -1
    elif case == "tree_too_big":
        ids[0] = 2
    elif case == "gindex_zero":
        g[1] = 0
    elif case == "gindex_too_big":
        g[1] = 8
    elif case == "not_contiguous":
        chunks = torch.from_numpy(np.concatenate([words.view(np.int32)] * 2, axis=1))[:, ::2]
    with pytest.raises(ValueError):
        tmp.sibling_rows_batch(chunks, ids, g)
    with pytest.raises(ValueError):
        tmp.sibling_rows_batch_plain(chunks, ids, g)


def test_multiproof_batch_needs_a_card_unless_asked_for_cpu():
    words, tree_ids, gidx = _inputs(1, 2, 2, seed=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs the kernels")
    with pytest.raises(RuntimeError):
        troot.multiproof_batch(words, tree_ids, gidx)
