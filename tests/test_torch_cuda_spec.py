"""Card-only tests of the port's spec path: kernel K19 bit-equal to its
plain version, and the routed minimal-preset `state_transition` on the card
equal to the same run on the CPU.

Like tests/test_torch_cuda.py this file imports neither jax nor the JAX
package; on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_spec.py

Without a card every test skips with its reason (decided in the fixture).
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch.compiler import build_spec
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.engine import epoch as tepoch
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.engine.routing import routed_spec
from consensus_specs_tpu_torch.kernels import build
from consensus_specs_tpu_torch.testlib import big_state
from consensus_specs_tpu_torch.testlib import block as tblock

pytestmark = pytest.mark.cuda

SLOTS = (62, 64, 67, 72, 73)  # minimal: epoch 8 rotates the sync committee, 9 does not


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k,c", [(1, 1), (2, 2), (4, 64), (256, 64), (64, 1024), (3, 2048),
                                 (1, 16384)])
def test_tree_root_batch_kernel_matches_plain(cuda, k, c):
    rng = np.random.default_rng(k * 100_003 + c)
    words = rng.integers(0, 2**32, (k, c, 8), dtype=np.uint64).astype(np.uint32)
    chunks = torch.from_numpy(words.view(np.int32)).to(cuda)
    build.reset_launches()
    got = troot.tree_root_batch(chunks)
    launches = build.LAUNCHES["tree_root_batch"]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), troot.tree_root_batch_plain(chunks.cpu()))
    assert launches == -(-(c - 1).bit_length() // troot.TREE_FOLD_MAX_LEVELS)


def test_tree_root_batch_is_the_historical_batch_root(cuda):
    rng = np.random.default_rng(8192)
    words = rng.integers(0, 2**32, (2, 8192, 8), dtype=np.uint64).astype(np.uint32)
    block_roots, state_roots = (torch.from_numpy(w.view(np.int32)).to(cuda) for w in words)
    assert torch.equal(tepoch.historical_append_root(block_roots, state_roots),
                       tepoch.historical_batch_root(block_roots, state_roots))


def _chain(device, bls_on_slot=None):
    """The routed minimal chain of SLOTS on `device`: the post-block state
    root of each block (BLS on only for `bls_on_slot`)."""
    spec = build_spec("altair", "minimal", device=device)
    bls.use_device(str(device))
    pre = big_state.synthetic_beacon_state(spec, 64, slot=SLOTS[0] - 1)
    prop = pre.copy()
    roots = []
    was = bls.bls_active
    try:
        with routed_spec(spec, device=device):
            for slot in SLOTS:
                signed = tblock.propose_block(spec, prop, slot, committees=(0,))
                bls.bls_active = slot == bls_on_slot
                with bls.deferred_verification():
                    spec.state_transition(pre, signed, validate_result=True)
                bls.bls_active = was
                roots.append(bytes(spec.hash_tree_root(pre)))
    finally:
        bls.bls_active = was
        bls.use_device("cuda")
    return roots, pre


def test_routed_minimal_state_transition_on_card_equals_cpu(cuda):
    build.reset_launches()
    card_roots, card_state = _chain(cuda, bls_on_slot=SLOTS[2])
    launches = dict(build.LAUNCHES)
    cpu_roots, _ = _chain(torch.device("cpu"))
    assert card_roots == cpu_roots
    assert len(card_state.historical_roots) == 1
    for name in ("tree_root_batch", "epoch_sweep", "shuffle_rounds", "sha256_1block",
                 "point_sums", "miller_loop", "final_exp"):
        assert launches[name] > 0, name
