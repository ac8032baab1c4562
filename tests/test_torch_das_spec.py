"""The port's COMPILED das fork (consensus_specs_tpu_torch/compiler, minimal
preset, device="cpu": `das_kernels` on the plain versions of K22 and K23)
against the JAX package's `get_spec("das", "minimal")` on the same seeded
inputs and the same KZG setup: `extend_data`, `recover_data`,
`reconstruct_extended_data`, `sample_data` and `verify_sample`, with exact
equality of every value (samples compared as SSZ bytes) and the same
exception types on the failure cases."""
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.compiler import get_spec as jax_get_spec
from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.crypto import kzg as jkzg
from consensus_specs_tpu.crypto import kzg_shim as jshim
from consensus_specs_tpu_torch.compiler import spec_compiler as tcomp
from consensus_specs_tpu_torch.crypto import bls, kzg, kzg_shim

N_SAMPLE = 16  # a blob of 16 points: 4 samples of 8 after the extension

REF_FNS = [
    "reverse_bit_order", "reverse_bit_order_list", "das_fft_extension",
    "extend_data", "unextend_data", "recover_data", "check_multi_kzg_proof",
    "construct_proofs", "commit_to_data", "sample_data", "verify_sample",
    "reconstruct_extended_data",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def specs():
    return tcomp.build_spec("das", "minimal", device="cpu"), jax_get_spec("das", "minimal")


@pytest.fixture(scope="module")
def live_kzg():
    """Both packages' KZG shims on the same setup points, BLS on."""
    setup = kzg.insecure_test_setup(2 * N_SAMPLE + 2)
    saved = bls.bls_active, jbls.bls_active
    bls.bls_active = jbls.bls_active = True
    kzg_shim.use_setup(setup)
    jshim.use_setup(jkzg.KZGSetup(g1=setup.g1, g2=setup.g2, length=setup.length))
    yield
    bls.bls_active, jbls.bls_active = saved
    kzg_shim.use_setup(None)
    jshim.use_setup(None)


def rand_data(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % kzg.MODULUS for _ in range(n)]


def test_all_reference_functions_compiled(specs):
    ours, theirs = specs
    for name in REF_FNS:
        assert callable(getattr(ours, name)), f"missing spec fn {name}"
    assert ours.DASSample.fields()["index"] is ours.SampleIndex
    assert int(ours.MAX_SAMPLES_PER_BLOCK) == int(theirs.MAX_SAMPLES_PER_BLOCK) == 2**12
    assert int(ours.POINTS_PER_SAMPLE) == int(theirs.POINTS_PER_SAMPLE) == 8


@pytest.mark.parametrize("n", [16, 32])
def test_extend_data_matches_jax(specs, n):
    ours, theirs = specs
    data = rand_data(n, n)
    published = ours.extend_data(data)
    assert published == theirs.extend_data(data)
    assert ours.unextend_data(published) == data
    assert ours.ifft(ours.reverse_bit_order_list(published))[n:] == [0] * n


def _subgroups(spec, published):
    pps = int(spec.POINTS_PER_SAMPLE)
    return [spec.reverse_bit_order_list(published[i * pps:(i + 1) * pps])
            for i in range(len(published) // pps)]


@pytest.mark.parametrize("seed", [1, 2])
def test_recover_data_matches_jax(specs, seed):
    ours, theirs = specs
    published = ours.extend_data(rand_data(seed, 32))
    subgroups = _subgroups(ours, published)
    count = len(subgroups)
    keep = set(random.Random(seed).sample(range(count), count // 2))
    partial = [sg if i in keep else None for i, sg in enumerate(subgroups)]
    assert ours.recover_data(partial) == theirs.recover_data(partial) == published
    few = [sg if i in sorted(keep)[:2] else None for i, sg in enumerate(subgroups)]
    with pytest.raises(AssertionError):
        ours.recover_data(few)
    with pytest.raises(AssertionError):
        theirs.recover_data(few)
    # more than half present, one value altered: not a rate-1/2 codeword
    extra = min(set(range(count)) - keep)
    bad = [list(sg) if i in keep or i == extra else None for i, sg in enumerate(subgroups)]
    bad[extra][0] = (bad[extra][0] + 1) % kzg.MODULUS
    with pytest.raises(AssertionError):
        ours.recover_data(bad)
    with pytest.raises(AssertionError):
        theirs.recover_data(bad)


def test_sample_verify_reconstruct_matches_jax(specs, live_kzg):
    ours, theirs = specs
    data = rand_data(3, N_SAMPLE)
    published = ours.extend_data(data)
    samples = ours.sample_data(ours.Slot(3), ours.Shard(1), published)
    jsamples = theirs.sample_data(theirs.Slot(3), theirs.Shard(1), published)
    assert [bytes(ours.serialize(s)) for s in samples] == \
        [bytes(theirs.serialize(s)) for s in jsamples]
    sample_count = 2 * N_SAMPLE // int(ours.POINTS_PER_SAMPLE)
    assert len(samples) == sample_count
    commitment = ours.commit_to_data(ours.ifft(ours.reverse_bit_order_list(published)))
    assert bytes(commitment) == bytes(theirs.commit_to_data(
        theirs.ifft(theirs.reverse_bit_order_list(published))))
    for s in samples:
        ours.verify_sample(s, sample_count, commitment)  # asserts internally
    half = [s if i % 2 == 0 else None for i, s in enumerate(samples)]
    jhalf = [s if i % 2 == 0 else None for i, s in enumerate(jsamples)]
    rec = ours.reconstruct_extended_data(half)
    assert rec == theirs.reconstruct_extended_data(jhalf) == published
    assert ours.unextend_data(rec) == data


def test_verify_sample_rejects_forgeries_as_jax(specs, live_kzg):
    ours, theirs = specs
    published = ours.extend_data(rand_data(4, N_SAMPLE))
    samples = ours.sample_data(ours.Slot(0), ours.Shard(0), published)
    sample_count = len(samples)
    commitment = ours.commit_to_data(ours.ifft(ours.reverse_bit_order_list(published)))
    s = samples[0]
    pps = int(ours.POINTS_PER_SAMPLE)
    tampered = ours.DASSample(
        slot=s.slot, shard=s.shard, index=s.index, proof=s.proof,
        data=ours.Vector[ours.BLSPoint, pps](*[(int(v) + 1) % kzg.MODULUS for v in s.data]))
    with pytest.raises(AssertionError):
        ours.verify_sample(tampered, sample_count, commitment)
    jtampered = theirs.DASSample.decode_bytes(bytes(ours.serialize(tampered)))
    with pytest.raises(AssertionError):
        theirs.verify_sample(jtampered, sample_count, commitment)
    wrong_index = ours.DASSample(slot=s.slot, shard=s.shard,
                                 index=ours.SampleIndex(int(s.index) + 1), proof=s.proof,
                                 data=s.data)
    with pytest.raises(AssertionError):
        ours.verify_sample(wrong_index, sample_count, commitment)
    oob = ours.DASSample(slot=s.slot, shard=s.shard, index=ours.SampleIndex(sample_count),
                         proof=s.proof, data=s.data)
    with pytest.raises(AssertionError):
        ours.verify_sample(oob, sample_count, commitment)


def test_custody_game_compiles_over_das():
    """sharding -> das -> custody_game: the custody overlay sees the das
    surface and binds the port's custody module."""
    custody = tcomp.build_spec("custody_game", "minimal", device="cpu")
    for name in REF_FNS:
        assert callable(getattr(custody, name))
    assert custody.legendre_bit(5, 7) == 0 and custody.legendre_bit(2, 7) == 1
    assert custody.get_custody_atoms(b"\x01" * 33) == [b"\x01" * 32, b"\x01" + b"\x00" * 31]
