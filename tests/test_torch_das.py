"""The port's DAS module (consensus_specs_tpu_torch/crypto/das.py, its NTTs on
the plain versions of K22 and K23 with device="cpu") against the JAX
package's crypto/das.py with use_device=True (its jitted NTTs) and
use_device=False (the host DFT): the cases of tests/test_das.py, on the same
seeded inputs and the same KZG setup, with exact equality of every int,
sample and proof, and the same exception types on the failure cases. Also
the public names of the port's das, kzg_shim and custody copies, and the
custody functions on seeded inputs."""
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import custody as jcustody
from consensus_specs_tpu.crypto import das as jdas
from consensus_specs_tpu.crypto import kzg as jkzg
from consensus_specs_tpu.crypto import kzg_shim as jshim
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto import custody, das, kzg, kzg_shim

N = 8
PPS = 4  # points a sample, as tests/test_das.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setups():
    """The port's insecure setup and the same points as the JAX package's
    KZGSetup (the two oracles share their point representation)."""
    ours = kzg.insecure_test_setup(2 * N + 2)
    return ours, jkzg.KZGSetup(g1=ours.g1, g2=ours.g2, length=ours.length)


def rand_data(seed, n=N):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % das.MODULUS for _ in range(n)]


def _affine(pt):
    return oracle.pt_to_affine(oracle.FP_FIELD, pt)


def _public(mod) -> set:
    return {k for k in vars(mod) if not k.startswith("_")
            and type(getattr(mod, k)).__name__ != "module"}


@pytest.mark.parametrize("port, jax_mod", [(das, jdas), (kzg_shim, jshim), (custody, jcustody)])
def test_public_names_match_jax(port, jax_mod):
    assert _public(port) == _public(jax_mod)


def test_reverse_bit_order_matches_jax():
    for n in (1, 2, 8, 64):
        assert das.reverse_bit_order(n) == jdas.reverse_bit_order(n)
    data = rand_data(0, 16)
    assert das.to_rbo(data) == jdas.to_rbo(data)
    assert das.from_rbo(das.to_rbo(data)) == data


@pytest.mark.parametrize("n", [N, 32])
def test_extension_matches_jax_device_and_host(n):
    data = rand_data(n, n)
    full = das.extend_data(data, device="cpu")
    assert full == jdas.extend_data(data, use_device=True)
    assert full == jdas.extend_data(data, use_device=False)
    assert full == das.extend_data(data, use_device=False)
    assert full[0::2] == data
    assert das.data_to_coeffs(data, device="cpu") == jdas.data_to_coeffs(data)
    assert das.das_fft_extension(data, device="cpu") == full[1::2]


def test_extension_is_low_degree():
    full = das.extend_data(rand_data(1), device="cpu")
    assert all(c == 0 for c in das.host_ntt(full, inverse=True)[N:])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_recover_from_any_half_matches_jax(seed):
    r = random.Random(seed)
    full = das.extend_data(rand_data(seed), device="cpu")
    keep = {i: full[i] for i in r.sample(range(2 * N), N)}
    rec = das.recover_data(keep, 2 * N, device="cpu")
    assert rec == full
    assert rec == jdas.recover_data(keep, 2 * N, use_device=True)
    assert rec == jdas.recover_data(keep, 2 * N, use_device=False)
    assert das.recover_data({i: full[i] for i in range(2 * N)}, 2 * N, device="cpu") == full


@pytest.mark.parametrize("use_device", [True, False])
def test_recover_rejects_insufficient_samples(use_device):
    full = das.extend_data(rand_data(4), device="cpu")
    few = {i: full[i] for i in range(N - 1)}
    with pytest.raises(AssertionError):
        das.recover_data(few, 2 * N, use_device, device="cpu")
    with pytest.raises(AssertionError):
        jdas.recover_data(few, 2 * N, use_device)


@pytest.mark.parametrize("use_device", [True, False])
def test_recover_detects_corrupt_sample(use_device):
    full = das.extend_data(rand_data(5), device="cpu")
    provided = {i: full[i] for i in range(N + 2)}
    provided[0] = (provided[0] + 1) % das.MODULUS
    with pytest.raises(AssertionError):
        das.recover_data(provided, 2 * N, use_device, device="cpu")
    with pytest.raises(AssertionError):
        jdas.recover_data(provided, 2 * N, use_device)


def test_sample_verify_reconstruct_matches_jax(setups):
    ours, theirs = setups
    data = rand_data(6)
    commitment, samples = das.sample_data(ours, data, PPS, device="cpu")
    jcommitment, jsamples = jdas.sample_data(theirs, data, PPS)
    assert _affine(commitment) == _affine(jcommitment)
    assert [(s.index, s.values, _affine(s.proof)) for s in samples] == \
        [(s.index, s.values, _affine(s.proof)) for s in jsamples]
    assert len(samples) == 2 * N // PPS
    assert all(das.verify_sample(ours, commitment, s, 2 * N, PPS) for s in samples)
    half = samples[: len(samples) // 2]
    rec = das.reconstruct_extended_data(half, 2 * N, PPS, device="cpu")
    assert rec == das.extend_data(data, device="cpu")
    assert rec == jdas.reconstruct_extended_data(jsamples[: len(jsamples) // 2], 2 * N, PPS)


def test_verify_sample_rejects_forgeries(setups):
    ours, _ = setups
    commitment, samples = das.sample_data(ours, rand_data(7), PPS, device="cpu")
    s = samples[0]
    tampered = das.Sample(index=s.index, values=tuple((v + 1) % das.MODULUS for v in s.values),
                          proof=s.proof)
    assert not das.verify_sample(ours, commitment, tampered, 2 * N, PPS)
    wrong_slot = das.Sample(index=s.index + 1, values=s.values, proof=s.proof)
    assert not das.verify_sample(ours, commitment, wrong_slot, 2 * N, PPS)
    other, _ = das.sample_data(ours, rand_data(8), PPS, device="cpu")
    assert not das.verify_sample(ours, other, s, 2 * N, PPS)
    # malformed: clean rejections before any pairing
    assert not das.verify_sample(ours, commitment, das.Sample(index=s.index,
                                                              values=s.values[:-1],
                                                              proof=s.proof), 2 * N, PPS)
    assert not das.verify_sample(ours, commitment, das.Sample(index=-1, values=s.values,
                                                              proof=s.proof), 2 * N, PPS)


@pytest.mark.parametrize("index, count", [(-1, PPS), (2 * N // PPS, PPS), (0, PPS - 1)])
def test_reconstruct_rejects_malformed_samples_as_jax(index, count):
    values = tuple(range(count))
    with pytest.raises(ValueError):
        das.reconstruct_extended_data([das.Sample(index=index, values=values, proof=None)],
                                      2 * N, PPS, device="cpu")
    with pytest.raises(ValueError):
        jdas.reconstruct_extended_data([jdas.Sample(index=index, values=values, proof=None)],
                                       2 * N, PPS)


def test_custody_functions_match_jax():
    rng = np.random.default_rng(9)
    data = rng.bytes(100)
    assert custody.get_custody_atoms(data) == jcustody.get_custody_atoms(data)
    secrets = [int.from_bytes(rng.bytes(32), "little") for _ in range(3)]
    atoms = custody.get_custody_atoms(data)
    assert custody.universal_hash_function(atoms, secrets) == \
        jcustody.universal_hash_function(atoms, secrets)
    values = [int.from_bytes(rng.bytes(32), "little") for _ in range(16)]
    values += [0, custody.CUSTODY_PRIME]
    assert custody.legendre_bits_batch(values) == jcustody.legendre_bits_batch(values)
    for period, index in ((0, 5), (3, 70000)):
        assert custody.get_randao_epoch_for_custody_period(period, index) == \
            jcustody.get_randao_epoch_for_custody_period(period, index)
        assert custody.get_custody_period_for_validator(index, 12345 * period) == \
            jcustody.get_custody_period_for_validator(index, 12345 * period)
