"""The port's batched KZG verification (consensus_specs_tpu_torch/crypto/
kzg_batch.py) on the CPU, where K13 and the pairing kernels run their plain
versions, against the JAX package's kzg_batch (its host MSMs and its device
pairing on the CPU), and the seeded KZG inputs of crypto/msm_synthetic.py
against the copied prover.

Tolerance: exact (points and verdicts compared for equality). The batches are
small (3 blobs of 8 points, samples of 4, a setup of 16 powers); inputs come
from numpy seeds, the batch randomizers from the CSPRNG on both sides.
"""
import pytest
import torch

from consensus_specs_tpu.crypto import kzg as jax_kzg
from consensus_specs_tpu.crypto import kzg_batch as jax_kzg_batch
from consensus_specs_tpu.ops import fr_host as jax_fr_host
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto import kzg, kzg_batch, msm_synthetic
from consensus_specs_tpu_torch.ops import fr_host

F1 = oracle.FP_FIELD


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain field's tensors are small."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def small():
    return msm_synthetic.kzg_inputs(7, blobs=3, points=8, m=4, setup_size=16)


def _aff(p):
    return oracle.pt_to_affine(F1, p)


def _verdicts(setup, items):
    """(port on the CPU, JAX with host MSMs)"""
    return (kzg_batch.batch_verify_samples(setup, items, device="cpu"),
            jax_kzg_batch._verify_samples_impl(setup, items, use_device=False))


def test_copied_host_modules_match_jax_package(small):
    setup, coeffs = small["setup"], small["coeffs"][0]
    assert (fr_host.R_MODULUS, fr_host.root_of_unity(16)) == (
        jax_fr_host.R_MODULUS, jax_fr_host.root_of_unity(16))
    assert fr_host.host_ntt(coeffs) == jax_fr_host.host_ntt(coeffs)
    jax_setup = jax_kzg.insecure_test_setup(16)
    assert (setup.g1, setup.g2) == (jax_setup.g1, jax_setup.g2)
    assert kzg.commit(setup, coeffs) == jax_kzg.commit(jax_setup, coeffs)
    shift = small["samples"][1][1]
    assert kzg.prove_coset(setup, coeffs, shift, 4) == jax_kzg.prove_coset(jax_setup, coeffs,
                                                                           shift, 4)


def test_synthetic_items_match_the_prover(small):
    """One scalar product from the public secret = the prover's MSM."""
    setup, k = small["setup"], small["points_count"]
    for coeffs, (c, shift, ys, proof), (c2, dproof) in zip(
            small["coeffs"], small["samples"], small["degree_proofs"]):
        assert c == c2 and _aff(c) == _aff(kzg.commit(setup, coeffs))
        want_proof, want_ys = kzg.prove_coset(setup, coeffs, shift, len(ys))
        assert ys == want_ys and _aff(proof) == _aff(want_proof)
        assert _aff(dproof) == _aff(kzg.prove_degree_bound(setup, coeffs, k))
        assert kzg.verify_coset(setup, c, shift, ys, proof)


def test_batch_accepts_like_jax(small):
    assert _verdicts(small["setup"], small["samples"]) == (True, True)


def test_batch_rejects_a_tampered_value_like_jax(small):
    bad = [list(it) for it in small["samples"]]
    bad[1][2] = list(bad[1][2])
    bad[1][2][2] = (bad[1][2][2] + 1) % kzg.MODULUS
    assert _verdicts(small["setup"], [tuple(it) for it in bad]) == (False, False)


def test_batch_rejects_swapped_proofs_like_jax(small):
    bad = [list(it) for it in small["samples"]]
    bad[0][3], bad[2][3] = bad[2][3], bad[0][3]
    assert _verdicts(small["setup"], [tuple(it) for it in bad]) == (False, False)


def test_hostile_shapes_reject_without_a_pairing(small):
    setup = small["setup"]
    c, shift, ys, proof = small["samples"][0]
    assert kzg_batch.batch_verify_samples(setup, [], device="cpu")
    for item in ((c, shift, [], proof), (c, shift, ys[:3], proof), (c, shift, ys, None),
                 (c, shift, [kzg.MODULUS] + ys[1:], proof), (c, 0, ys, proof)):
        assert not kzg_batch.batch_verify_samples(setup, [item], device="cpu")
        assert not jax_kzg_batch._verify_samples_impl(setup, [item], use_device=False)


def test_degree_proof_batch(small):
    setup, k, items = small["setup"], small["points_count"], small["degree_proofs"]
    assert kzg_batch.batch_verify_degree_proofs(setup, items, k, device="cpu")
    bad = [(items[0][0], items[1][1])] + items[1:]
    assert not kzg_batch.batch_verify_degree_proofs(setup, bad, k, device="cpu")
    assert not kzg_batch.batch_verify_degree_proofs(setup, items, 0, device="cpu")
    assert not kzg_batch.batch_verify_degree_proofs(setup, items, setup.max_degree + 2,
                                                    device="cpu")


def test_attribution_names_the_bad_item(small):
    setup = small["setup"]
    bad = [list(it) for it in small["samples"]]
    bad[2][2] = [(y + 1) % kzg.MODULUS for y in bad[2][2]]
    bad = [tuple(it) for it in bad]
    ok, verdicts = kzg_batch.verify_samples_attributed(setup, bad, device="cpu")
    assert (ok, verdicts) == (False, [True, True, False])
    assert kzg_batch.verify_samples_attributed(setup, small["samples"], device="cpu") == (
        True, None)
