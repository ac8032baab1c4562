"""The port's BLS shim (consensus_specs_tpu_torch/crypto/bls.py) carries the
JAX package's shim's public names, but for three listed differences, and
altair's `eth_aggregate_pubkeys` runs through it (KeyValidate on each key,
AggregatePKs on the CPU's plain device path) to the JAX spec's bytes."""
import types

import pytest
import torch

import consensus_specs_tpu.crypto.bls as jbls
import consensus_specs_tpu_torch.crypto.bls as tbls
from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.testlib import keys as jkeys
from consensus_specs_tpu_torch.compiler import build_spec

# names of the JAX shim the port does not carry: its backend switches (the
# port's is `use_device`) and the flush retry policy (ROADMAP A4(a))
MISSING_IN_PORT = {"use_jax", "use_py", "FLUSH_RETRY_POLICY"}
PORT_ONLY = {"use_device", "device"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions' tensors are small, so one
    thread is faster, and parallel test workers do not oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_shims_have_the_same_public_names():
    assert _public(jbls) - _public(tbls) == MISSING_IN_PORT
    assert _public(tbls) - _public(jbls) == PORT_ONLY


def test_spec_facing_constants_match():
    for name in ("STUB_SIGNATURE", "STUB_PUBKEY", "G2_POINT_AT_INFINITY", "STUB_COORDINATES",
                 "MAP_TO_CURVE_RFC_COMPLIANT"):
        assert getattr(tbls, name) == getattr(jbls, name), name


@pytest.fixture
def shim_on_cpu():
    dev, was = tbls.device, tbls.bls_active
    tbls.use_device("cpu")
    yield
    tbls.use_device(dev)
    tbls.bls_active = was


def test_key_validate_and_signature_to_g2_match(shim_on_cpu):
    pk = jkeys.get_pubkeys()[5]
    assert tbls.KeyValidate(pk) is jbls.KeyValidate(pk) is True
    assert tbls.KeyValidate(b"\x00" * 48) is jbls.KeyValidate(b"\x00" * 48) is False
    assert tbls.KeyValidate(tbls.G2_POINT_AT_INFINITY[:48]) is False
    sig = tbls.Sign(6, b"message")
    assert sig == jbls.Sign(6, b"message")
    assert tbls.signature_to_G2(sig) == jbls.signature_to_G2(sig)
    tbls.bls_active = False
    assert tbls.signature_to_G2(sig) == tbls.STUB_COORDINATES
    assert tbls.KeyValidate(pk) is True  # outside the kill switch
    assert tbls.backend() == "cpu"


def test_clear_caches_empties_the_point_and_key_caches(shim_on_cpu):
    from consensus_specs_tpu_torch.crypto import bls_torch

    tbls.Sign(7, b"cached")
    tbls.AggregatePKs(jkeys.get_pubkeys()[:40])
    assert bls_torch._PK_VALIDATED
    tbls.clear_caches()
    assert not bls_torch._PK_VALIDATED and not bls_torch._AGG_CACHE
    assert tbls._sign_lru.cache_info().currsize == 0


def test_eth_aggregate_pubkeys_through_the_port_shim(shim_on_cpu):
    """altair's eth_aggregate_pubkeys (KeyValidate on each key, then
    AggregatePKs) through the port shim: 32 keys go to the device path's
    plain version, 8 to the host oracle; both equal the JAX spec's."""
    tspec = build_spec("altair", "minimal", device="cpu")
    jspec = get_spec("altair", "minimal")
    assert tspec.bls is tbls
    for n in (8, 32):
        keys = jkeys.get_pubkeys()[3:3 + n]
        assert tspec.eth_aggregate_pubkeys(keys) == jspec.eth_aggregate_pubkeys(keys)
    with pytest.raises(AssertionError):
        tspec.eth_aggregate_pubkeys([b"\x00" * 48] * 2)
