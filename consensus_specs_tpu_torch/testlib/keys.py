"""Deterministic test keypairs (copy of the JAX package's testlib/keys.py).

Reference parity: eth2spec test helpers' key fixtures
(tests/core/pyspec/eth2spec/test/helpers/keys.py:4-6): the secret key of
key i is i + 1, public keys are derived once and cached. `register` adds
further keys under the same rule (big_state's registry-scale keys), so
`pubkey_to_privkey` finds every validator's secret key.
"""
from __future__ import annotations

from ..crypto import bls_sig

NUM_KEYS = 512  # enough for minimal-preset test worlds (64..256 validators)

privkeys = [i + 1 for i in range(NUM_KEYS)]

_pubkey_cache: list[bytes] | None = None
_pubkey_to_privkey: dict[bytes, int] = {}


def get_pubkeys() -> list[bytes]:
    global _pubkey_cache
    if _pubkey_cache is None:
        _pubkey_cache = [bls_sig.SkToPk(k) for k in privkeys]
    return _pubkey_cache


def register(pubkeys) -> None:
    """Record pubkeys[i] as the public key of secret key i + 1."""
    _pubkey_to_privkey.update((bytes(pk), i + 1) for i, pk in enumerate(pubkeys))


def pubkey_to_privkey(pubkey: bytes) -> int:
    if not _pubkey_to_privkey:
        register(get_pubkeys())
    return _pubkey_to_privkey[bytes(pubkey)]
