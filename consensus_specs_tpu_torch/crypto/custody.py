"""Proof-of-custody crypto: Legendre-symbol PRF and the custody-bit pipeline.

Reference parity: specs/custody_game/beacon-chain.md — `legendre_bit` (:263),
`get_custody_atoms` (:285), `get_custody_secrets` (:303),
`universal_hash_function` (:318), `compute_custody_bit` (:331), and the
period helpers `get_randao_epoch_for_custody_period` /
`get_custody_period_for_validator` (:340-360). Constants: CUSTODY_PRIME =
2^256 - 189, CUSTODY_SECRETS = 3, BYTES_PER_CUSTODY_ATOM = 32,
CUSTODY_PROBABILITY_EXPONENT = 10 (:69-72).

The custody bit says "I held this data": a validator derives secrets from its
period's RANDAO signature, hashes the data atoms through a polynomial
universal hash keyed by the secrets, and the bit is the AND of 10 Legendre
bits of consecutive shifts — a PRF an adversary without the signature cannot
compute. Legendre bits are Euler's criterion a^((q-1)/2) mod q (CUSTODY_PRIME
is prime, so the Jacobi iteration the reference uses and the modexp used here
agree); `legendre_bits_batch` evaluates many shifts at once and is the TPU
target shape (batched 256-bit modexp — each bit is one vmapped limb-exp).

The port's own copy of the JAX package's crypto/custody.py, unchanged below
this docstring, so that the port imports nothing of that package.
"""
from __future__ import annotations

from .bls import signature_to_G2

CUSTODY_PRIME = 2**256 - 189
CUSTODY_SECRETS = 3
BYTES_PER_CUSTODY_ATOM = 32
CUSTODY_PROBABILITY_EXPONENT = 10

EPOCHS_PER_CUSTODY_PERIOD = 2**14
CUSTODY_PERIOD_TO_RANDAO_PADDING = 2**11
MAX_CHUNK_CHALLENGE_DELAY = 2**15


def legendre_bit(a: int, q: int) -> int:
    """Legendre symbol (a|q) normalized to a bit: QR -> 1, non-QR / 0 -> 0.

    q must be an odd prime (Euler's criterion); the reference computes the
    same value with a binary Jacobi iteration."""
    a %= q
    if a == 0:
        return 0
    return 1 if pow(a, (q - 1) // 2, q) == 1 else 0


def legendre_bits_batch(values: list[int], q: int = CUSTODY_PRIME) -> list[int]:
    """Batched PRF evaluation — the shape the TPU kernel takes over."""
    return [legendre_bit(v, q) for v in values]


def get_custody_atoms(data: bytes) -> list[bytes]:
    """Right-pad to a whole number of 32-byte atoms and split."""
    pad = (BYTES_PER_CUSTODY_ATOM - len(data) % BYTES_PER_CUSTODY_ATOM) % BYTES_PER_CUSTODY_ATOM
    padded = data + b"\x00" * pad
    return [padded[i : i + BYTES_PER_CUSTODY_ATOM] for i in range(0, len(padded), BYTES_PER_CUSTODY_ATOM)]


def get_custody_secrets(key: bytes) -> list[int]:
    """Secrets = 32-byte little-endian windows over the signature's G2 x-coord
    (two Fp coefficients, 48 bytes each, little-endian)."""
    x_coord = signature_to_G2(key)[0]
    if not isinstance(x_coord, (tuple, list)):
        # bls kill-switch stub path (bls.bls_active == False): the shim
        # returns scalar stub coordinates; keep the fast-test contract alive
        # with a deterministic zero-ish Fp2 coordinate.
        x_coord = (int(x_coord), 0)
    signature_bytes = b"".join(c.to_bytes(48, "little") for c in x_coord)
    return [
        int.from_bytes(signature_bytes[i : i + BYTES_PER_CUSTODY_ATOM], "little")
        for i in range(0, len(signature_bytes), 32)
    ]


def universal_hash_function(data_chunks: list[bytes], secrets: list[int]) -> int:
    """Polynomial universal hash over CUSTODY_PRIME with cycling secret keys,
    plus a length-binding term secrets[n % 3]^n."""
    n = len(data_chunks)
    acc = 0
    for i, atom in enumerate(data_chunks):
        key = secrets[i % CUSTODY_SECRETS]
        acc = (acc + pow(key, i, CUSTODY_PRIME) * int.from_bytes(atom, "little")) % CUSTODY_PRIME
    return (acc + pow(secrets[n % CUSTODY_SECRETS], n, CUSTODY_PRIME)) % CUSTODY_PRIME


def compute_custody_bit(key: bytes, data: bytes) -> int:
    """AND of CUSTODY_PROBABILITY_EXPONENT Legendre bits at consecutive
    shifts of the UHF digest."""
    atoms = get_custody_atoms(data)
    secrets = get_custody_secrets(key)
    uhf = universal_hash_function(atoms, secrets)
    bits = legendre_bits_batch([uhf + secrets[0] + i for i in range(CUSTODY_PROBABILITY_EXPONENT)])
    return 1 if all(bits) else 0


def get_randao_epoch_for_custody_period(period: int, validator_index: int) -> int:
    next_period_start = (period + 1) * EPOCHS_PER_CUSTODY_PERIOD - validator_index % EPOCHS_PER_CUSTODY_PERIOD
    return next_period_start + CUSTODY_PERIOD_TO_RANDAO_PADDING


def get_custody_period_for_validator(validator_index: int, epoch: int) -> int:
    return (epoch + validator_index % EPOCHS_PER_CUSTODY_PERIOD) // EPOCHS_PER_CUSTODY_PERIOD
