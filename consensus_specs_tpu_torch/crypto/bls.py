"""The port's BLS shim: the surface spec code calls for BLS (counterpart of
the JAX package's crypto/bls.py, with its "jax" backend's flush going to the
card through crypto/bls_torch.py).

`with deferred_verification():` queues every Verify / FastAggregateVerify /
AggregateVerify (each returns True at once) and checks the whole queue in one
flush at the outermost exit, raising BLSVerificationError if any check
failed. The state is per thread and reentrant: inner contexts queue into the
outer one, and an inner body that raises drops the checks it queued. Outside
a deferral each call is checked at once. Verify and FastAggregateVerify run
on the device (`bls_torch.run_checks`), a FastAggregateVerify's committee of
DEVICE_AGGREGATE_MIN or more keys summed there first; AggregateVerify, one
message per signer, runs on the host oracle, as the JAX package's BLS lane
routes it. AggregatePKs sums as many keys on the device too; Sign, SkToPk
and Aggregate are the host oracle's.

`device` ("cuda" unless `use_device` says otherwise) is where the flush runs;
the CPU runs the kernels' plain versions. When `bls_active` is False every
operation returns its stub (the spec tests' --disable-bls contract).

The module carries every name of the JAX package's shim that spec code,
test helpers and callers read, with three exceptions: `use_jax` and
`use_py` (here `use_device`) and `FLUSH_RETRY_POLICY` (the retry lane,
ROADMAP A4(a): a failed flush propagates). `KeyValidate` and
`AggregatePKs` stay outside the kill switch, as there: they make state
content (altair's `eth_aggregate_pubkeys`), not checks.
"""
from __future__ import annotations

import threading
from functools import lru_cache as _lru_cache

from . import bls_sig as _py
from . import bls_torch
from .hash_to_curve import MAP_TO_CURVE_RFC_COMPLIANT  # noqa: F401

bls_active = True
device = "cuda"

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48
G2_POINT_AT_INFINITY = _py.G2_POINT_AT_INFINITY
STUB_COORDINATES = (0, 0)


def use_device(dev) -> None:
    """Run later flushes on `dev` ("cuda" or "cpu")."""
    global device
    device = dev


def backend() -> str:
    """Where flushes and large aggregates run: "cuda" or "cpu"."""
    return str(device)


class BLSVerificationError(AssertionError):
    """Raised at a deferred flush when a check failed (an AssertionError, as
    an inline `assert bls.Verify(...)` failure is)."""


class _DeferralState(threading.local):
    def __init__(self):
        self.queue = None  # None: checks run at once; a list: they queue
        self.depth = 0


_deferral = _DeferralState()
flush_count = 0  # deferred flushes performed
inline_check_count = 0  # checks run outside a deferral


class deferred_verification:
    """Queue every signature check; verify them in one flush at the
    outermost exit (see the module docstring)."""

    def __enter__(self):
        _deferral.depth += 1
        if _deferral.queue is None:
            _deferral.queue = []
        self._entry_len = len(_deferral.queue)
        return self

    def __exit__(self, exc_type, exc, tb):
        global flush_count
        _deferral.depth -= 1
        if exc_type is not None and _deferral.queue is not None:
            del _deferral.queue[self._entry_len:]  # the failed body's checks
        if _deferral.depth > 0:
            return False
        queue = _deferral.queue
        try:
            if exc_type is None and queue:
                flush_count += 1
                results = _flush(queue)
                if not all(results):
                    bad = [i for i, ok in enumerate(results) if not ok]
                    raise BLSVerificationError(
                        f"deferred batch verification failed for checks {bad}")
            return False
        finally:
            # whatever escaped, the next deferral on this thread starts clean
            _deferral.queue = None
            _deferral.depth = 0


class inline_verification:
    """Bypass an active deferral for checks that steer control flow (the
    spec's process_deposit skips a deposit with a bad signature)."""

    def __enter__(self):
        self._saved = _deferral.queue
        _deferral.queue = None
        return self

    def __exit__(self, exc_type, exc, tb):
        _deferral.queue = self._saved
        return False


def _flush(queue) -> list:
    """[(kind, args)] -> [bool]: the device checks in one `run_checks`, the
    aggregate_verify entries on the host oracle."""
    checks, host = [], {}
    for i, (kind, args) in enumerate(queue):
        if kind == "verify":
            checks.append(bls_torch.make_verify_check(*args))
        elif kind == "fast_aggregate":
            checks.append(bls_torch.make_fast_aggregate_check(*args, device=device))
        else:
            checks.append(None)
            host[i] = bool(_py.AggregateVerify(*args))
    dev = bls_torch.run_checks(checks, device)
    return [host[i] if i in host else bool(dev[i]) for i in range(len(queue))]


def _check(kind, args) -> bool:
    global inline_check_count
    if _deferral.queue is not None:
        _deferral.queue.append((kind, args))
        return True
    inline_check_count += 1
    return _flush([(kind, args)])[0]


def only_with_bls(alt_return=None):
    """Decorator: return `alt_return` instead when BLS is off."""
    def decorator(fn):
        def wrapper(*args, **kwargs):
            if not bls_active:
                return alt_return
            return fn(*args, **kwargs)
        wrapper.__name__ = fn.__name__
        return wrapper
    return decorator


@only_with_bls(alt_return=True)
def Verify(pubkey, message, signature) -> bool:
    return _check("verify", (pubkey, message, signature))


@only_with_bls(alt_return=True)
def AggregateVerify(pubkeys, messages, signature) -> bool:
    return _check("aggregate_verify", (list(pubkeys), list(messages), signature))


@only_with_bls(alt_return=True)
def FastAggregateVerify(pubkeys, message, signature) -> bool:
    return _check("fast_aggregate", (list(pubkeys), message, signature))


@only_with_bls(alt_return=STUB_SIGNATURE)
def Aggregate(signatures) -> bytes:
    return _py.Aggregate(signatures)


@only_with_bls(alt_return=STUB_SIGNATURE)
def Sign(privkey, message) -> bytes:
    # memoized, as the JAX package's shim: signing is deterministic, and
    # test-vector and block-building code re-signs the same pairs. The memo
    # holds private keys: `clear_sign_cache()` drops it.
    return _sign_lru(int(privkey), bytes(message))


@_lru_cache(maxsize=1 << 16)
def _sign_lru(privkey: int, message: bytes) -> bytes:
    return _py.Sign(privkey, message)


def clear_sign_cache() -> None:
    """Drop the Sign memo."""
    _sign_lru.cache_clear()


def clear_caches() -> None:
    """Drop every host-side crypto cache: the Sign memo, the oracle's
    signature points, and the device path's committee aggregates,
    validated keys (`_PK_VALIDATED`), decoded points and hashed messages."""
    clear_sign_cache()
    _py.clear_sig_point_cache()
    bls_torch.clear_caches()
    bls_torch.g2_from_bytes.cache_clear()
    bls_torch.hash_to_curve_g2.cache_clear()


@only_with_bls(alt_return=STUB_COORDINATES)
def signature_to_G2(signature):
    return _py.signature_to_point(signature)


@only_with_bls(alt_return=STUB_SIGNATURE)  # the JAX shim's (and eth2spec's) stub
def SkToPk(privkey) -> bytes:
    return _py.SkToPk(int(privkey))


def AggregatePKs(pubkeys) -> bytes:
    """Not behind the kill-switch: aggregate pubkeys are state content.
    DEVICE_AGGREGATE_MIN or more keys are summed on `device`, with the new
    keys' subgroup checks batched there, as the JAX shim's jax backend
    does; fewer go to the host oracle."""
    if len(pubkeys) >= bls_torch.DEVICE_AGGREGATE_MIN:
        return bls_torch.aggregate_pubkeys_device(pubkeys, device)
    return _py.AggregatePKs(pubkeys)


def KeyValidate(pubkey) -> bool:
    """Not behind the kill-switch (see AggregatePKs): the host oracle's
    decompression and subgroup check."""
    return _py.KeyValidate(pubkey)
