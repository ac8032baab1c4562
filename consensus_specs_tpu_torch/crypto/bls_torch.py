"""Device-batched BLS verification for the port: the bridge between the
port's BLS shim (crypto/bls.py) and the pairing kernels (ops/bls12.py);
counterpart of the JAX package's crypto/bls_jax.py.

Host side (here): decompression, hash-to-curve and the aggregation of
small committees with the copied pure-Python oracle (crypto/bls12_381.py),
padding to power-of-two buckets (utils/bucketing.py), packing the points
into words. Device side: committees of DEVICE_AGGREGATE_MIN or more keys
are summed on the card (K10 over one segment), their new keys checked for
the r-subgroup in one batched ladder (K14). At the flush one K8 launch puts
every coordinate into the Montgomery domain, then the randomized batch
check (`pairing_check_rlc`, grouped by message when messages repeat) runs
and, for a small batch or one whose randomized check fails, the per-item
`pairing_check_batch` for attribution.

The randomizers z of the batch check come from `secrets`, a CSPRNG drawn
anew for every flush: predictable z would let a forger cancel a bad
signature against another. Tests pass their own `zbits` to the ops layer.
"""
from __future__ import annotations

import hashlib
import os
import secrets
from functools import lru_cache

import numpy as np
import torch

from ..ops import bls12 as K
from ..utils import bucketing
from ..utils.device import resolve_device
from . import bls12_381 as oracle
from .hash_to_curve import hash_to_curve_g2 as _hash_to_curve_g2_uncached


# Messages recur across the aggregates of a slot and signatures across
# gossip and block import, so the two pure host functions are memoized
# (entries are a few KB).
@lru_cache(maxsize=1 << 13)
def hash_to_curve_g2(msg: bytes):
    return _hash_to_curve_g2_uncached(msg)


@lru_cache(maxsize=1 << 13)
def g2_from_bytes(data: bytes):
    return oracle.g2_from_bytes(data)


# Validated G1 decompression, memoized by the 48 compressed bytes: a node
# sees the same validator keys every epoch, and the r-subgroup check
# dominates decompression. About 0.5 KB an entry; the size can be set with
# CONSENSUS_TPU_PUBKEY_CACHE. Invalid encodings raise and are not cached.
_PUBKEY_CACHE_SIZE = int(os.environ.get("CONSENSUS_TPU_PUBKEY_CACHE", 1 << 20))


@lru_cache(maxsize=_PUBKEY_CACHE_SIZE)
def g1_from_bytes(data: bytes):
    return oracle.g1_from_bytes(data)


# e(G1, Q)·e(-G1, Q) == 1 for any Q: the padding item
_G1 = oracle.G1_GEN_AFF
_NEG_G1 = K.NEG_G1
_G2 = oracle.G2_GEN_AFF

_MIN_BATCH = 8
# batches at least this big take the randomized check first; only a failing
# batch pays the per-item pass
RLC_MIN_BATCH = 16


class QueuedCheck:
    """One signature check in the two-pairing form e(p1, q1)·e(p2, q2) == 1."""

    __slots__ = ("p1", "q1", "p2", "q2")

    def __init__(self, p1, q1, p2, q2):
        self.p1, self.q1, self.p2, self.q2 = p1, q1, p2, q2


def _decompress_inputs(pubkey: bytes, message: bytes, signature: bytes):
    """(pk, H(m), sig) affine, or None if an input is invalid."""
    try:
        pk = g1_from_bytes(bytes(pubkey))
        sig = g2_from_bytes(bytes(signature))
    except ValueError:
        return None
    if pk is None or sig is None:  # the point at infinity is never valid here
        return None
    return pk, hash_to_curve_g2(bytes(message)), sig


def make_verify_check(pubkey, message, signature) -> QueuedCheck | None:
    """Verify(pk, m, sig) as e(pk, H(m))·e(-G1, sig) == 1 (None: invalid)."""
    dec = _decompress_inputs(pubkey, message, signature)
    if dec is None:
        return None
    pk, hm, sig = dec
    return QueuedCheck(pk, hm, _NEG_G1, sig)


# Committee aggregates, keyed by sha256 of the concatenated keys (LRU).
_AGG_CACHE: dict = {}
_AGG_CACHE_MAX = 1 << 12

# Keys validated by the batched device subgroup check: compressed bytes ->
# affine pair, a bounded FIFO (an lru_cache fills only through its wrapped
# call, which is the host's 255-bit check this path avoids). The JAX
# package's size and eviction: one mainnet block at N = 2^20 carries 66,048
# distinct keys, 512 more than it holds.
_PK_VALIDATED: dict = {}
_PK_VALIDATED_MAX = 1 << 16

# below this many keys, host point additions beat a launch
DEVICE_AGGREGATE_MIN = 32

# device aggregations, the keys they summed, the cold keys they checked
pubkey_aggregate_device_total = 0
pubkey_aggregate_device_keys_total = 0
pubkey_subgroup_device_total = 0


def clear_caches() -> None:
    """Forget every committee aggregate and validated key: the committee
    cache, the device-validated keys and the host-validated ones."""
    _AGG_CACHE.clear()
    _PK_VALIDATED.clear()
    g1_from_bytes.cache_clear()


def _cache_aggregate(key: bytes, agg) -> None:
    if len(_AGG_CACHE) >= _AGG_CACHE_MAX:
        _AGG_CACHE.pop(next(iter(_AGG_CACHE)))
    _AGG_CACHE[key] = agg


def _aggregate_pubkeys_affine(pubkeys_bytes: list, device="cuda"):
    """Affine sum of compressed pubkeys (None for an infinity member or
    sum); raises ValueError on an invalid encoding. DEVICE_AGGREGATE_MIN or
    more keys go to the card (`_aggregate_pubkeys_device_impl`), which the
    JAX package reaches through its scheduler's msm lane and calls inline
    when that lane is absent, as here until the port has a scheduler."""
    key = hashlib.sha256(b"".join(pubkeys_bytes)).digest()
    hit = _AGG_CACHE.pop(key, None)
    if hit is not None:
        _AGG_CACHE[key] = hit
        return hit
    if len(pubkeys_bytes) >= DEVICE_AGGREGATE_MIN:
        marker = _aggregate_pubkeys_device_impl(pubkeys_bytes, device)
        if marker[0] == "bad_encoding":
            raise ValueError(marker[1])
        if marker[0] in ("inf_member", "inf"):
            return None  # never cached
        agg = (marker[1], marker[2])
        _cache_aggregate(key, agg)
        return agg
    acc = None
    for pk in pubkeys_bytes:
        aff = g1_from_bytes(pk)
        if aff is None:
            return None
        pt = oracle.pt_from_affine(oracle.FP_FIELD, aff)
        acc = pt if acc is None else oracle.pt_add(oracle.FP_FIELD, acc, pt)
    agg = oracle.pt_to_affine(oracle.FP_FIELD, acc)
    if agg is None:
        return None
    _cache_aggregate(key, agg)
    return agg


def _aggregate_pubkeys_device_impl(pubkeys_bytes: list, device="cuda"):
    """Committee aggregation on the card (counterpart of the JAX package's
    msm-lane "aggregate" kind). Returns a marker instead of raising:

        ("point", x, y)        the affine aggregate
        ("inf",)               the sum is the identity
        ("inf_member",)        a member is the point at infinity
        ("bad_encoding", msg)  decompression or subgroup rejection

    Keys not validated before decompress without the host's 255-bit [r]P
    check and are checked together in one K14 launch; the sum is one K10
    launch over one segment (`ops/bls12.g1_aggregate_device`)."""
    global pubkey_aggregate_device_total, pubkey_aggregate_device_keys_total
    global pubkey_subgroup_device_total
    affs: list = []
    cold: list = []
    try:
        for i, pk in enumerate(pubkeys_bytes):
            pk = bytes(pk)
            hit = _PK_VALIDATED.get(pk)
            if hit is not None:
                affs.append(hit)
                continue
            aff = oracle.g1_from_bytes(pk, subgroup_check=False)
            if aff is None:
                return ("inf_member",)
            affs.append(aff)
            cold.append(i)
    except ValueError as e:
        return ("bad_encoding", str(e))
    if cold:
        ok = K.g1_subgroup_check_device([affs[i] for i in cold], device)
        if not bool(ok.all()):
            return ("bad_encoding", "G1 point not in r-subgroup")
        for i in cold:
            if len(_PK_VALIDATED) >= _PK_VALIDATED_MAX:
                _PK_VALIDATED.pop(next(iter(_PK_VALIDATED)))
            _PK_VALIDATED[bytes(pubkeys_bytes[i])] = affs[i]
        pubkey_subgroup_device_total += len(cold)
    total = K.g1_aggregate_device(affs, device)
    pubkey_aggregate_device_total += 1
    pubkey_aggregate_device_keys_total += len(affs)
    if total is None:
        return ("inf",)
    return ("point", total[0], total[1])


def aggregate_pubkeys_device(pubkeys, device="cuda") -> bytes:
    """AggregatePKs on the card: compressed keys in, the compressed aggregate
    out (0xc0... for an infinity sum). Raises ValueError on an empty list,
    an invalid encoding, a key outside the subgroup or an infinity key, as
    the host oracle's AggregatePKs does."""
    if len(pubkeys) == 0:
        raise ValueError("aggregate of empty pubkey list")
    marker = _aggregate_pubkeys_device_impl([bytes(pk) for pk in pubkeys], device)
    if marker[0] == "bad_encoding":
        raise ValueError(marker[1])
    if marker[0] == "inf_member":
        raise ValueError("infinity pubkey in aggregate")
    if marker[0] == "inf":
        return oracle.g1_to_bytes(None)
    return oracle.g1_to_bytes((marker[1], marker[2]))


def make_fast_aggregate_check(pubkeys, message, signature, device="cuda") -> QueuedCheck | None:
    """FastAggregateVerify: the keys summed (on `device` from
    DEVICE_AGGREGATE_MIN keys, else on the host), then one check."""
    if len(pubkeys) == 0:
        return None
    try:
        agg = _aggregate_pubkeys_affine([bytes(pk) for pk in pubkeys], device)
        sig = g2_from_bytes(bytes(signature))
    except ValueError:
        return None
    if agg is None or sig is None:
        return None
    return QueuedCheck(agg, hash_to_curve_g2(bytes(message)), _NEG_G1, sig)


def zbits_from_ints(zs, device="cpu") -> torch.Tensor:
    """64-bit scalars -> the (n, 2) int32 words K9 takes, low word first."""
    z = np.asarray(zs, dtype=np.uint64).reshape(-1)
    words = np.stack([z & 0xFFFFFFFF, z >> 32], -1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def random_zbits(n: int, device) -> torch.Tensor:
    """`zbits_from_ints` of n nonzero 64-bit scalars from the CSPRNG: the
    randomizers of one flush, uniform over [1, 2^64). One
    `secrets.token_bytes` call for the batch (a call an item cost over ten
    milliseconds of host time at a thousand items); a zero, probability
    2^-64 an item, is drawn again."""
    zs = np.frombuffer(secrets.token_bytes(8 * n), dtype="<u8").astype(np.uint64)
    while not zs.all():
        zero = zs == 0
        zs[zero] = np.frombuffer(secrets.token_bytes(8 * int(zero.sum())), dtype="<u8")
    return zbits_from_ints(zs, device)


def _coords(groups, device) -> tuple:
    """Canonical coordinates, one flat int list per group, -> (the groups as
    tensors of the selected field backend on `device`, their width)."""
    field = K.current_field()
    sizes = [len(g) for g in groups]
    return list(torch.split(field.pack([c for g in groups for c in g], device), sizes)), \
        field.width


def _g1_flat(pts):
    return [c for pt in pts for c in pt]


def _g2_flat(pts):
    return [c for pt in pts for coord in pt for c in coord]


def _pack_pairing_args(p1s, q1s, p2s, q2s, device):
    """Pad to the bucket; -> (bucket, (q1, p1, q2, p2)) Montgomery words."""
    b = bucketing.pow2_bucket(len(p1s), _MIN_BATCH)
    pad = b - len(p1s)
    groups = (_g2_flat(list(q1s) + [_G2] * pad), _g1_flat(list(p1s) + [_G1] * pad),
              _g2_flat(list(q2s) + [_G2] * pad), _g1_flat(list(p2s) + [_NEG_G1] * pad))
    (q1, p1, q2, p2), w = _coords(groups, device)
    return b, (q1.reshape(b, 2, 2, w), p1.reshape(b, 2, w), q2.reshape(b, 2, 2, w),
               p2.reshape(b, 2, w))


def _pack_grouped_args(p1s, q1s, q2s, device):
    """Group the checks by distinct H(m) (compared by value) and pad both
    counts (utils/bucketing.grouped_plan): -> (b_n, b_d, (q1 (b_d, ...),
    p1 (b_n, ...), q2 (b_n, ...)), seg_ids (b_n,) int64). A pad item of
    group g is e(G1, Q_g)·e(-G1, Q_g) == 1, so every group has a member."""
    plan = bucketing.grouped_plan(q1s, _MIN_BATCH)
    b_n, b_d = plan.b_n, plan.b_d
    reps = [q1s[i] for i in plan.rep_index] + [_G2] * plan.pad_groups
    p1s = list(p1s) + [_G1] * plan.pad_items
    q2s = list(q2s) + [reps[g] for g in plan.pad_assignments]
    (q1, p1, q2), w = _coords((_g2_flat(reps), _g1_flat(p1s), _g2_flat(q2s)), device)
    seg_ids = torch.tensor(plan.seg, dtype=torch.int64, device=device)
    return b_n, b_d, (q1.reshape(b_d, 2, 2, w), p1.reshape(b_n, 2, w),
                      q2.reshape(b_n, 2, 2, w)), seg_ids


# The most recent randomized flush: its path, padded item and distinct
# counts and the Miller loops it ran; FLUSH_TOTALS counts flushes by path.
LAST_FLUSH: dict = {}
FLUSH_TOTALS = {"rlc": 0, "rlc_grouped": 0}


def record_flush(path: str, items: int, distinct: int, miller_loops: int) -> None:
    FLUSH_TOTALS[path] += 1
    LAST_FLUSH.clear()
    LAST_FLUSH.update(path=path, items=int(items), distinct=int(distinct),
                      miller_loops=int(miller_loops))


def _device_check(p1s, q1s, p2s, q2s, device) -> np.ndarray:
    """Per item e(p1, q1)·e(p2, q2) == 1, padded to the bucket."""
    n = len(p1s)
    _, args = _pack_pairing_args(p1s, q1s, p2s, q2s, device)
    return K.pairing_check_batch(*args).cpu().numpy()[:n]


def _device_check_all(p1s, q1s, p2s, q2s, device) -> bool:
    """One randomized check of the whole batch with CSPRNG scalars
    (soundness error 2^-64 a flush); grouped by message, D + 1 Miller loops,
    where messages repeat, else N + 1."""
    assert all(p2 is _NEG_G1 for p2 in p2s), "the randomized check needs p2 == -G1"
    n = len(p1s)
    check = K.pairing_check_rlc
    if len(set(q1s)) < n:
        b_n, b_d, (q1, p1, q2), seg_ids = _pack_grouped_args(p1s, q1s, q2s, device)
        ok = check(q1, p1, q2, random_zbits(b_n, device), seg_ids)
        record_flush("rlc_grouped", items=b_n, distinct=b_d, miller_loops=b_d + 1)
    else:
        b, (q1, p1, q2, _) = _pack_pairing_args(p1s, q1s, p2s, q2s, device)
        ok = check(q1, p1, q2, random_zbits(b, device))
        record_flush("rlc", items=b, distinct=b, miller_loops=b + 1)
    return bool(ok)


def run_checks(checks, device="cuda") -> np.ndarray:
    """Run a list of QueuedCheck | None on `device` (None -> False): the
    randomized check for 16 or more live checks, and the per-item check
    for fewer or when it fails."""
    dev = resolve_device(device)
    live = [(i, c) for i, c in enumerate(checks) if c is not None]
    out = np.zeros(len(checks), dtype=bool)
    if not live:
        return out
    cols = ([c.p1 for _, c in live], [c.q1 for _, c in live],
            [c.p2 for _, c in live], [c.q2 for _, c in live])
    if len(live) >= RLC_MIN_BATCH and _device_check_all(*cols, dev):
        out[[i for i, _ in live]] = True
        return out
    for (i, _), ok in zip(live, _device_check(*cols, dev)):
        out[i] = bool(ok)
    return out
