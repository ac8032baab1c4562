"""Carry values between the JAX package and the port.

The JAX `EpochState` leaves, read as numpy (`np.asarray(leaf)`), come in as
uint64 / uint32 / uint8 / bool arrays; the port stores uint64 as int64 and
uint32 words as int32 with the same bit patterns (views, no arithmetic), so
the round trip is exact.

Field values: the JAX limb backend (ops/fp_jax.py) holds an Fp as (..., 24)
uint32 sixteen-bit limbs, the port as (..., 12) int32 words, both the
Montgomery value a·2^384 mod p, so the conversion is a repacking (the same
for Fr: ops/fr_jax.py's (..., 16) limbs and ops/fr.py's (..., 8) words, R =
2^256 in both). An Fp2 is JAX's (re, im) tuple and the port's (..., 2, 12);
an Fp12 JAX's six Fp2 coefficients and the port's (..., 12, 12).

JAX's RNS backend (its default) and the port's (ops/fp_rns.py) share one
layout, (..., 64) int32 residues of the same 64 primes with R = M_A, so
`rns_from_jax` / `rns_to_jax` copy. Between the port's two fields,
`rns_from_words` / `words_from_rns` go through canonical ints (an RNS value
may stand for any integer of its class mod p, a word value is canonical).

A fork-choice StoreSnapshot has the same numpy fields in both packages
(`snapshot_from_jax`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forkchoice.mirror import StoreSnapshot
from ..ops import fp, fp_rns
from ..utils.device import resolve_device
from .state import EpochConfig, EpochState

_TO_TORCH = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
_TO_NUMPY = {torch.int64: np.uint64, torch.int32: np.uint32}


def epoch_state_from_numpy(leaves: dict, device="cuda") -> EpochState:
    """{field name: numpy array} (the JAX EpochState's leaves) -> EpochState
    on `device`."""
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(EpochState):
        a = np.asarray(leaves[f.name])
        if a.dtype in _TO_TORCH:
            a = a.view(_TO_TORCH[a.dtype])
        out[f.name] = torch.from_numpy(np.array(a)).to(dev)
    return EpochState(**out)


def epoch_state_to_numpy(st: EpochState) -> dict:
    """EpochState -> {field name: numpy array} in the JAX package's dtypes."""
    out = {}
    for name, t in st.items():
        a = t.detach().cpu().numpy()
        if t.dtype in _TO_NUMPY:
            a = a.view(_TO_NUMPY[t.dtype])
        out[name] = a
    return out


def epoch_config_from_dict(d: dict) -> EpochConfig:
    """EpochConfig from `dataclasses.asdict` of the JAX package's config."""
    d = dict(d)
    d["participation_flag_weights"] = tuple(d["participation_flag_weights"])
    return EpochConfig(**d)


def fp_from_jax_limbs(limbs) -> torch.Tensor:
    """JAX limb-backend Fp (..., 24) uint32 -> the port's (..., 12) int32;
    any width alike: JAX's Fr (..., 16) limbs -> the port's (..., 8) words."""
    a = np.asarray(limbs).astype(np.uint32)
    words = a[..., 0::2] | (a[..., 1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def fp_to_jax_limbs(words: torch.Tensor) -> np.ndarray:
    """The port's (..., 12) int32 -> JAX limb-backend (..., 24) uint32; any
    width alike (Fr: (..., 8) -> (..., 16))."""
    w = words.detach().cpu().numpy().view(np.uint32)
    return np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], -1).reshape(
        *w.shape[:-1], 2 * w.shape[-1])


def f2_from_jax(x) -> torch.Tensor:
    """JAX Fp2 (re, im) -> (..., 2, 12)."""
    return torch.stack([fp_from_jax_limbs(x[0]), fp_from_jax_limbs(x[1])], -2)


def f2_to_jax(words: torch.Tensor) -> tuple:
    return fp_to_jax_limbs(words[..., 0, :]), fp_to_jax_limbs(words[..., 1, :])


def f12_from_jax(f) -> torch.Tensor:
    """JAX Fp12 (six Fp2 coefficients of w^k) -> (..., 12, 12)."""
    return torch.cat([f2_from_jax(c) for c in f], -2)


def f12_to_jax(words: torch.Tensor) -> tuple:
    return tuple(f2_to_jax(words[..., 2 * k:2 * k + 2, :]) for k in range(6))


def rns_from_jax(residues) -> torch.Tensor:
    """JAX's RNS Fp (..., 64) int32 residues (numpy or a JAX array) -> the
    port's tensor (a copy, on the CPU)."""
    return torch.from_numpy(np.array(residues, dtype=np.int32))


def rns_to_jax(t: torch.Tensor) -> np.ndarray:
    """The port's RNS residues -> (..., 64) int32 numpy, as JAX takes them."""
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(np.int32))


def rns_from_words(words: torch.Tensor) -> torch.Tensor:
    """Limb Montgomery words (..., 12) -> RNS Montgomery residues (..., 64) of
    the same field values (through canonical ints, on the host; the result
    on the CPU)."""
    shape = tuple(words.shape[:-1])
    ints = fp.mont_words_to_ints(words)
    return torch.from_numpy(fp_rns.ints_to_mont_batch(ints)).reshape(*shape, fp_rns.NLIMBS)


def words_from_rns(residues: torch.Tensor) -> torch.Tensor:
    """RNS Montgomery residues (..., 64) -> canonical limb Montgomery words
    (..., 12) of the same field values (host; the result on the CPU)."""
    shape = tuple(residues.shape[:-1])
    ints = fp_rns.mont_batch_to_ints(residues)
    return torch.from_numpy(fp.ints_to_mont_words(ints)).reshape(*shape, fp.NWORDS)


def snapshot_from_jax(snap):
    """A JAX-package forkchoice StoreSnapshot (numpy fields) -> the port's
    StoreSnapshot with the same values (arrays copied)."""
    fields = {}
    for f in dataclasses.fields(StoreSnapshot):
        value = getattr(snap, f.name)
        fields[f.name] = np.array(value) if isinstance(value, np.ndarray) else value
    return StoreSnapshot(**fields)
