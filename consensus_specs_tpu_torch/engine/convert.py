"""Carry epoch state and config between the JAX package and the port.

The JAX `EpochState` leaves, read as numpy (`np.asarray(leaf)`), come in as
uint64 / uint32 / uint8 / bool arrays; the port stores uint64 as int64 and
uint32 words as int32 with the same bit patterns (views, no arithmetic), so
the round trip is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
