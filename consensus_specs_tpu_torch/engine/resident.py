"""The resident multi-epoch loop (counterpart of engine/resident.py:43-300).

The registry stays on the device between epochs; per epoch the host sees
only the 15 aux flags, copied into pinned host memory with a non-blocking
copy right behind the launch that produces them, and read after the NEXT
epoch's launch is queued, so no step waits for the device. The host
services the flags:
- historical_append: computes `historical_batch_root` on the device and
  appends it to `historical_roots` (the epoch program never writes
  block_roots/state_roots, so the late computation sees the same vectors);
- eth1_votes_reset, sync_committee_update: counted. The sync-committee
  sampler needs the shuffle kernel and SSZ and comes with a later slice;
- dirty_cols: OR-accumulated into `dirty`.

In-place updates replace JAX donation: `step_epoch` overwrites the state's
ten registry columns, one row of `slashings` and of `randao_mixes`,
`justification_bits`, the three checkpoints and `slot`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .epoch import historical_batch_root, make_epoch_fn
from .state import DIRTY_TRACKED, EpochConfig, EpochState
from . import state_root


def step_body(cfg: EpochConfig):
    """`process_epoch` plus the inter-epoch slot advance, in place: the
    spec runs process_epoch at the last slot of an epoch and process_slots
    then moves SLOTS_PER_EPOCH slots on."""
    epoch_fn = make_epoch_fn(cfg)

    def step(st: EpochState):
        st, aux = epoch_fn(st)
        st.slot.add_(cfg.slots_per_epoch)
        return st, aux

    return step


class ResidentEpochLoop:
    """Runs epochs with the registry resident on `device`.

        loop = ResidentEpochLoop(cfg, state)   # moves state to the device
        loop.run_epochs(k)                     # k steps, no host sync
        roots = loop.field_roots(static01)     # 14 device field roots
    """

    def __init__(self, cfg: EpochConfig, state: EpochState, device="cuda"):
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.state = EpochState(**{k: v.to(dev) for k, v in state.items()})
        self._step = step_body(cfg)
        self.historical_roots: list[torch.Tensor] = []  # (8,) int32 words each
        self.eth1_votes_resets = 0
        self.sync_committee_updates = 0
        self.epochs = 0
        self.dirty = np.zeros(len(DIRTY_TRACKED), dtype=bool)
        # two pinned flag buffers, alternating: epoch k's copy lands in one
        # while epoch k-1's is still to be read from the other
        pin = dev.type == "cuda"
        self._host = [torch.empty(3 + len(DIRTY_TRACKED), dtype=torch.bool, pin_memory=pin)
                      for _ in range(2)]
        self._pending = None  # (host buffer, event) of the last launch

    def step_epoch(self) -> None:
        """One epoch. The previous epoch's flags are serviced after this
        epoch's launch is queued, so their readout overlaps it."""
        _, aux = self._step(self.state)
        host = self._host[self.epochs % 2]
        host.copy_(aux.flat(), non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.flush()
        self._pending = (host, event)
        self.epochs += 1

    def run_epochs(self, k: int) -> None:
        for _ in range(k):
            self.step_epoch()

    def flush(self) -> None:
        """Service the flags of the last launched epoch, if not yet done."""
        if self._pending is None:
            return
        host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        flags = host.numpy()
        historical_append, eth1_reset, sync_update = flags[:3]
        self.dirty |= flags[3:]
        if historical_append:
            self.historical_roots.append(
                historical_batch_root(self.state.block_roots, self.state.state_roots))
        self.eth1_votes_resets += int(eth1_reset)
        self.sync_committee_updates += int(sync_update)

    def field_roots(self, static01: torch.Tensor) -> dict:
        """The 14 device-owned field roots of the current state."""
        self.flush()
        return state_root.field_roots(self.state, static01.to(self.device))
