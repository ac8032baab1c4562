"""The resident multi-epoch loop (counterpart of engine/resident.py:43-300).

The registry stays on the device between epochs; per epoch the host sees
only the 15 aux flags, copied into pinned host memory with a non-blocking
copy right behind the launch that produces them, and read after the NEXT
epoch's launch is queued, so no step waits for the device. The host
services the flags:
- historical_append: computes `historical_batch_root` on the device and
  appends it to `historical_roots` (the epoch program never writes
  block_roots/state_roots, so the late computation sees the same vectors);
- eth1_votes_reset: counted;
- sync_committee_update: samples the next sync committee's validator
  indices from the device columns (`engine/sync_committee.py`, K4 + K5)
  into `next_sync_committee`, the previous one moving to
  `current_sync_committee`. The sampler must read the columns as the
  rotating epoch left them, so an epoch that rotates is serviced right
  after its own launch, before the next step overwrites them
  (engine/resident.py:229 of the JAX package does the same), and its epoch
  comes from the host's epoch count, not from `slot` at service time;
- dirty_cols: OR-accumulated into `dirty`.

`device_roots()` returns the 14 device field roots from a resident Merkle
cache (`engine/incremental_root.py`, K6 + K7): the first call builds it,
later calls refresh it lazily for the epochs serviced since.

In-place updates replace JAX donation: `step_epoch` overwrites the state's
ten registry columns, one row of `slashings` and of `randao_mixes`,
`justification_bits`, the three checkpoints and `slot`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.device import resolve_device
from . import state_root
from .epoch import historical_batch_root, make_epoch_fn
from .incremental_root import IncrementalStateRoot
from .state import DIRTY_TRACKED, EpochConfig, EpochState
from .sync_committee import sync_committee_for_state


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
        roots = loop.device_roots(static01)    # the same, from the Merkle cache
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
        # (SYNC_COMMITTEE_SIZE,) int64 validator indices, once a rotation ran
        self.current_sync_committee: torch.Tensor | None = None
        self.next_sync_committee: torch.Tensor | None = None
        self.sync_rotation_seconds: list[float] = []  # host wall of each rotation
        self.epochs = 0
        # the epoch the state is in, kept on the host (the one read of slot)
        self.epoch = int(self.state.slot) // cfg.slots_per_epoch
        self.dirty = np.zeros(len(DIRTY_TRACKED), dtype=bool)
        self._inc: IncrementalStateRoot | None = None
        self._pending_epochs = 0  # epoch refreshes owed to the root cache
        self._pending_last_epoch = self.epoch
        # two pinned flag buffers, alternating: epoch k's copy lands in one
        # while epoch k-1's is still to be read from the other
        pin = dev.type == "cuda"
        self._host = [torch.empty(3 + len(DIRTY_TRACKED), dtype=torch.bool, pin_memory=pin)
                      for _ in range(2)]
        self._pending = None  # (host buffer, event, epoch entered) of the last launch

    def step_epoch(self) -> None:
        """One epoch. The previous epoch's flags are serviced after this
        epoch's launch is queued, so their readout overlaps it; an epoch
        that enters a new sync-committee period is serviced at once."""
        _, aux = self._step(self.state)
        host = self._host[self.epochs % 2]
        host.copy_(aux.flat(), non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.flush()
        self.epoch += 1
        self._pending = (host, event, self.epoch)
        self.epochs += 1
        if self.epoch % self.cfg.epochs_per_sync_committee_period == 0:
            self.flush()  # the rotation reads the columns before the next step

    def run_epochs(self, k: int) -> None:
        for _ in range(k):
            self.step_epoch()

    def flush(self) -> None:
        """Service the flags of the last launched epoch, if not yet done."""
        if self._pending is None:
            return
        host, event, entered = self._pending
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
        rotates = entered % self.cfg.epochs_per_sync_committee_period == 0
        if bool(sync_update) != rotates:
            raise RuntimeError(f"epoch {entered}: the step's sync_committee_update flag "
                               f"({bool(sync_update)}) disagrees with the host's epoch count")
        if rotates:
            self._rotate_sync_committee(entered)
        self._pending_epochs += 1
        self._pending_last_epoch = entered

    def _rotate_sync_committee(self, next_epoch: int) -> None:
        t0 = time.perf_counter()
        indices, _ = sync_committee_for_state(self.cfg, self.state, next_epoch)
        self.current_sync_committee = self.next_sync_committee
        self.next_sync_committee = indices
        self.sync_committee_updates += 1
        self.sync_rotation_seconds.append(time.perf_counter() - t0)

    def dirty_columns(self) -> dict:
        """{tracked column name: moved since the loop began}: the
        accumulated dirty-column flags (engine/resident.py:375)."""
        return {name: bool(f) for name, f in zip(DIRTY_TRACKED, self.dirty)}

    def field_roots(self, static01: torch.Tensor) -> dict:
        """The 14 device-owned field roots of the current state, every tree
        hashed anew."""
        self.flush()
        return state_root.field_roots(self.state, static01.to(self.device))

    def device_roots(self, static01: torch.Tensor | None = None) -> dict:
        """The 14 device-owned field roots from the resident Merkle cache,
        equal to `field_roots`. The first call builds the cache (static01,
        (N, 16) int32, is needed then); later calls refresh it for the
        epochs serviced since, and ignore static01."""
        self.flush()
        if self._inc is None:
            if static01 is None:
                raise ValueError("the first device_roots() call builds the cache: pass static01")
            self._inc = IncrementalStateRoot(self.state, static01.to(self.device))
        elif self._pending_epochs:
            self._inc.refresh_after_epochs(
                self.state, last_epoch=self._pending_last_epoch, count=self._pending_epochs,
                epochs_per_historical_vector=self.cfg.epochs_per_historical_vector)
        self._pending_epochs = 0
        return self._inc.device_roots(self.state.slot)

    @property
    def root_cache(self) -> IncrementalStateRoot | None:
        """The Merkle cache once `device_roots` built it (its `last_dirty`
        and `last_branch` describe the last refresh)."""
        return self._inc
