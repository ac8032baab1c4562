"""Mesh and sharding layout for the epoch step (counterpart of
parallel/mesh.py).

The registry is data parallel: every epoch sub-transition is an elementwise
or reduce-shaped sweep over (N,) columns, so the layout splits the ten
registry columns over the ranks in contiguous blocks, rank r holding
[r·N/w, (r+1)·N/w), and replicates the small per-epoch vectors (slashings,
randao mixes, block and state roots, the justification bits, the
checkpoints). The JAX program leaves the cross-rank traffic to GSPMD; here
`engine/epoch.sharded_epoch_step` runs K3's phases with three gathers where
the ranks must agree.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the initialized process group. `MeshComm` moves tensors across it, the
transport fixed by the group's backend and never by a failure:
- "nccl": gathers on the card, where each rank owns a card;
- "gloo": through host tensors (pinned when the data is on a card): ranks
  that share one card, and the CPU.
An error of either raises; nothing retries it over the other.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..engine.state import EpochState

DATA_AXIS = "data"

# The ten registry columns split over the ranks; every other EpochState
# field replicates (JAX's epoch_state_shardings, parallel/mesh.py:30-58).
SPLIT_FIELDS = ("balances", "effective_balance", "activation_eligibility_epoch",
                "activation_epoch", "exit_epoch", "withdrawable_epoch", "slashed",
                "prev_participation", "curr_participation", "inactivity_scores")


# The collectives' traffic since the last reset: gathers, bytes sent a rank,
# and the host wall spent in them (an NCCL gather's wall is its enqueue).
COLLECTIVES = {"gathers": 0, "bytes": 0, "seconds": 0.0}


def reset_collectives() -> None:
    COLLECTIVES.update(gathers=0, bytes=0, seconds=0.0)


def make_mesh(world_size: int | None = None, device_type: str = "cuda",
              backend: str | None = None):
    """A 1-D DeviceMesh named ("data",) over ranks 0..world_size-1 of the
    initialized process group (all of them by default). With `backend` the
    mesh gets a group of its own of that backend; otherwise it uses the
    default group's. Every rank of the default group calls it (a new group
    forms collectively); a rank outside the mesh gets None."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group or multihost.initialize)")
    world = dist.get_world_size()
    w = world if world_size is None else world_size
    if not 1 <= w <= world:
        raise ValueError(f"a mesh of {w} ranks over a group of {world}")
    if device_type == "cuda":
        _select_card()
    if backend is None and w == world:
        return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                     mesh_dim_names=(DATA_AXIS,))
    group = dist.new_group(list(range(w)), backend=backend)
    if dist.get_rank() >= w:
        return None
    return DeviceMesh.from_group(group, device_type, mesh=torch.arange(w),
                                 mesh_dim_names=(DATA_AXIS,))


def _select_card() -> None:
    """Each rank takes card rank % count, as DeviceMesh's own heuristic
    would, but before any NCCL communicator forms; ranks beyond the card
    count share cards (gloo only)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a card; pass device_type='cpu' for the CPU")
    torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class MeshComm:
    """The ranks of a mesh, flattened dcn-major, and the one collective the
    multi-device path uses: `all_gather`. A 2-D mesh must span the whole
    default group in rank order (multihost.global_epoch_mesh does)."""

    def __init__(self, mesh):
        flat = mesh.mesh.reshape(-1).tolist()
        if mesh.ndim == 1:
            self.group = mesh.get_group()
        else:
            if flat != list(range(dist.get_world_size())):
                raise ValueError("a multi-axis mesh must span the default group in rank order")
            self.group = dist.group.WORLD
        self.size = len(flat)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)
        self.device = mesh_device(mesh)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t in rank order, on t's device."""
        t0 = time.perf_counter()
        out_shape = (self.size,) + tuple(t.shape)
        flat = t.reshape(-1).contiguous()
        as_bytes = t.dtype == torch.bool  # gloo has no bool: move the bytes
        if as_bytes:
            flat = flat.view(torch.uint8)
        if self.backend == "nccl":
            if flat.device.type != "cuda":
                raise ValueError("an NCCL mesh gathers tensors on the card")
            out = torch.empty((self.size, flat.numel()), dtype=flat.dtype, device=flat.device)
            dist.all_gather(list(out.unbind(0)), flat, group=self.group)
        elif self.backend == "gloo":
            on_card = flat.device.type == "cuda"
            host = flat
            if on_card:
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                host.copy_(flat)
            out = torch.empty((self.size, flat.numel()), dtype=flat.dtype, pin_memory=on_card)
            dist.all_gather(list(out.unbind(0)), host, group=self.group)
            if on_card:
                out = out.to(flat.device, non_blocking=True)
        else:
            raise ValueError(f"no transport for the {self.backend!r} backend")
        if as_bytes:
            out = out.view(torch.bool)
        COLLECTIVES["gathers"] += 1
        COLLECTIVES["bytes"] += flat.numel() * flat.element_size()
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        return out.reshape(out_shape)


def epoch_state_layout() -> dict:
    """{EpochState field: "split" | "replicated"}: the registry columns
    split, the rest replicated (JAX's epoch_state_shardings)."""
    return {f.name: "split" if f.name in SPLIT_FIELDS else "replicated"
            for f in dataclasses.fields(EpochState)}


def block_bounds(n: int, comm: MeshComm, what: str = "validators") -> tuple:
    """[lo, hi) of this rank's block of n rows; ValueError unless the
    ranks divide n."""
    if n < 1 or n % comm.size:
        raise ValueError(f"{n} {what} do not split over {comm.size} ranks")
    nl = n // comm.size
    return comm.rank * nl, (comm.rank + 1) * nl


def shard_epoch_state(state: EpochState, mesh) -> EpochState:
    """This rank's shard of a whole EpochState (the same on every rank):
    its contiguous block of the registry columns and copies of the
    replicated fields, on this rank's device. ValueError when the ranks do
    not divide N."""
    comm = MeshComm(mesh)
    lo, hi = block_bounds(state.num_validators, comm)
    layout = epoch_state_layout()
    return EpochState(**{
        k: (v[lo:hi] if layout[k] == "split" else v).to(comm.device, copy=True).contiguous()
        for k, v in state.items()})


def gather_epoch_state(shard: EpochState, mesh) -> EpochState:
    """The whole EpochState from every rank's shard (on every rank): the
    registry blocks concatenated in rank order, the replicated fields this
    rank's. For tests and the smoke."""
    comm = MeshComm(mesh)
    layout = epoch_state_layout()
    return EpochState(**{k: comm.all_gather(v).reshape(-1) if layout[k] == "split" else v.clone()
                         for k, v in shard.items()})
