"""Multi-host bootstrap and the two-axis (dcn, data) mesh (counterpart of
parallel/multihost.py).

Layout stance, as the JAX package's: the host axis is OUTERMOST. The epoch
step is data parallel over the registry, so the registry splits over
(dcn × data) jointly: rank (h, d) of an (H, D) mesh holds the block of its
flattened, dcn-major rank h·D + d, hosts hold contiguous registry blocks,
and the only cross-host traffic is the step's three small gathers and the
activation keys (engine/epoch.sharded_epoch_step).

One process degenerates cleanly: `initialize()` does nothing and returns
False. On one host, `global_epoch_mesh(n_hosts=k)` factors the ranks into
k virtual hosts, which runs the identical two-axis program a real cluster
runs (the test strategy).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..engine.state import EpochState
from .mesh import DATA_AXIS, _select_card, epoch_state_layout, shard_epoch_state

DCN_AXIS = "dcn"
ICI_AXIS = DATA_AXIS  # the intra-host registry axis keeps parallel/mesh.py's name


def initialize(init_method: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> bool:
    """Join the process group, one call a process, before any collective.
    Returns False for one process or None (nothing to do), True after
    `torch.distributed.init_process_group(backend, init_method=...,
    world_size=num_processes, rank=process_id)`. The backend defaults to
    NCCL where there is a card and gloo otherwise; the caller gives the
    address (`tcp://host:port` or `file://path`): nothing here discovers a
    cluster."""
    if not num_processes or num_processes == 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def global_epoch_mesh(n_hosts: int | None = None, device_type: str = "cuda"):
    """(dcn, data) DeviceMesh over the ranks of the default group, host
    axis outermost: rank r sits at (r // D, r % D). `n_hosts` defaults to
    one; ValueError when the ranks do not factor over it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("global_epoch_mesh needs an initialized process group")
    world = dist.get_world_size()
    n_hosts = 1 if n_hosts is None else n_hosts
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"{world} ranks do not factor over {n_hosts} hosts")
    if device_type == "cuda":
        _select_card()
    return DeviceMesh(device_type, torch.arange(world).reshape(n_hosts, -1),
                      mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def hierarchical_epoch_shardings(mesh) -> dict:
    """{EpochState field: the mesh axes it splits over, or () replicated}:
    the registry columns over (dcn, data) jointly on a two-axis mesh, over
    (data,) on a flat one; everything else replicated (JAX's
    hierarchical_epoch_shardings)."""
    axes = tuple(mesh.mesh_dim_names)
    return {k: axes if v == "split" else () for k, v in epoch_state_layout().items()}


def shard_epoch_state_hierarchical(state: EpochState, mesh) -> EpochState:
    """This rank's shard on a (dcn, data) mesh: the block of its flattened
    dcn-major rank (mesh.MeshComm), replicated fields copied."""
    return shard_epoch_state(state, mesh)
