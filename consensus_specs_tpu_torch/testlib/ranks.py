"""Run a function on w ranks of one process group, in w spawned processes.

    results = run_ranks(fn, world, "gloo", "cpu", *args)

Each rank calls `fn(rank, world, device, *args)` after joining a process
group of `backend` through a `file://` rendezvous in a fresh temporary
directory (never a fixed TCP port: test workers run side by side), and the
call returns the ranks' return values in rank order (pickled through that
directory). `fn` must live in an importable module of the port or of its
testlib, never in a test module: a spawned child imports `fn`'s module and
torch, and nothing else of the caller. A child that raises fails the call
(`torch.multiprocessing.ProcessRaisedException`). `meanwhile`, if given,
runs in the calling process while the ranks work; its value comes back
beside theirs: `(results, meanwhile_value)`.

The children pin torch to one intra-op thread: ranks share the machine
with each other and with other test workers.
"""
from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank, fn, world, backend, device, rdv, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank, world_size=world)
    try:
        result = fn(rank, world, device, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, backend: str, device: str, *args, meanwhile=None):
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(
            _child, args=(fn, world, backend, device, os.path.join(tmp, "rdv"), tmp, args),
            nprocs=world, join=False, start_method="spawn")
        try:
            extra = meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join():
                pass
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results if meanwhile is None else (results, extra)
