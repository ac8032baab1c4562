"""Rank functions for the mesh tests (`testlib/ranks.run_ranks`): each runs
on every rank of a spawned process group, on the CPU under gloo, and
returns plain values (numpy arrays, ints, bools) for the caller to compare.
They import only torch and the port, so a spawned child never loads JAX.

- `epoch_ranks`: the sharded epoch step on each given state (flat mesh),
  and two sharded resident steps on the first;
- `multihost_ranks`: the (dcn, data) mesh's axes and shape, its ValueError,
  and the hierarchical step against the flat one;
- `collectives_ranks`: `g1_mesh_sum` on meshes of 1, 2 and 4 ranks, the
  ValueErrors, and the randomized checks on two 2-rank meshes side by side
  (ranks 0-1 the ungrouped check in both forms, ranks 2-3 the grouped one);
- `mesh_path`: the multi-device path on the card at full size, timed and
  its launches counted (chip_smoke.py phase 5i runs it at world size 1 in
  its own process and on 4 spawned ranks).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..engine.convert import epoch_state_from_numpy, epoch_state_to_numpy
from ..engine.epoch import make_epoch_fn
from ..engine.resident import step_body
from ..ops import bls12 as B
from ..parallel import collectives as C
from ..parallel import multihost
from ..parallel.mesh import (
    DATA_AXIS,
    MeshComm,
    epoch_state_layout,
    gather_epoch_state,
    make_mesh,
    shard_epoch_state,
)


def submesh(ranks, device_type="cpu"):
    """A 1-D mesh over `ranks` of the default group. Every rank calls it (the
    group forms collectively); a rank outside gets None."""
    from torch.distributed.device_mesh import DeviceMesh

    group = dist.new_group(list(ranks))
    if dist.get_rank() not in ranks:
        return None
    return DeviceMesh.from_group(group, device_type, mesh=torch.tensor(list(ranks)),
                                 mesh_dim_names=(DATA_AXIS,))


def _step(cfg, leaves, mesh, device, steps=1):
    """The whole state after `steps` sharded steps from numpy leaves, and the
    last aux."""
    shard = shard_epoch_state(epoch_state_from_numpy(leaves, device), mesh)
    fn = step_body(cfg, mesh) if steps > 1 else make_epoch_fn(cfg, mesh)
    for _ in range(steps):
        shard, aux = fn(shard)
    return epoch_state_to_numpy(gather_epoch_state(shard, mesh)), aux.flat().cpu().numpy()


def epoch_ranks(rank, world, device, cfg, states, resident_steps):
    """{case: (whole state leaves, aux)} after one sharded step of each
    state in `states` ({case: numpy leaves}), and "resident" after
    `resident_steps` sharded resident steps of the first."""
    mesh = make_mesh(device_type=device)
    out = {case: _step(cfg, leaves, mesh, device) for case, leaves in states.items()}
    first = next(iter(states.values()))
    out["resident"] = _step(cfg, first, mesh, device, steps=resident_steps)
    return out


def multihost_ranks(rank, world, device, cfg, leaves):
    """The (2, world/2) mesh's axis names and shape, whether 3 hosts raise
    and whether sharding world + 2 validators raises, this rank's
    coordinate, a gather on a 2-rank mesh of its own group (None outside
    it), and one hierarchical and one flat step."""
    mesh = multihost.global_epoch_mesh(n_hosts=2, device_type=device)
    try:
        multihost.global_epoch_mesh(n_hosts=3, device_type=device)
        three_hosts_raise = False
    except ValueError:
        three_hosts_raise = True
    shard = multihost.shard_epoch_state_hierarchical(epoch_state_from_numpy(leaves, device), mesh)
    layout = epoch_state_layout()
    odd = {k: v[:world + 2] if layout[k] == "split" else v for k, v in leaves.items()}
    shard_raises = _raises(lambda: shard_epoch_state(epoch_state_from_numpy(odd, device), mesh))
    first_two = make_mesh(world_size=2, device_type=device, backend="gloo")
    gathered = (None if first_two is None
                else MeshComm(first_two).all_gather(torch.tensor([rank])).reshape(-1).tolist())
    return dict(axes=tuple(mesh.mesh_dim_names), shape=tuple(mesh.mesh.shape),
                first_two=gathered, shard_raises=shard_raises,
                coordinate=tuple(mesh.get_coordinate()), three_hosts_raise=three_hosts_raise,
                block_rows=shard.num_validators,
                shardings=multihost.hierarchical_epoch_shardings(mesh),
                hierarchical=_step(cfg, leaves, mesh, device),
                flat=_step(cfg, leaves, make_mesh(device_type=device), device))


def _affine(words) -> tuple:
    return B.affine_from_words(words.reshape(1, 2, -1).cpu(), False)[0]


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def collectives_ranks(rank, world, device, g1_cases, ungrouped, grouped):
    """On a 4-rank group: `g1_mesh_sum` of each of `g1_cases` ({name: (n, 3,
    12) points}) on this rank's 1-rank mesh, on its 2-rank mesh and on the
    4-rank mesh (affine int pairs); the ValueErrors; then ranks 0-1 run
    `pairing_check_rlc_mesh` on each of `ungrouped` ({name: (q1, p1, q2, p2,
    zbits, p2_is_neg_g1)}) and ranks 2-3 `pairing_check_rlc_grouped_mesh`
    on each of `grouped` ({name: (q1, p1, q2, zbits, seg_ids)}), at once."""
    one = [submesh([r], device) for r in range(world)][rank]
    pairs = [submesh([0, 1], device), submesh([2, 3], device)]
    two = pairs[rank // 2]
    four = make_mesh(device_type=device)
    out = {"g1": {name: {size: _affine(C.g1_mesh_sum(pts, mesh))
                         for size, mesh in ((1, one), (2, two), (4, four))}
                  for name, pts in g1_cases.items()}}
    q1, p1, q2, p2, zb, _ = next(iter(ungrouped.values()))
    gq1, gp1, gq2, gzb, seg = next(iter(grouped.values()))
    out["raises"] = dict(
        g1_n=_raises(lambda: C.g1_mesh_sum(next(iter(g1_cases.values()))[:6], four)),
        rlc_n=_raises(lambda: C.pairing_check_rlc_mesh(four, q1[:6], p1[:6], q2[:6], p2[:6],
                                                       zb[:6], True)),
        grouped_d=_raises(lambda: C.pairing_check_rlc_grouped_mesh(
            four, gq1[:2], gp1, gq2, gzb, seg)),
        grouped_n=_raises(lambda: C.pairing_check_rlc_grouped_mesh(
            four, gq1, gp1[:6], gq2[:6], gzb[:6], seg[:6])))
    if rank < 2:
        out["ungrouped"] = {name: bool(C.pairing_check_rlc_mesh(two, *args[:5],
                                                                p2_is_neg_g1=args[5]))
                            for name, args in ungrouped.items()}
    else:
        out["grouped"] = {name: bool(C.pairing_check_rlc_grouped_mesh(two, *args))
                          for name, args in grouped.items()}
    return out



def g1_sum_ranks(rank, world, device, g1_cases):
    """`g1_mesh_sum` of each of `g1_cases` ({name: (n, 3, 12) points}) on
    this rank's 1-rank mesh, its 2-rank mesh and the whole group's mesh:
    {name: {mesh size: affine int pair}}."""
    one = [submesh([r], device) for r in range(world)][rank]
    two = [submesh([0, 1], device), submesh([2, 3], device)][rank // 2]
    whole = make_mesh(device_type=device)
    return {name: {size: _affine(C.g1_mesh_sum(pts, mesh))
                   for size, mesh in ((1, one), (2, two), (world, whole))}
            for name, pts in g1_cases.items()}


def mesh_check_ranks(rank, world, device, check, cases):
    """One randomized-check collective on the whole group's mesh over each of
    `cases`: "rlc" runs `pairing_check_rlc_mesh` on {name: (q1, p1, q2, p2,
    zbits, p2_is_neg_g1)}, "grouped" `pairing_check_rlc_grouped_mesh` on
    {name: (q1, p1, q2, zbits, seg_ids)}. Returns {name: bool}."""
    mesh = make_mesh(device_type=device)
    if check == "rlc":
        return {name: bool(C.pairing_check_rlc_mesh(mesh, *a[:5], p2_is_neg_g1=a[5]))
                for name, a in cases.items()}
    return {name: bool(C.pairing_check_rlc_grouped_mesh(mesh, *a)) for name, a in cases.items()}

# --- the multi-device main path on the card (chip_smoke.py phase 5i) -------


def state_digest(st, fields=None) -> str:
    """sha256 over the named fields' bytes (all, in EpochState order, by
    default): states compared across processes without moving them."""
    import hashlib

    h = hashlib.sha256()
    for name, t in st.items():
        if fields is None or name in fields:
            h.update(name.encode() + t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_keys(n: int, seed: int, device):
    """n public keys [k_i]·G1 as Jacobian words (n, 3, 12) made on `device`
    by K9 from seeded 64-bit k_i, and sum_i k_i mod r (their sum is
    [that]·G1)."""
    from ..crypto import bls12_381 as oracle
    from ..crypto.bls_torch import zbits_from_ints

    ks = np.random.default_rng(seed).integers(1, 2**64, n, dtype=np.uint64)
    base = B.g1_to_words([oracle.G1_GEN_AFF]).to(device).expand(n, 2, B.NWORDS).contiguous()
    pts = B.rlc_ladders(base, None, zbits_from_ints(ks, device), affine_g1=False)[0]
    return pts, sum(int(k) for k in ks) % oracle.R


def mesh_path(rank, world, device, cfg, bls, n_keys, key_seed, n_epoch, epochs, edge,
              hierarchical):
    """The multi-device path on this rank's card, every part timed with CUDA
    events (and the host wall of its gathers apart), its launches counted
    from zero: `g1_mesh_sum` over n_keys seeded keys; the ungrouped and
    grouped randomized checks on each batch of `bls` ({"ungrouped": {name:
    (q1, p1, q2, p2, zbits)}, "grouped": {name: (q1, p1, q2, zbits,
    seg_ids)}}, CPU words, every rank the same); `epochs` sharded resident
    epochs over the synthetic registry of n_epoch validators (seed 0, epoch
    250); one sharded epoch over `edge` (numpy leaves); with `hierarchical`,
    one epoch of the same registry on the (2, world/2) mesh. Returns the
    sum's affine ints, the verdicts, the states' digests and the clocks."""
    from ..engine.synthetic import synthetic_epoch_state
    from ..kernels import build
    from ..parallel.mesh import COLLECTIVES, mesh_device, reset_collectives

    mesh = make_mesh(device_type=device)
    dev = mesh_device(mesh)
    out = {"rank": rank, "world": world, "parts": {}, "verdicts": {}, "digests": {}}
    MeshComm(mesh).all_gather(torch.zeros(1, device=dev))  # the communicator forms here

    def part(name, fn):
        torch.cuda.synchronize()
        build.reset_launches()
        reset_collectives()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        wall0 = time.perf_counter()
        ev[0].record()
        result = fn()
        ev[1].record()
        ev[1].synchronize()
        out["parts"][name] = dict(
            ms=ev[0].elapsed_time(ev[1]), wall_ms=1e3 * (time.perf_counter() - wall0),
            gather_wall_ms=1e3 * COLLECTIVES["seconds"], gathers=COLLECTIVES["gathers"],
            gather_bytes=COLLECTIVES["bytes"],
            launches={k: v for k, v in build.LAUNCHES.items() if v})
        return result

    pts, k_sum = mesh_keys(n_keys, key_seed, dev)
    out["k_sum"] = k_sum
    out["g1_sum"] = _affine(part("g1_sum", lambda: C.g1_mesh_sum(pts, mesh)))
    del pts
    for kind, fn in (("ungrouped", lambda a: C.pairing_check_rlc_mesh(mesh, *a,
                                                                      p2_is_neg_g1=True)),
                     ("grouped", lambda a: C.pairing_check_rlc_grouped_mesh(mesh, *a))):
        for name, args in bls[kind].items():
            args = tuple(t.to(dev) for t in args)
            out["verdicts"][f"{kind}_{name}"] = bool(part(f"{kind}_{name}", lambda: fn(args)))

    shard = shard_epoch_state(synthetic_epoch_state(cfg, n_epoch, seed=0, epoch=250,
                                                    device=dev), mesh)
    step = step_body(cfg, mesh)
    for k in range(epochs):
        part(f"epoch{k + 1}", lambda: step(shard))
        if k == 0:
            out["digests"]["epoch1_balances"] = state_digest(gather_epoch_state(shard, mesh),
                                                             ("balances",))
    out["digests"]["epochs"] = state_digest(gather_epoch_state(shard, mesh))
    del shard
    edge_shard = shard_epoch_state(epoch_state_from_numpy(edge, dev), mesh)
    _, aux = part("edge", lambda: make_epoch_fn(cfg, mesh)(edge_shard))
    out["digests"]["edge"] = state_digest(gather_epoch_state(edge_shard, mesh))
    out["edge_aux"] = aux.flat().cpu().numpy()
    if hierarchical:
        hmesh = multihost.global_epoch_mesh(n_hosts=2, device_type=device)
        hshard = shard_epoch_state(synthetic_epoch_state(cfg, n_epoch, seed=0, epoch=250,
                                                         device=dev), hmesh)
        part("hierarchical", lambda: step_body(cfg, hmesh)(hshard))
        out["digests"]["hierarchical_balances"] = state_digest(
            gather_epoch_state(hshard, hmesh), ("balances",))
        out["coordinate"] = tuple(hmesh.get_coordinate())
    torch.cuda.synchronize()
    return out
