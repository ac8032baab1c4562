"""The port's registry-sharded epoch step (engine/epoch.py
`make_epoch_fn(cfg, mesh)`: K3's phases, plain on the CPU, with gathers
between them) on gloo ranks on the CPU, against the JAX package's
`make_epoch_fn` on the whole registry: every field and every aux leaf
bit-equal, at 2 and 4 ranks, on seeds 0 and 7 at n = 1024 (the shape of
tests/test_mesh_epoch.py) and on the edge states whose exit queue,
activation order and slashings cross ranks. Also: the plain phases
composed equal `process_epoch_plain`, two sharded resident steps equal the
single-device loop, and the layout equals JAX's shardings.

Both spawns (`testlib/ranks.run_ranks`, workers in
`testlib/mesh_workers.epoch_ranks`) run at once, beside the JAX references.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.engine import epoch as jepoch
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.parallel.mesh import epoch_state_shardings, make_mesh
from consensus_specs_tpu_torch.engine import epoch as tepoch
from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy, epoch_state_to_numpy
from consensus_specs_tpu_torch.engine.resident import step_body
from consensus_specs_tpu_torch.engine.state import EpochConfig, EpochState
from consensus_specs_tpu_torch.engine.synthetic import (
    edge_epoch_state_numpy,
    synthetic_epoch_state_numpy,
)
from consensus_specs_tpu_torch.parallel.mesh import epoch_state_layout
from consensus_specs_tpu_torch.testlib import mesh_workers
from consensus_specs_tpu_torch.testlib.ranks import run_ranks

N = 1024
CASES = ("seed0", "seed7", "ejections_and_queue", "slashing_hit", "boundary")
RESIDENT_STEPS = 2


def _states(cfg) -> dict:
    out = {f"seed{s}": synthetic_epoch_state_numpy(cfg, N, seed=s, epoch=100) for s in (0, 7)}
    out.update({case: edge_epoch_state_numpy(cfg, case, N, 0) for case in CASES[2:]})
    return out


class OneRank:
    """A one-rank stand-in for parallel/mesh.MeshComm."""

    size, rank = 1, 0

    @staticmethod
    def all_gather(t):
        return t[None].clone()


@pytest.fixture(scope="module")
def cfg():
    return EpochConfig.altair_mainnet()


@pytest.fixture(scope="module")
def run(cfg):
    states = _states(cfg)
    jfn = jax.jit(jepoch.make_epoch_fn(jstate.EpochConfig.from_spec(get_spec("altair", "mainnet")),
                                       with_jit=False))

    def meanwhile():
        two = run_ranks(mesh_workers.epoch_ranks, 2, "gloo", "cpu", cfg, states, RESIDENT_STEPS)
        refs = {}
        for case, d in states.items():
            out, aux = jfn(jstate.EpochState(**{k: jnp.asarray(v) for k, v in d.items()}))
            refs[case] = ({f.name: np.asarray(getattr(out, f.name))
                           for f in dataclasses.fields(out)},
                          {f.name: np.asarray(getattr(aux, f.name))
                           for f in dataclasses.fields(aux)})
        return two, refs

    four, (two, refs) = run_ranks(mesh_workers.epoch_ranks, 4, "gloo", "cpu", cfg, states,
                                  RESIDENT_STEPS, meanwhile=meanwhile)
    return {2: two, 4: four}, refs, states


def _aux_flat(aux: dict) -> np.ndarray:
    return np.concatenate([np.atleast_1d(aux[k]) for k in
                           ("historical_append", "eth1_votes_reset", "sync_committee_update",
                            "dirty_cols")])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax(run, world, case):
    ranks, refs, _ = run
    want, want_aux = refs[case]
    for rank, result in enumerate(ranks[world]):
        got, aux = result[case]
        for name, a in want.items():
            assert got[name].dtype == a.dtype, name
            np.testing.assert_array_equal(got[name], a, err_msg=f"{name} on rank {rank}")
        np.testing.assert_array_equal(aux, _aux_flat(want_aux), err_msg=f"aux on rank {rank}")


def test_edge_states_cross_ranks(run):
    """The edge states really decide across blocks: ejections past churn in
    every quarter of the registry (the exit queue runs over them), an
    activation queue in several quarters of which churn takes only some
    (the global sort decides), slashing penalties, all three aux flags."""
    _, refs, states = run
    pre, (post, _) = states["ejections_and_queue"], refs["ejections_and_queue"]
    quarters = (4, N // 4)
    ejected = pre["exit_epoch"] != post["exit_epoch"]
    assert ejected.reshape(quarters).any(1).all()
    assert len(set(post["exit_epoch"][ejected].tolist())) > 1
    far = np.uint64(2**64 - 1)
    queued = (pre["activation_epoch"] == far) & (pre["activation_eligibility_epoch"] != far)
    activated = pre["activation_epoch"] != post["activation_epoch"]
    assert queued.reshape(quarters).any(1).sum() >= 2
    assert activated.any() and (queued & ~activated).any()
    pre, (post, _) = states["slashing_hit"], refs["slashing_hit"]
    assert (post["balances"] < pre["balances"])[pre["slashed"]].any()
    assert _aux_flat(refs["boundary"][1])[:3].all()


@pytest.mark.parametrize("world", [2, 4])
def test_resident_steps_match_single_device(run, cfg, world):
    ranks, _, states = run
    st = epoch_state_from_numpy(states["seed0"], "cpu")
    step = step_body(cfg)
    for _ in range(RESIDENT_STEPS):
        st, aux = step(st)
    want = epoch_state_to_numpy(st)
    for result in ranks[world]:
        got, got_aux = result["resident"]
        for name, a in want.items():
            np.testing.assert_array_equal(got[name], a, err_msg=name)
        np.testing.assert_array_equal(got_aux, aux.flat().numpy())


@pytest.mark.parametrize("case", CASES)
def test_plain_phases_compose_to_process_epoch_plain(cfg, case):
    """The sharded step over one rank (the plain phases composed with the
    sharded glue) equals process_epoch_plain, which the existing tests hold
    against JAX."""
    d = _states(cfg)[case]
    want, want_aux = tepoch.process_epoch_plain(cfg, epoch_state_from_numpy(d, "cpu"))
    st = epoch_state_from_numpy(d, "cpu")
    aux = tepoch.sharded_epoch_step(cfg, st, OneRank())
    for name, t in want.items():
        assert torch.equal(getattr(st, name), t), name
    assert torch.equal(aux.flat(), want_aux.flat())


def test_combine_stages():
    parts = torch.tensor(np.random.default_rng(1).integers(0, 2**40, (3, 32)), dtype=torch.int64)
    parts[:, tepoch.S_SLASHINGS_SUM] = 77
    parts[1, tepoch.S_MAX_EXIT] = -1  # u64 max
    s0, s1, s2 = (tepoch.epoch_combine(parts, k) for k in range(3))
    for k in range(tepoch.S_ACTIVE_COUNT + 1):
        assert int(s0[k]) == int(parts[:, k].sum())
    assert int(s0[tepoch.S_MAX_EXIT]) == -1 and int(s0[tepoch.S_SLASHINGS_SUM]) == 77
    dirty = int(parts[0, tepoch.S_DIRTY]) | int(parts[1, tepoch.S_DIRTY]) | int(
        parts[2, tepoch.S_DIRTY])
    fc = int(parts[:, tepoch.S_FRONTIER_COUNT].sum())
    assert int(s0[tepoch.S_DIRTY]) == int(s1[tepoch.S_DIRTY]) == int(s2[tepoch.S_DIRTY]) == dirty
    assert int(s0[tepoch.S_FRONTIER_COUNT]) == int(s1[tepoch.S_FRONTIER_COUNT]) == fc
    assert int(s2[tepoch.S_FRONTIER_COUNT]) == int(parts[0, tepoch.S_FRONTIER_COUNT])
    keep = [k for k in range(32) if k not in (tepoch.S_DIRTY, tepoch.S_FRONTIER_COUNT)]
    assert torch.equal(s1[keep], parts[0, keep]) and torch.equal(s2[keep], parts[0, keep])
    with pytest.raises(ValueError):
        tepoch.epoch_combine(parts, 3)


def test_scal_slots_match_the_kernel_enum():
    """engine/epoch.py's S_* slots are csrc/epoch.cu's enum."""
    import re
    from pathlib import Path

    src = (Path(tepoch.__file__).parent.parent / "csrc" / "epoch.cu").read_text()
    body = re.search(r"enum \{\s*(S_TAB_SUM.*?)S_COUNT", src, re.S).group(1)
    slot, names = 0, {}
    for entry in re.sub(r"//[^\n]*", "", body).replace("\n", " ").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, value = entry.partition("=")
        name = name.strip()
        if value:
            base, _, plus = value.strip().partition("+")
            slot = names[base.strip()] + (int(plus) if plus else 0) if base.strip() in names \
                else int(base)
        names[name] = slot
        slot += 3 if name in ("S_FLAG0", "S_UP0") else 1
    for name, k in names.items():
        assert getattr(tepoch, name) == k, name


def test_layout_matches_jax_shardings():
    mesh = make_mesh(jax.devices()[:8])
    ref = epoch_state_shardings(mesh)
    want = {f.name: "split" if any(p is not None for p in getattr(ref, f.name).spec)
            else "replicated" for f in dataclasses.fields(ref)}
    assert epoch_state_layout() == want
    assert sorted(epoch_state_layout()) == sorted(f.name for f in dataclasses.fields(EpochState))
