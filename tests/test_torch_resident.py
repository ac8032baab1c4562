"""The port's resident epoch loop (consensus_specs_tpu_torch/engine/
resident.py, plain versions on the CPU) against the JAX package's resident
step run epoch by epoch; the state conversion round trip; the entry points'
refusal to fall back to the CPU; and the port's independence from JAX."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.engine import epoch as jepoch
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.engine.resident import _step_body
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.engine.convert import (
    epoch_state_from_numpy,
    epoch_state_to_numpy,
)
from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop, step_body
from consensus_specs_tpu_torch.engine.state import DIRTY_TRACKED, EpochConfig, EpochState
from consensus_specs_tpu_torch.engine.synthetic import (
    synthetic_epoch_state,
    synthetic_epoch_state_numpy,
)
from consensus_specs_tpu_torch.ops.sha256_host import words_to_bytes
from consensus_specs_tpu_torch.utils.device import is_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_loop(d: dict, k: int):
    """k JAX resident steps; returns (final numpy state, hist roots as
    bytes, eth1 resets, sync updates, OR of dirty_cols)."""
    from consensus_specs_tpu.compiler import get_spec

    jc = jstate.EpochConfig.from_spec(get_spec("altair", "minimal"))
    step = jax.jit(_step_body(jc))
    st = jstate.EpochState(**{name: jnp.asarray(v) for name, v in d.items()})
    hist, eth1, sync = [], 0, 0
    dirty = np.zeros(len(DIRTY_TRACKED), dtype=bool)
    for _ in range(k):
        st, aux = step(st)
        if bool(aux.historical_append):
            hist.append(words_to_bytes(np.asarray(
                jepoch.historical_batch_root(st.block_roots, st.state_roots))))
        eth1 += int(aux.eth1_votes_reset)
        sync += int(aux.sync_committee_update)
        dirty |= np.asarray(aux.dirty_cols)
    final = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(EpochState)}
    return final, hist, eth1, sync, dirty


@pytest.mark.parametrize("seed", [2, 9])
def test_resident_loop_matches_jax_resident_steps(seed):
    """k = 9 minimal-preset epochs from epoch 100: the run crosses epoch 104,
    where a historical append, an eth1 reset and a sync rotation all fire."""
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, 64, seed=seed, epoch=100)
    ref, hist, eth1, sync, dirty = _jax_loop(d, 9)
    loop = ResidentEpochLoop(cfg, epoch_state_from_numpy(d, "cpu"), device="cpu")
    loop.run_epochs(9)
    loop.flush()
    got = epoch_state_to_numpy(loop.state)
    for name, v in ref.items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    assert (len(hist), eth1, sync) == (1, 2, 1)
    assert [words_to_bytes(r.numpy()) for r in loop.historical_roots] == hist
    assert (loop.eth1_votes_resets, loop.sync_committee_updates, loop.epochs) == (eth1, sync, 9)
    np.testing.assert_array_equal(loop.dirty, dirty)


def test_step_body_advances_slot_in_place():
    cfg = EpochConfig.altair_minimal()
    st = synthetic_epoch_state(cfg, 16, seed=1, device="cpu")
    slot0 = int(st.slot)
    out, aux = step_body(cfg)(st)
    assert out is st and int(st.slot) == slot0 + cfg.slots_per_epoch
    assert aux.dirty_cols.shape == (len(DIRTY_TRACKED),)


def test_loop_field_roots_match_direct_call():
    cfg = EpochConfig.altair_minimal()
    st = synthetic_epoch_state(cfg, 16, seed=3, device="cpu")
    s01 = torch.arange(16 * 16, dtype=torch.int32).reshape(16, 16)
    loop = ResidentEpochLoop(cfg, st, device="cpu")
    loop.step_epoch()
    roots = loop.field_roots(s01)
    direct = troot.field_roots(loop.state, s01)
    assert roots.keys() == direct.keys() == troot.DEVICE_FIELDS
    for k in roots:
        assert torch.equal(roots[k], direct[k]), k


def test_convert_round_trip_is_exact():
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, 33, seed=5)
    d["exit_epoch"][:3] = np.uint64(2**64 - 1)
    d["balances"][3] = np.uint64(2**63 + 5)
    d["randao_mixes"][0] = 0xFFFFFFFF
    st = epoch_state_from_numpy(d, "cpu")
    assert st.exit_epoch.dtype == torch.int64 and int(st.exit_epoch[0]) == -1
    assert st.randao_mixes.dtype == torch.int32
    back = epoch_state_to_numpy(st)
    assert back.keys() == d.keys()
    for k, v in d.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, 4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_epoch_state(cfg, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        epoch_state_from_numpy(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResidentEpochLoop(cfg, epoch_state_from_numpy(d, "cpu"))
    with pytest.raises(ValueError):
        is_cpu(torch.empty(1, device="meta"))


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and loads no
    jax, flax, yaml (the machine with the card has none) or JAX-package
    module (matched by exact name or dotted prefix: the port's own name
    starts with `consensus_specs_tpu`); the spec compiler, the SSZ layer
    and the bridge are among the modules imported."""
    code = (
        "import json, sys, importlib, pkgutil\n"
        "before = set(sys.modules)\n"
        "import consensus_specs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "banned = ('jax', 'jaxlib', 'flax', 'yaml', 'consensus_specs_tpu')\n"
        "print(json.dumps({'bad': sorted(m for m in new if any(\n"
        "    m == b or m.startswith(b + '.') for b in banned)),\n"
        "    'port': sorted(m for m in new if m.startswith(p.__name__))}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    seen = json.loads(res.stdout.strip().splitlines()[-1])
    assert seen["bad"] == []
    for name in ("engine.resident", "compiler.spec_compiler", "ssz.types", "ssz.merkle",
                 "engine.bridge", "engine.routing", "testlib.big_state", "parallel.mesh",
                 "parallel.collectives", "parallel.multihost", "testlib.ranks",
                 "testlib.mesh_workers"):
        assert f"consensus_specs_tpu_torch.{name}" in seen["port"], name
