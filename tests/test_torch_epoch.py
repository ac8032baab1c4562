"""The port's `process_epoch` (consensus_specs_tpu_torch/engine/epoch.py,
plain version on the CPU) against the JAX package's `make_epoch_fn`: every
field of the post-state and every aux leaf bit-equal, on synthetic states
across seeds and on edge states that reach each branch of the program.
Also: the port's EpochConfig literals and synthetic states against the
JAX package's. Exact equality throughout (integer arithmetic)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# importing the JAX engine's state module turns on jax x64 (engine/state.py:31)
# before any uint64 input is built
from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.engine import epoch as jepoch
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.engine import synthetic as jsynthetic
from consensus_specs_tpu_torch.engine import epoch as tepoch
from consensus_specs_tpu_torch.engine.convert import (
    epoch_config_from_dict,
    epoch_state_from_numpy,
    epoch_state_to_numpy,
)
from consensus_specs_tpu_torch.engine.state import DIRTY_TRACKED, EpochConfig, EpochState
from consensus_specs_tpu_torch.engine.synthetic import EDGE_STATES, synthetic_epoch_state_numpy
from consensus_specs_tpu_torch.utils import u64

FAR = np.uint64(2**64 - 1)
AUX = ("historical_append", "eth1_votes_reset", "sync_committee_update", "dirty_cols")


@pytest.fixture(scope="module")
def jcfgs():
    return {(fork, preset): jstate.EpochConfig.from_spec(get_spec(fork, preset))
            for fork in ("altair", "bellatrix") for preset in ("minimal", "mainnet")}


@pytest.fixture(scope="module")
def jit_epoch(jcfgs):
    fns = {}

    def get(key):
        if key not in fns:
            fns[key] = jax.jit(jepoch.make_epoch_fn(jcfgs[key], with_jit=False))
        return fns[key]

    return get


@pytest.mark.parametrize("fork,preset", [("altair", "minimal"), ("altair", "mainnet"),
                                         ("bellatrix", "minimal"), ("bellatrix", "mainnet")])
def test_config_literals_match_spec(jcfgs, fork, preset):
    ref = dataclasses.asdict(jcfgs[(fork, preset)])
    ours = getattr(EpochConfig, f"{fork}_{preset}")()
    assert dataclasses.asdict(ours) == ref
    assert epoch_config_from_dict(ref) == ours


@pytest.mark.parametrize("preset,n,seed,epoch", [
    ("minimal", 100, 0, 100), ("minimal", 257, 3, 7), ("mainnet", 64, 1, 255)])
def test_synthetic_state_matches_jax(jcfgs, preset, n, seed, epoch):
    cfg = getattr(EpochConfig, f"altair_{preset}")()
    ours = synthetic_epoch_state_numpy(cfg, n, seed=seed, epoch=epoch)
    ref = jsynthetic.synthetic_epoch_state(jcfgs[("altair", preset)], n, seed=seed, epoch=epoch)
    for f in dataclasses.fields(EpochState):
        a = np.asarray(getattr(ref, f.name))
        assert a.dtype == ours[f.name].dtype, f.name
        np.testing.assert_array_equal(ours[f.name], a, err_msg=f.name)


def _run_both(jit_epoch, fork, preset, d):
    cfg = getattr(EpochConfig, f"{fork}_{preset}")()
    ref_st, ref_aux = jit_epoch((fork, preset))(
        jstate.EpochState(**{k: jnp.asarray(v) for k, v in d.items()}))
    st = epoch_state_from_numpy(d, "cpu")
    out, aux = tepoch.make_epoch_fn(cfg)(st)
    assert out is st, "process_epoch updates its input in place"
    got = epoch_state_to_numpy(out)
    for f in dataclasses.fields(EpochState):
        np.testing.assert_array_equal(got[f.name], np.asarray(getattr(ref_st, f.name)),
                                      err_msg=f.name)
    for name in AUX:
        np.testing.assert_array_equal(getattr(aux, name).numpy(),
                                      np.asarray(getattr(ref_aux, name)), err_msg=name)
    return got, aux


@pytest.mark.parametrize("preset,n", [("minimal", 256), ("mainnet", 512)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_process_epoch_synthetic_matches_jax(jit_epoch, preset, n, seed):
    cfg = getattr(EpochConfig, f"altair_{preset}")()
    _run_both(jit_epoch, "altair", preset, synthetic_epoch_state_numpy(cfg, n, seed))


@pytest.mark.parametrize("case", sorted(EDGE_STATES))
@pytest.mark.parametrize("fork", ["altair", "bellatrix"])
def test_process_epoch_edge_states_match_jax(jit_epoch, case, fork):
    cfg = getattr(EpochConfig, f"{fork}_minimal")()
    d = EDGE_STATES[case](cfg, 256, seed=11)
    pre = {k: v.copy() for k, v in d.items()}
    got, aux = _run_both(jit_epoch, fork, "minimal", d)
    # each case really reaches its branch
    if case == "leak":
        assert got["finalized_epoch"] == 5
    if case == "full_participation":
        assert got["finalized_epoch"] > pre["finalized_epoch"]
        assert got["justification_bits"][:2].all()
    if case in ("ejections_beyond_churn", "ejections_and_queue"):
        ejected = (pre["exit_epoch"] == FAR) & (got["exit_epoch"] != FAR)
        assert ejected.sum() > cfg.min_per_epoch_churn_limit
        assert len(np.unique(got["exit_epoch"][ejected])) > 1
    if case in ("activation_queue_beyond_churn", "ejections_and_queue"):
        activated = (pre["activation_epoch"] == FAR) & (got["activation_epoch"] != FAR)
        waiting = (got["activation_epoch"] == FAR) & (got["activation_eligibility_epoch"] <= 98)
        assert activated.sum() >= cfg.min_per_epoch_churn_limit and waiting.any()
    if case == "slashing_hit":
        assert aux.dirty_cols[DIRTY_TRACKED.index("balances")]
    if case == "boundary":
        assert bool(aux.historical_append) and bool(aux.eth1_votes_reset)
        assert bool(aux.sync_committee_update)
    if case == "genesis":
        assert got["justification_bits"].tolist() == pre["justification_bits"].tolist()


def test_epoch_kernel_params_follow_config():
    cfg = EpochConfig.bellatrix_mainnet()
    vals = tepoch._params(cfg)
    assert vals[11] == cfg.inactivity_score_bias * cfg.inactivity_penalty_quotient
    assert vals[-1] == 2**64 - 1 and len(vals) == 29
    with pytest.raises(ValueError):
        tepoch._params(dataclasses.replace(cfg, participation_flag_weights=(1, 2)))


def test_isqrt_matches_integer_sqrt():
    import math

    for x in (1, 2, 3, 4, 15, 16, 17, 2**32, 10**16 + 7, 2**57 - 1, 32_000_000_000 * 2**20):
        assert tepoch._isqrt_u64(x) == math.isqrt(x)


def test_u64_helpers_match_numpy_uint64():
    """The int64-as-uint64 helpers against numpy's own uint64 arithmetic,
    on random patterns plus FAR (-1 as int64), 0 and the sign boundary."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**64, 300, dtype=np.uint64)
    b = rng.integers(0, 2**64, 300, dtype=np.uint64)
    a[:4] = [FAR, 0, 2**63, 5]
    b[:4] = [0, FAR, 2**63 - 1, 5]
    ta, tb = torch.from_numpy(a.view(np.int64)), torch.from_numpy(b.view(np.int64))
    np.testing.assert_array_equal(u64.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(u64.ule(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal(u64.ult(ta, 2**63).numpy(), a < np.uint64(2**63))
    np.testing.assert_array_equal(u64.umax(ta, tb).numpy().view(np.uint64), np.maximum(a, b))
    assert u64.as_u64(int(u64.umax_reduce(ta))) == int(a.max())
    order = torch.sort(u64.sort_key(ta), stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(a, kind="stable"))
    assert u64.as_i64(2**64 - 1) == u64.FAR and u64.as_u64(u64.FAR) == 2**64 - 1
    w = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tw = u64.words_i64(torch.from_numpy(w.view(np.int32)))
    np.testing.assert_array_equal(u64.bswap32(tw).numpy().astype(np.uint32), w.byteswap())
    np.testing.assert_array_equal(u64.words_i32(tw).numpy().view(np.uint32), w)
