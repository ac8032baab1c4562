"""The port's resident Merkle cache (consensus_specs_tpu_torch/engine/
incremental_root.py, plain versions on the CPU) against the JAX package's
`IncrementalStateRoot` after resident steps, on the masked branch (few
dirty validators: K6 + K7) and the full-rebuild branch (more than
MAX_DIRTY_VALIDATORS: K2 + K1); its tree levels, path updates and dirty
scan against the JAX functions; and the loop's `device_roots()` against
`field_roots` after in-place steps. All comparisons are exact.

The JAX programs compile once for the module, at altair minimal and
N = 2048 (more than the 1024-row budget, so both branches are reachable)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.engine import incremental_root as jinc
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.engine.resident import _step_body
from consensus_specs_tpu_torch.engine import incremental_root as tinc
from consensus_specs_tpu_torch.engine import state_root as troot
from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy
from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop, step_body
from consensus_specs_tpu_torch.engine.state import EpochConfig
from consensus_specs_tpu_torch.engine.synthetic import synthetic_epoch_state_numpy

N = 2048
CFG = EpochConfig.altair_minimal()
EPV = CFG.epochs_per_historical_vector


def _static01(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def _settled(n: int, seed: int, unsettled: int) -> dict:
    """The synthetic registry with every effective balance already where
    the hysteresis rule puts it (balance rounded down to the increment,
    capped), except `unsettled` validators at 20 ETH: the next epoch
    dirties about that many rows."""
    d = synthetic_epoch_state_numpy(CFG, n, seed, epoch=100)
    inc = np.uint64(CFG.effective_balance_increment)
    d["effective_balance"] = np.minimum(d["balances"] - d["balances"] % inc,
                                        np.uint64(CFG.max_effective_balance))
    pick = np.random.default_rng(seed + 1).choice(n, unsettled, replace=False)
    d["effective_balance"][pick] = np.uint64(20) * inc
    return d


SCENARIOS = {
    "masked": lambda: _settled(N, 5, 100),
    "full": lambda: synthetic_epoch_state_numpy(CFG, N, seed=6, epoch=100),
}
SCHEDULE = (1, 2, 1)  # epoch steps before each refresh


def _roots_np(roots: dict) -> dict:
    return {k: np.asarray(v).astype(np.uint32).reshape(8) if not isinstance(v, torch.Tensor)
            else v.numpy().view(np.uint32) for k, v in roots.items()}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def refreshes(request):
    """[(JAX roots, port roots, port branch, port dirty count)] after the
    build and after every refresh of SCHEDULE, plus the final caches and
    states, for one scenario."""
    d = SCENARIOS[request.param]()
    s01 = _static01(N)
    jc = jstate.EpochConfig.from_spec(get_spec("altair", "minimal"))
    jstep = jax.jit(_step_body(jc))
    jst = jstate.EpochState(**{k: jnp.asarray(v) for k, v in d.items()})
    jcache = jinc.IncrementalStateRoot(jst, jnp.asarray(s01))
    st = epoch_state_from_numpy(d, "cpu")
    tcache = tinc.IncrementalStateRoot(st, _t(s01))
    tstep = step_body(CFG)
    epoch = 100
    out = [(jcache.device_roots(int(jst.slot)), tcache.device_roots(st.slot),
            tcache.last_branch, tcache.last_dirty)]
    for count in SCHEDULE:
        for _ in range(count):
            jst, _ = jstep(jst)
            tstep(st)
            epoch += 1
        jcache.refresh_after_epochs(jst, epoch, count, EPV)
        tcache.refresh_after_epochs(st, epoch, count, EPV)
        out.append((jcache.device_roots(int(jst.slot)), tcache.device_roots(st.slot),
                    tcache.last_branch, tcache.last_dirty))
    return request.param, out, (jcache, jst), (tcache, st, _t(s01))


@pytest.mark.parametrize("at", range(1 + len(SCHEDULE)))
def test_device_roots_match_jax(refreshes, at):
    _, out, _, _ = refreshes
    jroots, troots, _, _ = out[at]
    assert set(troots) == troot.DEVICE_FIELDS
    ref, got = _roots_np(jroots), _roots_np(troots)
    for k in sorted(troot.DEVICE_FIELDS):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_scenario_takes_its_branch(refreshes):
    """The first refresh of "masked" goes through K6 + K7 with a few dozen
    dirty rows; the first of "full" rebuilds with most rows dirty."""
    name, out, _, _ = refreshes
    branch, dirty = out[1][2], out[1][3]
    if name == "masked":
        assert branch == "masked" and 50 <= dirty <= tinc.MAX_DIRTY_VALIDATORS
    else:
        assert branch == "full" and dirty > tinc.MAX_DIRTY_VALIDATORS


def test_record_roots_match_jax(refreshes):
    _, _, (jcache, jst), (tcache, st, s01) = refreshes
    rng = np.random.default_rng(9)
    for slot_index in (0, 5, CFG.slots_per_historical_root - 1):
        sroot = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        broot = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        jcache.record_state_root(slot_index, jnp.asarray(sroot))
        jcache.record_block_root(slot_index, jnp.asarray(broot))
        tcache.record_state_root(slot_index, _t(sroot))
        tcache.record_block_root(slot_index, _t(broot))
        st.state_roots[slot_index] = _t(sroot)
        st.block_roots[slot_index] = _t(broot)
    ref = _roots_np(jcache.device_roots(int(jst.slot)))
    got = _roots_np(tcache.device_roots(st.slot))
    direct = _roots_np(troot.field_roots(st, s01))
    for k in ("state_roots", "block_roots"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], direct[k], err_msg=k)


@pytest.mark.parametrize("c", [1, 2, 5, 64])
def test_tree_levels_and_path_updates_match_jax(c):
    chunks = _static01(c, c)[:, :8].copy()
    jl = jinc.build_tree_levels(jnp.asarray(chunks))
    tl = tinc.build_tree_levels(_t(chunks))
    assert tl.depth == len(jl) - 1
    for lvl, jlevel in enumerate(jl):
        np.testing.assert_array_equal(tl.level(lvl).numpy().view(np.uint32), np.asarray(jlevel))
    width = 1 << tl.depth
    node = _static01(1, 50)[0, :8].copy()
    jl = jinc.path_update(jl, jnp.asarray(width - 1), jnp.asarray(node))
    tinc.path_update(tl, width - 1, _t(node))
    idxs = np.array([0, width - 1, 0, width // 2], dtype=np.int64) % width
    nodes = _static01(1, 51)[:, :8].repeat(4, axis=0)  # duplicates carry equal nodes
    jl = jinc.multi_path_update(jl, jnp.asarray(idxs.astype(np.int32)), jnp.asarray(nodes))
    tinc.multi_path_update(tl, torch.from_numpy(idxs), _t(nodes))
    for lvl, jlevel in enumerate(jl):
        np.testing.assert_array_equal(tl.level(lvl).numpy().view(np.uint32), np.asarray(jlevel))


@pytest.mark.parametrize("dirty", [0, 7, 1500])
def test_dirty_scan_matches_jax(dirty):
    d = synthetic_epoch_state_numpy(CFG, N, seed=8)
    jst = jstate.EpochState(**{k: jnp.asarray(v) for k, v in d.items()})
    cached = [np.array(np.asarray(c)) for c in jinc._registry_cols(jst)]
    rows = np.random.default_rng(dirty).choice(N, dirty, replace=False)
    for j, r in enumerate(rows):  # one of the six columns differs in each dirty row
        col = cached[j % 6]
        col[r] = ~col[r] if col.dtype == np.bool_ else col[r] ^ np.uint64(1)
    count, idxs, copies = jinc._dirty_scan_fn()(jinc._registry_cols(jst),
                                                tuple(jnp.asarray(c) for c in cached))
    # copies: the JAX arrays may share the numpy buffers, and K6 writes its cache
    tcached = tuple(torch.from_numpy((c.view(np.int64) if c.dtype == np.uint64 else c).copy())
                    for c in cached)
    fresh = troot.registry_columns(epoch_state_from_numpy(d, "cpu"))
    tcount, tidx = tinc.dirty_scan(fresh, tcached)
    assert int(tcount[0]) == int(count) == dirty
    take = min(dirty, tinc.MAX_DIRTY_VALIDATORS)
    np.testing.assert_array_equal(np.sort(tidx[:take].numpy()), np.asarray(idxs)[:take])
    for a, b in zip(tcached, copies):
        got = a.numpy().view(np.uint64) if a.dtype == torch.int64 else a.numpy()
        np.testing.assert_array_equal(got, np.asarray(b))


def _loop_roots_match(loop, s01) -> bool:
    roots, direct = loop.device_roots(s01), troot.field_roots(loop.state, s01)
    return all(torch.equal(roots[k], direct[k]) for k in troot.DEVICE_FIELDS)


def test_loop_device_roots_follow_in_place_steps():
    """The loop's steps overwrite the state in place. Its cache must hold
    copies of the registry columns: the test first shows that a cache of
    views goes stale, then that the loop's roots equal field_roots at every
    refresh over ten epochs (the rotation into epoch 104 among them)."""
    d = _settled(256, 2, 40)
    s01 = _t(_static01(256, 3))
    viewed = ResidentEpochLoop(CFG, epoch_state_from_numpy(d, "cpu"), device="cpu")
    viewed.device_roots(s01)
    viewed.root_cache._cached_cols = troot.registry_columns(viewed.state)
    viewed.step_epoch()
    assert not _loop_roots_match(viewed, s01), "a cache of views must go stale"

    loop = ResidentEpochLoop(CFG, epoch_state_from_numpy(d, "cpu"), device="cpu")
    loop.device_roots(s01)
    branches = []
    for count in (1, 3, 6):
        loop.run_epochs(count)
        assert _loop_roots_match(loop, s01)
        branches.append(loop.root_cache.last_branch)
    assert branches[0] == "masked" and loop.sync_committee_updates == 1


def test_device_roots_needs_static01_first():
    loop = ResidentEpochLoop(CFG, epoch_state_from_numpy(
        synthetic_epoch_state_numpy(CFG, 8, seed=0), "cpu"), device="cpu")
    with pytest.raises(ValueError, match="static01"):
        loop.device_roots()
