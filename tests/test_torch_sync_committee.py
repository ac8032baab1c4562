"""The port's sync-committee sampler (consensus_specs_tpu_torch/engine/
sync_committee.py, plain versions on the CPU) against the JAX package's
`next_sync_committee_indices`, and the port's resident loop across a
sync-committee rotation against JAX resident steps (`_step_body`) followed
by the JAX engine's rotation recipe (engine/resident.py
`_rotate_sync_committees_resident`: the active set and effective balances
after the rotating step, the hashlib seed over its randao row, the JAX
sampler). All comparisons are exact."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.engine.resident import _step_body
from consensus_specs_tpu.engine.sync_committee import (
    next_sync_committee_indices as jax_next_sync_committee_indices,
)
from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy
from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop
from consensus_specs_tpu_torch.engine.state import EpochConfig
from consensus_specs_tpu_torch.engine.sync_committee import (
    next_sync_committee_indices,
    next_sync_committee_indices_plain,
    sync_committee_seed,
)
from consensus_specs_tpu_torch.engine.synthetic import synthetic_epoch_state_numpy
from consensus_specs_tpu_torch.ops.sha256_host import words_to_bytes
from consensus_specs_tpu_torch.ops.shuffle import seed_words_tensor


def _cfg(preset: str) -> EpochConfig:
    return getattr(EpochConfig, f"altair_{preset}")()


def _sampler_kwargs(cfg: EpochConfig) -> dict:
    return dict(sync_committee_size=cfg.sync_committee_size,
                max_effective_balance=cfg.max_effective_balance,
                shuffle_round_count=cfg.shuffle_round_count)


def _jax_seed(epoch: int, mix_words: np.ndarray) -> bytes:
    return hashlib.sha256(b"\x07\x00\x00\x00" + epoch.to_bytes(8, "little")
                          + words_to_bytes(mix_words)).digest()


@pytest.mark.parametrize("preset,n_registry,n_active", [
    ("minimal", 400, 300), ("minimal", 2500, 2000),
    ("mainnet", 900, 700), ("mainnet", 4000, 3000)])
def test_sampler_matches_jax(preset, n_registry, n_active):
    """Effective balances from 0 to 32 ETH, so many candidates are
    rejected and mainnet's 512 seats take several 1024-candidate chunks."""
    cfg = _cfg(preset)
    rng = np.random.default_rng(n_registry)
    eff = rng.integers(0, 33, n_registry, dtype=np.uint64) * np.uint64(10**9)
    eff[: n_registry // 10] = 0
    active = np.sort(rng.choice(n_registry, n_active, replace=False)).astype(np.uint64)
    seed = hashlib.sha256(bytes([n_active % 256]) * 7).digest()
    ref = jax_next_sync_committee_indices(active, eff, seed, **_sampler_kwargs(cfg))
    args = (torch.from_numpy(active.view(np.int64)), torch.from_numpy(eff.view(np.int64)),
            seed_words_tensor(seed, "cpu"))
    got = next_sync_committee_indices(*args, **_sampler_kwargs(cfg))
    assert got.dtype == torch.int64 and got.shape == (cfg.sync_committee_size,)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)
    assert torch.equal(next_sync_committee_indices_plain(*args, **_sampler_kwargs(cfg)), got)


@pytest.mark.parametrize("epoch", [0, 8, 256, 2**40 + 3])
def test_seed_matches_hashlib(epoch):
    mix = np.random.default_rng(epoch % 97).integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    got = sync_committee_seed(epoch, torch.from_numpy(mix.view(np.int32).copy()))
    assert words_to_bytes(got.numpy()) == _jax_seed(epoch, mix)


def _jax_rotations(d: dict, k: int):
    """k JAX resident steps from the numpy state d; at each step whose flag
    says the committee rotates, the committee by the JAX engine's recipe
    from the state that step left. Returns ([(epoch, active, seed,
    indices)], [the effective balances after the step that follows each
    rotation])."""
    cfg = EpochConfig.altair_minimal()
    jc = jstate.EpochConfig.from_spec(get_spec("altair", "minimal"))
    step = jax.jit(_step_body(jc))
    st = jstate.EpochState(**{name: jnp.asarray(v) for name, v in d.items()})
    epoch = int(d["slot"]) // cfg.slots_per_epoch
    rotations, eff_after = [], []
    for _ in range(k):
        st, aux = step(st)
        epoch += 1
        if rotations and len(eff_after) < len(rotations):
            eff_after.append(np.asarray(st.effective_balance))
        if not bool(aux.sync_committee_update):
            continue
        act, exit_ = np.asarray(st.activation_epoch), np.asarray(st.exit_epoch)
        active = np.nonzero((act <= np.uint64(epoch)) & (np.uint64(epoch) < exit_))[0]
        epv = cfg.epochs_per_historical_vector
        mix = np.asarray(st.randao_mixes[(epoch + epv - cfg.min_seed_lookahead - 1) % epv])
        seed = _jax_seed(epoch, mix)
        rotations.append((epoch, active.astype(np.uint64), seed, jax_next_sync_committee_indices(
            active.astype(np.uint64), np.asarray(st.effective_balance), seed,
            **_sampler_kwargs(cfg))))
    return rotations, eff_after


def _run_port(d: dict, k: int) -> ResidentEpochLoop:
    loop = ResidentEpochLoop(EpochConfig.altair_minimal(), epoch_state_from_numpy(d, "cpu"),
                             device="cpu")
    loop.run_epochs(k)
    loop.flush()
    return loop


@pytest.mark.parametrize("seed", [4, 13])
def test_resident_rotation_matches_jax(seed):
    """altair minimal (period 8) from epoch 100: the fourth step enters
    epoch 104 and rotates, and the run goes on five epochs past it."""
    d = synthetic_epoch_state_numpy(EpochConfig.altair_minimal(), 256, seed=seed, epoch=100)
    rotations, _ = _jax_rotations(d, 9)
    loop = _run_port(d, 9)
    assert [r[0] for r in rotations] == [104]
    assert loop.sync_committee_updates == 1 and loop.current_sync_committee is None
    np.testing.assert_array_equal(loop.next_sync_committee.numpy().view(np.uint64),
                                  rotations[0][3])
    assert loop.epoch == 109 and len(loop.sync_rotation_seconds) == 1


def _rotation_then_slashing(n: int, seed: int) -> dict:
    """altair minimal at epoch 7: the first step enters epoch 8 and
    rotates; the second, at epoch 8, applies process_slashings to a tenth
    of the registry (withdrawable epoch 8 + EPSV/2, a slashings vector that
    takes the whole balance), so their effective balances fall in the
    epoch right after the rotation."""
    cfg = EpochConfig.altair_minimal()
    d = synthetic_epoch_state_numpy(cfg, n, seed, epoch=cfg.epochs_per_sync_committee_period - 1)
    hit = np.random.default_rng(seed + 300).random(n) < 0.1
    d["slashed"][hit] = True
    d["withdrawable_epoch"][hit] = np.uint64(cfg.epochs_per_sync_committee_period
                                             + cfg.epochs_per_slashings_vector // 2)
    d["slashings"][:] = np.uint64(4_000_000_000_000)
    return d


def test_rotation_is_serviced_before_the_next_step():
    """A committee sampled one epoch late would read the effective balances
    the slashings cut: the test first shows that such a committee differs,
    then that the loop's committee is the one of the rotating epoch."""
    cfg = EpochConfig.altair_minimal()
    d = _rotation_then_slashing(512, 3)
    rotations, eff_after = _jax_rotations(d, 3)
    (epoch, active, seed, want), = rotations
    assert epoch == cfg.epochs_per_sync_committee_period
    late = jax_next_sync_committee_indices(active, eff_after[0], seed, **_sampler_kwargs(cfg))
    assert not np.array_equal(late, want), "the edge state must change the committee"
    loop = _run_port(d, 3)
    np.testing.assert_array_equal(loop.next_sync_committee.numpy().view(np.uint64), want)
    assert int(loop.state.slot) // cfg.slots_per_epoch == loop.epoch == epoch + 2


def test_sampler_rejects_an_empty_active_set():
    with pytest.raises(ValueError):
        next_sync_committee_indices(torch.zeros(0, dtype=torch.int64),
                                    torch.zeros(4, dtype=torch.int64),
                                    seed_words_tensor(b"\x00" * 32, "cpu"),
                                    **_sampler_kwargs(_cfg("minimal")))
