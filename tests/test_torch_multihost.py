"""The port's two-axis (dcn, data) layout (parallel/multihost.py) on four
gloo ranks on the CPU, factored as 2 virtual hosts x 2 ranks: the mesh's
axes, shape and coordinates, the ValueError for 3 hosts over 4 ranks, the
hierarchical shardings against JAX's, and the hierarchical epoch step equal
to the flat one and to the JAX package's single-device step (the shape of
tests/test_multihost.py: altair minimal, n = 64 a device of JAX's 8-device
mesh, seed 7). One spawn (`testlib/ranks.run_ranks`, worker
`testlib/mesh_workers.multihost_ranks`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from consensus_specs_tpu.compiler import get_spec
from consensus_specs_tpu.engine import epoch as jepoch
from consensus_specs_tpu.engine import state as jstate
from consensus_specs_tpu.parallel import multihost as jmultihost
from consensus_specs_tpu_torch.engine.state import EpochConfig
from consensus_specs_tpu_torch.engine.synthetic import synthetic_epoch_state_numpy
from consensus_specs_tpu_torch.parallel import multihost
from consensus_specs_tpu_torch.testlib import mesh_workers
from consensus_specs_tpu_torch.testlib.ranks import run_ranks

N = 64 * 8


@pytest.fixture(scope="module")
def run():
    cfg = EpochConfig.altair_minimal()
    leaves = synthetic_epoch_state_numpy(cfg, N, seed=7)
    jfn = jax.jit(jepoch.make_epoch_fn(jstate.EpochConfig.from_spec(get_spec("altair", "minimal")),
                                       with_jit=False))

    def reference():
        out, aux = jfn(jstate.EpochState(**{k: jnp.asarray(v) for k, v in leaves.items()}))
        flat = np.concatenate([np.atleast_1d(np.asarray(getattr(aux, f.name)))
                               for f in dataclasses.fields(aux)])
        return {f.name: np.asarray(getattr(out, f.name)) for f in dataclasses.fields(out)}, flat

    return run_ranks(mesh_workers.multihost_ranks, 4, "gloo", "cpu", cfg, leaves,
                     meanwhile=reference)


def test_initialize_single_process_is_noop():
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False


def test_global_mesh_factoring(run):
    ranks, _ = run
    for rank, r in enumerate(ranks):
        assert r["axes"] == (multihost.DCN_AXIS, multihost.ICI_AXIS) == ("dcn", "data")
        assert r["shape"] == (2, 2)
        assert r["coordinate"] == (rank // 2, rank % 2)
        assert r["three_hosts_raise"] is True and r["shard_raises"] is True
        assert r["block_rows"] == N // 4
        assert r["first_two"] == ([0, 1] if rank < 2 else None)


def test_hierarchical_shardings_match_jax(run):
    ranks, _ = run
    ref = jmultihost.hierarchical_epoch_shardings(jmultihost.global_epoch_mesh(n_hosts=2))
    want = {f.name: tuple(getattr(ref, f.name).spec) for f in dataclasses.fields(ref)}
    got = ranks[0]["shardings"]
    assert got.keys() == want.keys()
    for name, spec in want.items():
        assert (spec == ((multihost.DCN_AXIS, multihost.ICI_AXIS),)) == (got[name] == (
            "dcn", "data")), name
        assert (spec == ()) == (got[name] == ()), name


def test_hierarchical_epoch_equals_flat_and_jax(run):
    ranks, (want, want_aux) = run
    for r in ranks:
        (hier, hier_aux), (flat, flat_aux) = r["hierarchical"], r["flat"]
        for name, a in want.items():
            np.testing.assert_array_equal(hier[name], a, err_msg=name)
            np.testing.assert_array_equal(flat[name], a, err_msg=name)
        np.testing.assert_array_equal(hier_aux, want_aux)
        np.testing.assert_array_equal(flat_aux, want_aux)
