"""Test harness config: force a hermetic 8-device virtual CPU mesh.

Multi-chip TPU hardware is not available in CI; sharded code paths
(pjit/shard_map over a Mesh) are validated on 8 virtual CPU devices, mirroring
how the driver's dryrun_multichip compile-checks the multi-chip path.

The accelerator-avoidance dance (env override, plugin-factory drop, config
update) lives in the shared helper consensus_specs_tpu.utils.backend.force_cpu
— the same path __graft_entry__.dryrun_multichip and bench.py's debug lane
use, so all TPU-free entry points pin the backend identically.
"""
import os
from pathlib import Path

import pytest

from consensus_specs_tpu.utils.backend import enable_compile_cache, force_cpu

jax = force_cpu(8)

# Persistent XLA compilation cache: the CPU-run pairing kernels compile for
# tens of seconds to minutes; cache them across runs so only the first-ever
# run pays (VERDICT r2 item 7). Safe to delete any time.
enable_compile_cache(str(Path(__file__).parent / ".jax_cache"))


# --- reference-parity CLI flags (test/conftest.py --preset/--fork/--bls-type)


def pytest_addoption(parser):
    parser.addoption(
        "--preset", default=None,
        help="run spec tests on this preset (default: minimal)")
    parser.addoption(
        "--fork", default=None,
        help="restrict decorator-matrix spec tests to one fork")
    parser.addoption(
        "--bls", choices=["on", "off"], default=None,
        help="force the BLS kill-switch for the whole run")


def pytest_configure(config):
    from consensus_specs_tpu.crypto import bls
    from consensus_specs_tpu.testlib import context

    config.addinivalue_line(
        "markers",
        "slow: multi-minute compile-bound crypto tests; default `make test` "
        "lane skips them, `make citest`/`testall` runs everything")
    config.addinivalue_line(
        "markers",
        "evm: deposit-contract EVM harness / twin differential conformance "
        "tests (pure Python, no accelerator)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the PyTorch port's CUDA kernels); skips "
        "with a reason where torch.cuda.is_available() is False")

    preset = config.getoption("--preset")
    if preset:
        context.DEFAULT_TEST_PRESET = preset
    fork = config.getoption("--fork")
    if fork:
        from consensus_specs_tpu.compiler.spec_compiler import FORK_ORDER

        if fork not in FORK_ORDER:
            raise pytest.UsageError(
                f"--fork {fork!r} unknown (choose from {FORK_ORDER})")
        context.FORK_RESTRICTION = fork
    bls_opt = config.getoption("--bls")
    if bls_opt:
        bls.bls_active = bls_opt == "on"


@pytest.fixture(scope="session", autouse=True)
def _obs_snapshot_artifact():
    """When OBS_SNAPSHOT names a path (the `make chaos` and CI lanes), write
    the canonical metrics-registry snapshot there at session end — every
    counter the instrumented seams ticked during the run becomes a diffable
    artifact. tools/obs_dump.py `check` validates it; silent corruption of
    the format fails the lane, not a later consumer."""
    yield
    path = os.environ.get("OBS_SNAPSHOT")
    if not path:
        return
    from consensus_specs_tpu.obs import export as obs_export

    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    obs_export.write_snapshot(
        path, meta={"lane": os.environ.get("OBS_SNAPSHOT_LANE", "pytest")})
