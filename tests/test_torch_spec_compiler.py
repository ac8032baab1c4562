"""The port's spec compiler (consensus_specs_tpu_torch/compiler) against the
JAX package's (consensus_specs_tpu/compiler): for all six forks (phase0,
altair, bellatrix and the R&D overlays sharding, das, custody_game) under
the minimal and mainnet presets, the same public constants with the same
values, the same runtime config, the same public names and the same
rendered source text; the port's `KEY: value` reader against PyYAML on every
copied preset and config file. Exact equality throughout."""
import types

import pytest
import yaml

from consensus_specs_tpu.compiler import spec_compiler as jcomp
from consensus_specs_tpu_torch.compiler import spec_compiler as tcomp

FORKS = ("phase0", "altair", "bellatrix", "sharding", "das", "custody_game")
PRESETS = ("minimal", "mainnet")
PRESET_FORKS = tuple(f for f in FORKS if f != "das")  # das has no preset file in either package


def _public_constants(spec) -> dict:
    return {k: v for k, v in vars(spec).items() if k.isupper()}


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("fork", FORKS)
def test_compiled_spec_constants_match_jax(fork, preset):
    ours = tcomp.build_spec(fork, preset, device="cpu")
    ref = jcomp.build_spec(fork, preset)
    mine, theirs = _public_constants(ours), _public_constants(ref)
    assert sorted(mine) == sorted(theirs)
    for name, value in theirs.items():
        if isinstance(value, (int, bytes, str, tuple, list, dict, bool, float)):
            assert mine[name] == value, name
        else:  # objects the documents instantiate (EXECUTION_ENGINE): one class
            assert type(mine[name]).__name__ == type(value).__name__, name
    assert ours.config._values == ref.config._values
    public = {k for k in vars(ref) if not k.startswith("_")}
    assert public <= set(vars(ours))
    assert ours.fork == fork and ours.preset_name == preset


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("fork", FORKS)
def test_render_spec_source_matches_jax(fork, preset):
    assert tcomp.render_spec_source(fork, preset) == jcomp.render_spec_source(fork, preset)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("fork", PRESET_FORKS)
def test_key_value_reader_matches_yaml(fork, preset):
    path = tcomp.PRESET_DIR / preset / f"{fork}.yaml"
    assert tcomp.read_key_values(path) == yaml.safe_load(path.read_text())
    ref = jcomp.CONFIG_DIR / "presets" / preset / f"{fork}.yaml"
    assert tcomp.read_key_values(path) == yaml.safe_load(ref.read_text())


@pytest.mark.parametrize("preset", PRESETS)
def test_config_reader_matches_jax(preset):
    path = tcomp.CONFIG_DIR / f"{preset}.yaml"
    assert tcomp.read_key_values(path) == yaml.safe_load(path.read_text())
    assert tcomp.load_config(preset) == jcomp.load_config(preset)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_files_are_the_jax_packages(preset):
    """The port copies every preset file the JAX package has, and no other."""
    ours = sorted(p.name for p in (tcomp.PRESET_DIR / preset).glob("*.yaml"))
    theirs = sorted(p.name for p in (jcomp.CONFIG_DIR / "presets" / preset).glob("*.yaml"))
    assert ours == theirs == sorted(f"{f}.yaml" for f in PRESET_FORKS)


def test_unknown_fork_raises():
    with pytest.raises(ValueError, match="unknown fork"):
        tcomp.build_spec("eip4844", "minimal", device="cpu")
    with pytest.raises(ValueError, match="unknown fork"):
        tcomp.render_spec_source("eip4844", "minimal")


def test_das_kernels_are_bound_to_the_spec_device():
    """`das_kernels` carries crypto/das's public names, its NTT functions
    bound to the spec's device; the compiled spec's extension equals the
    das module's on that device."""
    import torch

    from consensus_specs_tpu_torch.crypto import das

    device = "cpu"
    spec = tcomp.build_spec("das", "minimal", device=device)
    dk = spec.das_kernels
    public = {k for k in vars(das) if not k.startswith("_")
              and not isinstance(getattr(das, k), types.ModuleType)}
    assert public == set(vars(dk))
    assert dk.recover_data.keywords == {"device": torch.device(device)}
    assert dk.MODULUS == das.MODULUS and dk.root_of_unity is das.root_of_unity
    data = list(range(1, 17))
    assert spec.das_fft_extension(data) == das.das_fft_extension(data, device=device)


def test_build_spec_is_fresh_and_get_spec_caches():
    a = tcomp.build_spec("altair", "minimal", device="cpu")
    b = tcomp.build_spec("altair", "minimal", device="cpu")
    assert a is not b and isinstance(a, types.ModuleType)
    assert tcomp.get_spec("altair", "minimal", device="cpu") is tcomp.get_spec(
        "altair", "minimal", device="cpu")


def test_shuffle_hook_matches_the_scalar_loop():
    """The compiled committee path through the `accelerated_shuffle` hook
    (the plain K4 + K5 on the CPU) equals the spec's scalar
    `compute_shuffled_index` loop."""
    spec = tcomp.build_spec("altair", "minimal", device="cpu")
    seed = spec.Bytes32(bytes(range(32)))
    n = 97
    hooked = spec._get_shuffled_index_map(spec.uint64(n), seed)
    scalar = [int(spec.compute_shuffled_index(spec.uint64(i), spec.uint64(n), seed))
              for i in range(n)]
    assert list(hooked) == scalar


def test_build_spec_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcomp.build_spec("altair", "minimal")
