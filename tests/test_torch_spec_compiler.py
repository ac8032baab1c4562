"""The port's spec compiler (consensus_specs_tpu_torch/compiler) against the
JAX package's (consensus_specs_tpu/compiler): for phase0, altair and
bellatrix under the minimal and mainnet presets, the same public constants
with the same values, the same runtime config and the same rendered source
text; the port's `KEY: value` reader against PyYAML on every copied preset
and config file. Exact equality throughout."""
import types

import pytest
import yaml

from consensus_specs_tpu.compiler import spec_compiler as jcomp
from consensus_specs_tpu_torch.compiler import spec_compiler as tcomp

FORKS = ("phase0", "altair", "bellatrix")
PRESETS = ("minimal", "mainnet")


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
    assert public - {"kzg", "custody_crypto", "das_kernels"} <= set(vars(ours))
    assert ours.fork == fork and ours.preset_name == preset


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("fork", FORKS)
def test_render_spec_source_matches_jax(fork, preset):
    assert tcomp.render_spec_source(fork, preset) == jcomp.render_spec_source(fork, preset)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("fork", FORKS)
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


@pytest.mark.parametrize("fork", ("sharding", "das", "custody_game"))
def test_rd_forks_raise_naming_the_roadmap_item(fork):
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        tcomp.build_spec(fork, "minimal", device="cpu")


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
