"""Spec compiler of the port: markdown documents -> executable per-(fork x
preset) modules linked against the port's own runtime (copy of the JAX
package's compiler/spec_compiler.py).

Reference parity: the role of setup.py in the reference (get_spec
setup.py:163-259, combine_spec_objects :723-746, objects_to_spec :561-659,
load_preset/load_config :764-788) — markdown IS the spec source; fenced
```python blocks are executed in document order, `| NAME | value |` table rows
become constants, preset files override constants at build time, runtime
config becomes a frozen `config` object, and fork documents overlay earlier
forks newest-wins.

What differs from the JAX package's compiler:
- the markdown comes from the repo-root `specs/`; the preset and config
  files are the port's own copies (`presets/`, `configs/` beside this
  module), read by `read_key_values`, a `KEY: value` reader for the plain
  integers and quoted strings they hold (no YAML library);
- the namespace binds the port's `ssz`, the port's BLS shim,
  `hash_eth2` and the port's copies of the KZG shim (`kzg`), custody
  (`custody_crypto`) and DAS (`das_kernels`) modules, so all six forks
  compile;
- `accelerated_shuffle` runs `ops/shuffle.shuffled_index_map` on the
  device `build_spec` was given (K4 + K5 on "cuda", the plain versions on
  "cpu"); a failed launch raises, it never returns None to fall back to the
  scalar loop;
- `das_kernels` is crypto/das with its NTT functions bound to that device
  (K22 + K23 on "cuda", the plain versions on "cpu"), the same way.
"""
from __future__ import annotations

import inspect
import re
import types as pytypes
from functools import partial
from pathlib import Path

SPEC_DIR = Path(__file__).resolve().parents[2] / "specs"
PRESET_DIR = Path(__file__).resolve().parent / "presets"
CONFIG_DIR = Path(__file__).resolve().parent / "configs"

# Documents compiled per fork, in overlay order (phase0 first).
FORK_DOCS = {
    "phase0": [
        "phase0/beacon-chain.md",
        "phase0/fork-choice.md",
        "phase0/validator.md",
        "phase0/weak-subjectivity.md",
        "phase0/p2p-interface.md",
    ],
    "altair": [
        "altair/beacon-chain.md",
        "altair/bls.md",
        "altair/fork.md",
        "altair/sync-protocol.md",
        "altair/validator.md",
        # networking overlay last: MetaData v2 + the sync-subcommittee
        # helpers are spec functions (reference setup.py compiles
        # p2p-interface.md into the altair spec the same way)
        "altair/p2p-interface.md",
    ],
    "bellatrix": [
        "bellatrix/beacon-chain.md",
        "bellatrix/fork.md",
        "bellatrix/fork-choice.md",
        "bellatrix/validator.md",
    ],
    # R&D overlays. The reference specifies these but leaves them out of its
    # build matrix (setup.py:849-871 compiles only phase0/altair/bellatrix) and
    # runs custody_game tests pytest-only; here they compile like any fork so
    # the whole pipeline (containers, shard work ring, custody challenges) is
    # executable, while staying out of ALL_PHASES in the test context (the
    # same compiled-vs-default split the reference makes).
    "sharding": [
        "sharding/beacon-chain.md",
        "sharding/p2p-interface.md",
    ],
    # das overlays sharding (its sampling operates on sharding's blobs and
    # KZG commitments; reference das-core.md:90-186 carries 12 executable
    # functions which compile here like any other spec document).
    # sampling.md / fork-choice.md stay prose-only: the former has no code,
    # the latter's blocks reference BeaconState fields no compiled fork
    # defines (grandparent_epoch_confirmed_commitments — R&D sketch in the
    # reference too).
    "das": [
        "das/das-core.md",
        "das/p2p-interface.md",
    ],
    "custody_game": [
        "custody_game/beacon-chain.md",
        "custody_game/validator.md",
    ],
}
FORK_ORDER = ["phase0", "altair", "bellatrix", "sharding", "das", "custody_game"]
PREVIOUS_FORK = {
    "phase0": None,
    "altair": "phase0",
    "bellatrix": "altair",
    "sharding": "bellatrix",
    "das": "sharding",
    "custody_game": "das",
}

# Constant-table cell names. Single-letter rows (gossipsub tuning
# parameters like `D`) are protocol documentation, not spec constants —
# but ONLY in the p2p documents; everywhere else a single-letter ALL-CAPS
# name is a legitimate constant (parse_spec_markdown takes the flag).
_CONST_RE = re.compile(r"^[A-Z][A-Z0-9_]+$")
_CONST_RE_1CHAR = re.compile(r"^[A-Z][A-Z0-9_]*$")
_SKIP_DIRECTIVE = "<!-- spec: skip -->"


class SpecDoc:
    def __init__(self):
        self.python_blocks: list[str] = []
        self.constants: dict[str, object] = {}


def _parse_table_value(text: str):
    """Evaluate a constant-table value: ints, hex, 2**n arithmetic, strings."""
    text = text.strip().strip("`")
    try:
        return eval(text, {"__builtins__": {}}, {})  # noqa: S307 - trusted spec source
    except Exception:
        return None


def parse_spec_markdown(text: str, allow_single_letter_constants: bool = False) -> SpecDoc:
    # Strict (two+ chars) by default so legacy callers (tools/typegate.py)
    # see exactly the constant set build_spec compiles; build_spec opts
    # non-p2p documents into single-letter names.
    const_re = _CONST_RE_1CHAR if allow_single_letter_constants else _CONST_RE
    doc = SpecDoc()
    lines = text.split("\n")
    i = 0
    skip_next_block = False
    while i < len(lines):
        line = lines[i]
        if line.strip() == _SKIP_DIRECTIVE:
            skip_next_block = True
            i += 1
            continue
        if line.startswith("```python"):
            block: list[str] = []
            i += 1
            while i < len(lines) and not lines[i].startswith("```"):
                block.append(lines[i])
                i += 1
            if not skip_next_block:
                doc.python_blocks.append("\n".join(block))
            skip_next_block = False
            i += 1
            continue
        if line.startswith("```"):
            # non-python fence: skip to closing fence
            i += 1
            while i < len(lines) and not lines[i].startswith("```"):
                i += 1
            i += 1
            continue
        if line.lstrip().startswith("|"):
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) >= 2 and const_re.match(cells[0]):
                value = _parse_table_value(cells[1])
                if value is not None:
                    doc.constants[cells[0]] = value
        i += 1
    return doc


class Config:
    """Frozen runtime configuration (reference: the generated `config`
    NamedTuple, setup.py:600-620)."""

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", dict(kwargs))
        for k, v in kwargs.items():
            object.__setattr__(self, k, v)

    def __setattr__(self, k, v):
        raise AttributeError("config is immutable; use build_spec(config_overrides=...)")

    def replace(self, **overrides) -> "Config":
        merged = dict(self._values)
        merged.update(overrides)
        return Config(**merged)

    def keys(self):
        return self._values.keys()

    def __repr__(self):
        return f"Config({self._values!r})"


def _parse_scalar(text: str):
    """A preset or config value: a decimal integer or a quoted string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if re.fullmatch(r"-?[0-9]+", text):
        return int(text)
    raise ValueError(f"unsupported preset/config value {text!r}")


def read_key_values(path: Path) -> dict:
    """`KEY: value` lines (comments and blank lines skipped) -> {KEY: value},
    values as `_parse_scalar` reads them, in file order."""
    out: dict = {}
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.split(" #", 1)[0].strip()
        if not line or line.startswith("#"):
            continue
        key, sep, value = line.partition(":")
        if not sep or not re.fullmatch(r"[A-Z][A-Z0-9_]*", key.strip()):
            raise ValueError(f"{path.name}:{lineno}: not a KEY: value line: {raw!r}")
        out[key.strip()] = _parse_scalar(value.strip())
    return out


def load_preset(preset_name: str, forks: list[str]) -> dict:
    out: dict = {}
    for fork in forks:
        path = PRESET_DIR / preset_name / f"{fork}.yaml"
        if path.exists():
            out.update(read_key_values(path))
    return out


def load_config(config_name: str) -> dict:
    raw = read_key_values(CONFIG_DIR / f"{config_name}.yaml")
    out = {}
    for k, v in raw.items():
        if isinstance(v, str) and v.startswith("0x"):
            out[k] = bytes.fromhex(v[2:])
        else:
            out[k] = v
    return out


def _runtime_namespace(device) -> dict:
    """Seed namespace: the runtime the compiled spec modules link against
    (the analog of the reference's builder imports, setup.py:323-360)."""
    import copy as _pycopy
    from dataclasses import dataclass, field
    from typing import Any, Callable, Dict, List as PyList, Optional, Sequence, Set, Tuple

    from .. import ssz
    from ..crypto import bls, kzg_shim
    from ..crypto import custody as custody_crypto
    from ..utils.hash import hash_eth2

    ns: dict = {
        # ssz type zoo
        "Container": ssz.Container, "List": ssz.List, "Vector": ssz.Vector,
        "Bitlist": ssz.Bitlist, "Bitvector": ssz.Bitvector,
        "ByteList": ssz.ByteList, "ByteVector": ssz.ByteVector,
        "Bytes1": ssz.Bytes1, "Bytes4": ssz.Bytes4, "Bytes8": ssz.Bytes8,
        "Bytes20": ssz.Bytes20, "Bytes32": ssz.Bytes32, "Bytes48": ssz.Bytes48,
        "Bytes96": ssz.Bytes96, "boolean": ssz.boolean, "byte": ssz.byte,
        "uint8": ssz.uint8, "uint16": ssz.uint16, "uint32": ssz.uint32,
        "uint64": ssz.uint64, "uint128": ssz.uint128, "uint256": ssz.uint256,
        "Union": ssz.Union,
        # ssz ops
        "serialize": ssz.serialize, "hash_tree_root": ssz.hash_tree_root,
        "uint_to_bytes": ssz.uint_to_bytes, "copy": ssz.copy,
        "is_valid_merkle_branch_impl": ssz.is_valid_merkle_branch,
        "get_generalized_index": ssz.get_generalized_index,
        "build_proof": ssz.build_proof,
        "calc_merkle_tree_from_leaves": ssz.calc_merkle_tree_from_leaves,
        "get_merkle_proof": ssz.get_merkle_proof,
        # crypto
        "bls": bls, "hash": hash_eth2, "kzg": kzg_shim,
        "custody_crypto": custody_crypto, "das_kernels": make_das_kernels(device),
        # python runtime
        "dataclass": dataclass, "field": field, "deepcopy": _pycopy.deepcopy,
        "Any": Any, "Callable": Callable, "Dict": Dict, "Optional": Optional,
        "PyList": PyList, "Sequence": Sequence, "Set": Set, "Tuple": Tuple,
        "ceillog2": lambda x: (int(x) - 1).bit_length(),
        "floorlog2": lambda x: int(x).bit_length() - 1,
        "accelerated_shuffle": make_accelerated_shuffle(device),
    }
    return ns


def make_accelerated_shuffle(device):
    """The spec's `accelerated_shuffle(seed, index_count, rounds)` hook
    (specs/phase0/beacon-chain.md `_get_shuffled_index_map`): the whole
    registry's shuffled index map as a list of ints, from one
    `shuffled_index_map` call on `device` (K4 + K5 on "cuda", the plain
    versions on "cpu"). Errors propagate."""
    from ..ops.shuffle import seed_words_tensor, shuffled_index_map
    from ..utils.device import resolve_device

    dev = resolve_device(device)

    def accelerated_shuffle(seed: bytes, index_count: int, rounds: int):
        if index_count == 0:
            return []
        return shuffled_index_map(int(index_count), seed_words_tensor(bytes(seed), dev),
                                  int(rounds)).tolist()

    return accelerated_shuffle


def make_das_kernels(device) -> pytypes.SimpleNamespace:
    """The spec's `das_kernels` (specs/das/das-core.md: `ifft`,
    `das_fft_extension`, `recover_data`, `verify_sample`): every public
    name of crypto/das, the functions that take `device` bound to `device`
    (K22 + K23 on "cuda", the plain versions on "cpu"). Errors propagate."""
    from ..crypto import das
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    names = {}
    for name in dir(das):
        obj = getattr(das, name)
        if name.startswith("_") or isinstance(obj, pytypes.ModuleType):
            continue
        if inspect.isfunction(obj) and "device" in inspect.signature(obj).parameters:
            obj = partial(obj, device=dev)
        names[name] = obj
    return pytypes.SimpleNamespace(**names)


_SPEC_CACHE: dict = {}


def _check_fork(fork: str) -> None:
    if fork not in FORK_ORDER:
        raise ValueError(f"unknown fork {fork!r} (choose from {FORK_ORDER})")


def build_spec(fork: str, preset_name: str, config_overrides: dict | None = None,
               device="cuda") -> pytypes.ModuleType:
    """Compile the spec for (fork, preset) into a fresh module object whose
    `accelerated_shuffle` and `das_kernels` run on `device` ("cuda" by
    default; raises without a card unless the caller passes "cpu")."""
    _check_fork(fork)
    forks = FORK_ORDER[: FORK_ORDER.index(fork) + 1]
    ns = _runtime_namespace(device)

    docs: list[SpecDoc] = []
    all_constants: dict = {}
    for f in forks:
        for doc_path in FORK_DOCS[f]:
            full = SPEC_DIR / doc_path
            if not full.exists():
                continue
            doc = parse_spec_markdown(
                full.read_text(), allow_single_letter_constants="p2p" not in doc_path
            )
            docs.append(doc)
            all_constants.update(doc.constants)

    # preset overrides markdown-table defaults
    all_constants.update(load_preset(preset_name, forks))
    ns.update(all_constants)

    config_values = load_config(preset_name)
    if config_overrides:
        config_values.update(config_overrides)
    ns["config"] = Config(**config_values)

    module = pytypes.ModuleType(f"consensus_specs_tpu_torch.specs.{fork}.{preset_name}")
    module.__dict__.update(ns)
    module.__dict__["fork"] = fork
    module.__dict__["preset_name"] = preset_name
    for doc in docs:
        for block in doc.python_blocks:
            # dont_inherit: this file's `from __future__ import annotations`
            # must not leak into spec code (classes need real type objects).
            exec(compile(block, module.__name__, "exec", flags=0, dont_inherit=True), module.__dict__)  # noqa: S102
    return module


def render_spec_source(fork: str, preset_name: str) -> str:
    """Flatten the (fork x preset) spec into one deterministic Python source.

    The reference's `make pyspec` materializes eth2spec modules on disk
    (setup.py objects_to_spec:561-659); build_spec here execs markdown
    in-memory instead. This renders the same composition — resolved
    constants, frozen runtime config, then every executable block in
    document order — as reviewable source. Determinism contract: output
    depends only on the spec documents + preset/config yaml (constants
    sorted, no timestamps), so two consecutive emissions are byte-identical
    and CI can diff artifacts across commits.

    The artifact documents the composition; executing it requires the
    runtime namespace `build_spec` seeds (ssz, bls, hash, ...) — the
    preamble records that contract.
    """
    _check_fork(fork)
    forks = FORK_ORDER[: FORK_ORDER.index(fork) + 1]
    all_constants: dict = {}
    sections: list[tuple[str, list[str]]] = []
    for f in forks:
        for doc_path in FORK_DOCS[f]:
            full = SPEC_DIR / doc_path
            if not full.exists():
                continue
            doc = parse_spec_markdown(
                full.read_text(), allow_single_letter_constants="p2p" not in doc_path
            )
            all_constants.update(doc.constants)
            if doc.python_blocks:
                sections.append((doc_path, doc.python_blocks))
    all_constants.update(load_preset(preset_name, forks))
    config_values = load_config(preset_name)

    out: list[str] = [
        f'"""Flattened spec artifact: fork={fork!r} preset={preset_name!r}.',
        "",
        "Generated by `make pyspec ARTIFACTS=1`",
        "(consensus_specs_tpu.compiler.spec_compiler.render_spec_source).",
        "Executable blocks are verbatim from the markdown documents listed",
        "below and link against the names build_spec seeds (_runtime_namespace):",
        "ssz types/ops, bls, hash, kzg, dataclass, ... Do not edit by hand.",
        '"""',
        "",
        f"fork = {fork!r}",
        f"preset_name = {preset_name!r}",
        "",
        "# --- constants (markdown tables, preset-overridden) ---",
    ]
    for name in sorted(all_constants):
        out.append(f"{name} = {all_constants[name]!r}")
    out += ["", "# --- runtime config (frozen at build time) ---",
            "config = Config(**{"]
    for name in sorted(config_values):
        out.append(f"    {name!r}: {config_values[name]!r},")
    out.append("})")
    for doc_path, blocks in sections:
        out += ["", "", f"# === {doc_path} ==="]
        for block in blocks:
            out += ["", block.rstrip()]
    return "\n".join(out) + "\n"


def get_spec(fork: str, preset_name: str, device="cuda") -> pytypes.ModuleType:
    """`build_spec` memoized on (fork, preset, device)."""
    key = (fork, preset_name, str(device))
    if key not in _SPEC_CACHE:
        _SPEC_CACHE[key] = build_spec(fork, preset_name, device=device)
    return _SPEC_CACHE[key]
