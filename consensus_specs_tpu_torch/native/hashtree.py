"""The batched host SHA-256 pair hasher: ctypes over hashtree.cpp (a copy of
the JAX package's native/hashtree.cpp, SHA-NI where the CPU has it,
portable rounds elsewhere, threads for large batches).

The library is built with `g++` at first use into `build/native/` at the
root of the checkout (gitignored), named by a hash of the source and flags,
as `kernels/build.py` names the CUDA libraries; nothing is built when this
module is imported. A failed build raises: the SSZ layer has no slower
hasher to fall back to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "hashtree.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-pthread", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"hashtree-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"native/hashtree.cpp did not build (g++ rc "
                                   f"{res.returncode}):\n{res.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.hashtree_hash_pairs.restype = None
        lib.hashtree_hash_pairs.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        lib.hashtree_build_tree.restype = ctypes.c_long
        lib.hashtree_build_tree.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        _lib = lib
    return _lib


def hash_pairs(level: bytes) -> bytes:
    """One Merkle level: concatenated sibling pairs (k*64 bytes) -> parents
    (k*32 bytes), one native call."""
    if len(level) % 64:
        raise ValueError(f"hash_pairs: {len(level)} bytes is not a whole number of pairs")
    n = len(level) // 64
    if n == 0:
        return b""
    out = ctypes.create_string_buffer(32 * n)
    _load().hashtree_hash_pairs(level, n, out)
    return out.raw


def build_tree_levels(leaves: bytes) -> list[bytearray] | None:
    """All parent levels of the chunk tree over `leaves` (n*32 bytes) in one
    native call: level 1 (ceil(n/2) nodes) through the single top node, odd
    levels padded with the zero hash of their height. None for n < 2 (no
    parent level)."""
    if len(leaves) % 32:
        raise ValueError("build_tree_levels: leaves must be 32-byte chunks")
    n = len(leaves) // 32
    if n < 2:
        return None
    sizes = []
    c = n
    while c > 1:
        c = (c + 1) // 2
        sizes.append(c)
    total = sum(sizes)
    out = ctypes.create_string_buffer(32 * total)
    written = _load().hashtree_build_tree(leaves, n, out)
    if written != total:
        raise RuntimeError(f"hashtree_build_tree wrote {written} nodes, expected {total}")
    levels = []
    view = memoryview(out)[: 32 * total]
    off = 0
    for s in sizes:
        levels.append(bytearray(view[off: off + 32 * s]))
        off += 32 * s
    return levels
