"""Build and load the port's CUDA kernels (nvcc into shared libraries with a
plain C interface, loaded with ctypes).

Each `csrc/<name>.cu` becomes `build/torch_kernels/<name>-<hash>.so` at the
root of the checkout, where <hash> covers the source, the headers it can
include and the flags, so an edited source builds anew and a stale library
is never loaded. `build_all()` starts one nvcc per source, all at once, and
waits for them; `library(name)` builds what is missing and loads it. Nothing
is built or loaded when this module is imported: the CPU tests import every
module and have no nvcc.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises on a nonzero code, so a refused launch never passes
quietly. Every pointer and the stream are `ctypes.c_void_p` (the stream
given as an integer, `stream_ptr`).

A source that does not build (or no nvcc), a library that does not load and
a launch that returns an error all raise `KernelError`, marked
`retryable = False`: the scheduler's retry and breaker (robustness/retry.py)
then fail the flush instead of degrading it to the host, so no fallback
hides a broken kernel. Every OSError of building or loading (a build
directory that cannot be made, an nvcc that cannot run, a failed
`ctypes.CDLL`) becomes a KernelError too: the retry policy would otherwise
class an OSError as a device failure.

`LAUNCHES` counts kernel launches per kernel name (K9-K12's RNS instances
apart, as `<name>_rns`): each wrapper adds one where it launches its
kernel, so a run can show that its path went through the kernels
(`reset_launches()` before, read after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("sha256", "state_root", "epoch", "shuffle", "incremental_root", "fp", "rlc",
           "pairing", "msm", "forkchoice", "tree_root", "multiproof", "ntt", "fp_rns")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {"sha256_64b": 0, "validator_roots": 0, "epoch_sweep": 0,
                            "sha256_1block": 0, "shuffle_rounds": 0, "dirty_scan": 0,
                            "path_fold": 0, "fp_ops": 0, "rlc_ladders": 0, "point_sums": 0,
                            "miller_loop": 0, "final_exp": 0, "g1_msm": 0, "g1_subgroup": 0,
                            "fc_ancestors": 0, "fc_vote_weights": 0, "fc_subtree": 0,
                            "fc_head_walk": 0, "tree_root_batch": 0, "multiproof_heap": 0,
                            "multiproof_siblings": 0, "fr_ntt": 0, "fr_ops": 0, "rns_ops": 0,
                            "epoch_combine": 0, "f12_product": 0, "rlc_ladders_rns": 0,
                            "point_sums_rns": 0, "miller_loop_rns": 0, "final_exp_rns": 0}


class KernelError(RuntimeError):
    """A kernel that does not build, load or launch. Never retried and
    never degraded to a host path (robustness/retry.is_retryable reads the
    mark first)."""

    retryable = False


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels build only on a "
                          "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # every header a source may include
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Build every missing library, one nvcc process per source, all started
    together. Returns {name: ptxas report} for the sources built now."""
    procs = {}
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            reports[name] = text
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{text}")
            else:
                os.replace(tmp, out)
    except OSError as exc:
        raise KernelError(f"kernel build failed: {exc!r}") from exc
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return reports


@lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    try:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        return ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelError(f"cannot build or load the {name} kernels: {exc!r}") from exc


@lru_cache(maxsize=None)
def entry(name: str, fn: str, n_ptrs: int, n_ints: int = 0):
    """C entry point `fn` of csrc/<name>.cu, declared with the calling
    convention every entry point here follows: n_ptrs pointers, then the
    element count and n_ints further integers as long long, then the
    stream; returns cudaError_t."""
    try:
        f = getattr(library(name), fn)
    except AttributeError as exc:
        raise KernelError(f"{name}.cu has no entry point {fn}") from exc
    f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong] * (1 + n_ints)
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as an integer pointer:
    torch's raw getter, where `torch.cuda.current_stream` builds a Stream
    object (several us of host time a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
