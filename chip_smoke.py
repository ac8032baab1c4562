#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the epoch path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):
1. report the card (nvidia-smi name and power limit) and the CUDA version;
2. build the three kernels from consensus_specs_tpu_torch/csrc with nvcc
   (one process per source, started together);
3. hold each kernel bit-equal to its plain PyTorch version on the card:
   K1 sha256_64b on 2**16 seeded messages (plus 8 rows against hashlib),
   K2 validator_roots at N = 2**16, K3 epoch_sweep on a synthetic
   altair-mainnet state at N = 2**16 and on a crafted one with ejections
   beyond churn and an activation queue beyond churn;
4. the main path: a synthetic altair-mainnet registry of N = 2**20
   validators on the card, one warm-up epoch, 8 resident epochs timed with
   CUDA events, then `field_roots`. Launch counts are zeroed just before and
   read just after. The state after one and after nine epochs and the 14
   roots must equal the plain path's on the card, and the historical batch
   root (epoch 256 falls inside the run) a hashlib fold of the same vectors;
5. time each kernel beside its plain version at the main path's shapes,
   and give its least time: operations from the instructions counted in
   its SASS, bytes from what this run's data needs.

The last three lines are the card, one JSON object with a row per kernel,
and the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np

N_CHECK = 1 << 16
N_MAIN = 1 << 20
TIMED_EPOCHS = 8

# Least-time model (H100 SXM, the NVIDIA data sheet's peaks). Bytes: 3.35
# TB/s of HBM. Operations: every instruction, integer ones included, issues
# from one of 4 schedulers per SM, one warp (32 lanes) each per clock, so
# no instruction mix runs faster than 132 SMs x 128 lanes x 1.98 GHz (the
# data sheet's 67 TFLOP/s of float32 is this rate times 2 FLOP per FMA).
# The instructions per message or validator are counted in the built
# kernel's SASS (`sass_instructions`); K1 and K2 are straight-line code, so
# each thread executes every instruction of its kernel once.
HBM_BYTES_PER_S = 3.35e12
LANE_INSTR_PER_S = 132 * 128 * 1.98e9


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def state_err(a, b) -> float:
    """Largest absolute difference over every field of two EpochStates."""
    return max(max_abs_err(t, getattr(b, name)) for name, t in a.items())


def sass_instructions(name: str, kernel: str) -> int:
    """Instructions one thread executes in `kernel` of csrc/<name>.cu: the
    SASS of the built library up to its last EXIT, NOPs left out. Raises
    if the kernel branches anywhere but to that EXIT, since the count then
    would not be the executed count."""
    import re
    import shutil

    from consensus_specs_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    sections = [sec for sec in sass.split("Function : ")[1:]
                if kernel in sec.split(None, 1)[0]]
    require(len(sections) == 1, f"SASS of {kernel} not found in {name}")
    ops = [m.group(1).strip() for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", sections[0])]
    ops = [re.sub(r"^@!?U?P[T0-9]+\s+", "", op) for op in ops]
    last = max(i for i, op in enumerate(ops) if op.startswith("EXIT"))
    body = [op for op in ops[:last + 1] if not op.startswith("NOP")]
    branches = [op for op in body if op.split(None, 1)[0].startswith(("BRA", "BRX", "JMP", "CALL"))]
    require(not branches, f"{kernel} is not straight-line code: {branches[:4]}")
    mix = Counter(op.split(None, 1)[0].split(".")[0] for op in body).most_common(8)
    print(f"sass {kernel}: {len(body)} instructions a thread; most used {mix}")
    return len(body)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from consensus_specs_tpu_torch.engine import epoch as tepoch
    from consensus_specs_tpu_torch.engine import state_root as troot
    from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy
    from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop
    from consensus_specs_tpu_torch.engine.state import EpochConfig
    from consensus_specs_tpu_torch.engine.synthetic import (
        edge_epoch_state_numpy,
        synthetic_epoch_state,
    )
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import sha256 as tsha
    from consensus_specs_tpu_torch.ops.sha256_host import merkle_root_hashlib, words_to_bytes

    dev = torch.device("cuda")
    # 1. the card
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; cuda {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = EpochConfig.altair_mainnet()
    rng = np.random.default_rng(0)
    err = {"sha256_64b": 0.0, "validator_roots": 0.0, "epoch_sweep": 0.0}

    # 3. kernels against their plain versions
    w = rng.integers(0, 2**32, (N_CHECK, 16), dtype=np.uint64).astype(np.uint32)
    w[:4] = 0
    w[4:8] = 0xFFFFFFFF
    w_dev = torch.from_numpy(w.view(np.int32)).to(dev)
    got = tsha.sha256_64B_words(w_dev)
    plain = tsha.sha256_64B_words_plain(w_dev)
    torch.cuda.synchronize()
    err["sha256_64b"] = max_abs_err(got, plain)
    require(torch.equal(got, plain), "K1 sha256_64b differs from its plain version")
    for i in range(8):
        require(words_to_bytes(got[i].cpu().numpy())
                == hashlib.sha256(words_to_bytes(w[i])).digest(), f"K1 row {i} != hashlib")
    print(f"check K1 sha256_64b: {N_CHECK} messages bit-equal, 8 rows = hashlib")

    st = synthetic_epoch_state(cfg, N_CHECK, seed=1, device=dev)
    s01 = torch.from_numpy(rng.integers(0, 2**32, (N_CHECK, 16), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(dev)
    got = troot.validator_roots(s01, st)
    plain = troot.validator_roots_plain(s01, st)
    err["validator_roots"] = max_abs_err(got, plain)
    require(torch.equal(got, plain), "K2 validator_roots differs from its plain version")
    print(f"check K2 validator_roots: N={N_CHECK} bit-equal")

    epoch_fn = tepoch.make_epoch_fn(cfg)
    for label, state in (("synthetic", st),
                         ("ejections_and_queue", epoch_state_from_numpy(
                             edge_epoch_state_numpy(cfg, "ejections_and_queue", N_CHECK, 2), dev))):
        ref, ref_aux = tepoch.process_epoch_plain(cfg, state)
        pre_exit = state.exit_epoch.clone()
        out, aux = epoch_fn(state)
        torch.cuda.synchronize()
        err["epoch_sweep"] = max(err["epoch_sweep"], state_err(out, ref),
                                 max_abs_err(aux.flat(), ref_aux.flat()))
        bad = [name for name, t in out.items() if not torch.equal(t, getattr(ref, name))]
        require(not bad, f"K3 epoch_sweep ({label}) differs on {bad}")
        require(torch.equal(aux.flat(), ref_aux.flat()), f"K3 aux ({label}) differs")
        ejected = int(((pre_exit == -1) & (out.exit_epoch != -1)).sum())
        print(f"check K3 epoch_sweep ({label}): N={N_CHECK} all fields and aux bit-equal; "
              f"{ejected} ejected")
    del st, s01, got, plain, ref, out

    # 4. the main path at N = 2**20
    state = synthetic_epoch_state(cfg, N_MAIN, seed=0, epoch=250, device=dev)
    static01 = torch.from_numpy(rng.integers(0, 2**32, (N_MAIN, 16), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)
    ref = state.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    loop = ResidentEpochLoop(cfg, state, device=dev)
    loop.step_epoch()  # warm-up
    loop.flush()
    after_one = loop.state.clone()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    wall0 = time.perf_counter()
    ev[0].record()
    loop.run_epochs(TIMED_EPOCHS)
    ev[1].record()
    ev[1].synchronize()
    wall_epochs = time.perf_counter() - wall0
    ev[2].record()
    roots = loop.field_roots(static01)
    ev[3].record()
    ev[3].synchronize()
    launches = dict(build.LAUNCHES)
    epoch_ms = ev[0].elapsed_time(ev[1]) / TIMED_EPOCHS
    roots_ms = ev[2].elapsed_time(ev[3])
    peak = torch.cuda.max_memory_allocated()
    loop.flush()
    print(f"main path: N={N_MAIN} epoch_ms={epoch_ms:.4f} (host wall "
          f"{1e3 * wall_epochs / TIMED_EPOCHS:.4f}) field_roots_ms={roots_ms:.4f} "
          f"launches={launches} max_memory_allocated={peak}")
    for name, count in launches.items():
        require(count > 0, f"the main path never launched {name}")

    # the plain path on the card, from the same initial state
    plain_step = tepoch.process_epoch_plain
    for i in range(1 + TIMED_EPOCHS):
        new, _ = plain_step(cfg, ref)
        ref = new
        ref.slot.add_(cfg.slots_per_epoch)
        if i == 0:
            bad = [k for k, t in after_one.items() if not torch.equal(t, getattr(ref, k))]
            require(not bad, f"state after one epoch differs from the plain path on {bad}")
    bad = [k for k, t in loop.state.items() if not torch.equal(t, getattr(ref, k))]
    require(not bad, f"state after {1 + TIMED_EPOCHS} epochs differs from the plain path on {bad}")
    plain_roots = troot.field_roots_plain(ref, static01)
    bad = [k for k in troot.DEVICE_FIELDS if not torch.equal(roots[k], plain_roots[k])]
    require(len(roots) == 14 and not bad, f"field roots differ from the plain path on {bad}")
    require(len(loop.historical_roots) == 1 and loop.sync_committee_updates == 1,
            "epoch 256 must fire one historical append and one sync rotation")
    hist = merkle_root_hashlib([words_to_bytes(r) for r in ref.block_roots.cpu().numpy()])
    hist += merkle_root_hashlib([words_to_bytes(r) for r in ref.state_roots.cpu().numpy()])
    require(words_to_bytes(loop.historical_roots[0].cpu().numpy())
            == hashlib.sha256(hist).digest(), "historical batch root != hashlib fold")
    print("main path check: state after 1 and 9 epochs, 14 field roots = plain path; "
          "historical batch root = hashlib")
    del ref, after_one, plain_roots

    # 5. kernels beside their plain versions at the main path's shapes
    m = N_MAIN // 2  # the largest K1 launch: the first level of the registry tree
    level = torch.from_numpy(rng.integers(0, 2**32, (m, 16), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
    sass = {"sha256_64b": sass_instructions("sha256", "sha256_64b_kernel"),
            "validator_roots": sass_instructions("state_root", "validator_roots_kernel")}
    # K3 moves what this epoch's data needs: every registry column, the
    # slashings vector, two block-root rows, one randao row and the
    # checkpoints read once; only the elements the epoch changes written.
    pre = loop.state.clone()
    st = pre.clone()
    tepoch.epoch_sweep(cfg, st)
    torch.cuda.synchronize()
    k3_read = (sum(t.numel() * t.element_size() for _, t in pre.items() if t.shape == (N_MAIN,))
               + pre.slashings.numel() * 8 + 2 * 32 + 32 + 3 * (8 + 32) + 4 + 8)
    k3_written = sum(int((getattr(st, k) != t).sum()) * t.element_size() for k, t in pre.items())
    print(f"K3 bytes at N={N_MAIN}: {k3_read} read, {k3_written} written "
          f"({(k3_read + k3_written) / N_MAIN:.2f} a validator)")
    del st
    fresh = [pre.clone() for _ in range(11)]  # K3 works in place: one copy a call

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / LANE_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")

    rows = [
        dict(name="sha256_64b", source="consensus_specs_tpu_torch/csrc/sha256.cu",
             replaces="consensus_specs_tpu/ops/sha256_jax.py:84",
             ms=time_ms(lambda: tsha.sha256_64B_words(level), 20),
             plain_ms=time_ms(lambda: tsha.sha256_64B_words_plain(level), 2),
             **bound(sass["sha256_64b"] * m, 96 * m)),
        dict(name="validator_roots", source="consensus_specs_tpu_torch/csrc/state_root.cu",
             replaces="consensus_specs_tpu/engine/state_root.py:186",
             ms=time_ms(lambda: troot.validator_roots(static01, pre), 10),
             plain_ms=time_ms(lambda: troot.validator_roots_plain(static01, pre), 1),
             **bound(sass["validator_roots"] * N_MAIN, 137 * N_MAIN)),
        # the operations of K3 are not counted (its loops branch on the data)
        dict(name="epoch_sweep", source="consensus_specs_tpu_torch/csrc/epoch.cu",
             replaces="consensus_specs_tpu/engine/epoch.py:85",
             ms=time_ms(lambda: tepoch.epoch_sweep(cfg, fresh.pop()), 10),
             plain_ms=time_ms(lambda: tepoch.process_epoch_plain(cfg, pre), 2),
             **bound(0, k3_read + k3_written)),
    ]
    for row in rows:
        row.update(route="cuda", launches=launches[row["name"]],
                   max_abs_err=err[row["name"]], bit_equal=err[row["name"]] == 0.0,
                   library_ms=None)
    card = card_line()
    print(card)
    print(json.dumps({"kernels": rows, "main_path": {
        "n": N_MAIN, "epoch_ms": epoch_ms, "field_roots_ms": roots_ms,
        "max_memory_allocated": peak}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
