#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the epoch path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):
1. report the card (nvidia-smi name and power limit) and the CUDA version;
2. build the kernels from consensus_specs_tpu_torch/csrc with nvcc (one
   process per source, started together);
3. hold each kernel bit-equal to its plain PyTorch version on the card:
   K1 sha256_64b on 2**16 seeded messages (plus 8 rows against hashlib),
   K2 validator_roots at N = 2**16, K3 epoch_sweep on a synthetic
   altair-mainnet state at N = 2**16 and on a crafted one with ejections
   beyond churn and an activation queue beyond churn, K4 sha256_1block on
   2**16 messages (plus 8 padded messages against hashlib), K5
   shuffle_rounds at n = 65,537 and 90 rounds (also against the hashlib
   twin), K6 dirty_scan and K7 path_fold on a state with crafted dirty
   rows (a case under the 1024-row budget, one over it that takes the
   full rebuild, and the record_state_root / record_block_root path);
4. the main path: a synthetic altair-mainnet registry of N = 2**20
   validators on the card, the resident Merkle cache built, one warm-up
   epoch and a refresh, 8 resident epochs timed with CUDA events (epoch 256
   rotates the sync committee inside them), then `field_roots`, one
   `device_roots()` for the 8 owed epochs, and single epochs each followed
   by a timed `device_roots()`. Launch counts are zeroed just before and
   read just after; the comparisons below are not counted. At every
   refresh the 14 cached roots must equal `field_roots` and the plain
   path's; the state after one and after nine epochs must equal the plain
   path's on the card, the historical batch root a hashlib fold of the
   same vectors, and the rotation's 512 indices the plain sampler's on the
   same columns. Both refresh branches (K7 and the full rebuild) must run;
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
SINGLE_EPOCHS = 4  # single epochs, each followed by a timed device_roots()
N_SHUFFLE_CHECK = 65_537

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


def _sass_ops(name: str, kernel: str) -> list:
    """[(address, instruction)] of `kernel` in the built library of
    csrc/<name>.cu (`cuobjdump -sass`), predicates kept."""
    import re
    import shutil

    from consensus_specs_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    sections = [sec for sec in sass.split("Function : ")[1:]
                if kernel in sec.split(None, 1)[0]]
    require(len(sections) == 1, f"SASS of {kernel} not found in {name}")
    return [(int(m.group(1), 16), m.group(2).strip())
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sections[0])]


def _opcode_mix(ops: list, top: int) -> list:
    import re

    return Counter(re.sub(r"^@!?U?P[T0-9]+\s+", "", op).split(None, 1)[0].split(".")[0]
                   for op in ops).most_common(top)


def sass_instructions(name: str, kernel: str) -> int:
    """Instructions one thread executes in `kernel` of csrc/<name>.cu: the
    SASS of the built library up to its last EXIT, NOPs left out. Raises
    if the kernel branches anywhere but to that EXIT, since the count then
    would not be the executed count."""
    import re

    ops = [re.sub(r"^@!?U?P[T0-9]+\s+", "", op) for _, op in _sass_ops(name, kernel)]
    last = max(i for i, op in enumerate(ops) if op.startswith("EXIT"))
    body = [op for op in ops[:last + 1] if not op.startswith("NOP")]
    branches = [op for op in body if op.split(None, 1)[0].startswith(("BRA", "BRX", "JMP", "CALL"))]
    require(not branches, f"{kernel} is not straight-line code: {branches[:4]}")
    print(f"sass {kernel}: {len(body)} instructions a thread; most used {_opcode_mix(body, 8)}")
    return len(body)


def sass_loop_instructions(name: str, kernel: str) -> int:
    """Instructions in the body of the longest loop of `kernel`, from the
    target of its backward branch to the branch, NOPs left out: what one
    trip of that loop executes (the loop must not be unrolled)."""
    import re

    ops = _sass_ops(name, kernel)
    loops = []
    for addr, op in ops:
        m = re.search(r"\bBRA\s+`?\(?(0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) <= addr:
            first = int(m.group(1), 16)
            loops.append([o for a, o in ops if first <= a <= addr and not o.startswith("NOP")])
    require(loops, f"{kernel}: no backward branch in its SASS")
    body = max(loops, key=len)
    print(f"sass {kernel}: longest loop body {len(body)} instructions; "
          f"most used {_opcode_mix(body, 6)}")
    return len(body)


def rand_words(rng, shape, dev):
    """Seeded random uint32 words as an int32 tensor on dev."""
    import torch

    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)


def one_block(msg: bytes) -> np.ndarray:
    """(16,) uint32 words of the one-block sha256 padding of msg (< 56 B)."""
    block = msg + b"\x80" + b"\x00" * (55 - len(msg)) + (8 * len(msg)).to_bytes(8, "big")
    return np.frombuffer(block, dtype=">u4").astype(np.uint32)


class Aside:
    """Work beside the main path (comparisons, timings): its launches do not
    count, and its memory stays out of the main path's peak, which is the
    largest `max_memory_allocated()` read on entering an Aside block (the
    peak is reset on leaving it)."""

    peak = 0

    def __enter__(self):
        import torch

        from consensus_specs_tpu_torch.kernels import build

        Aside.peak = max(Aside.peak, torch.cuda.max_memory_allocated())
        self.saved = dict(build.LAUNCHES)

    def __exit__(self, *exc):
        import torch

        from consensus_specs_tpu_torch.kernels import build

        build.LAUNCHES.update(self.saved)
        torch.cuda.reset_peak_memory_stats()
        return False


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from consensus_specs_tpu_torch.engine import epoch as tepoch
    from consensus_specs_tpu_torch.engine import incremental_root as tinc
    from consensus_specs_tpu_torch.engine import state_root as troot
    from consensus_specs_tpu_torch.engine import sync_committee as tsync
    from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy
    from consensus_specs_tpu_torch.engine.resident import ResidentEpochLoop
    from consensus_specs_tpu_torch.engine.state import EpochConfig
    from consensus_specs_tpu_torch.engine.synthetic import (
        edge_epoch_state_numpy,
        synthetic_epoch_state,
    )
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import sha256 as tsha
    from consensus_specs_tpu_torch.ops import shuffle as tshuffle
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
    err = {name: 0.0 for name in build.LAUNCHES}

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

    msgs = [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for size in (0, 1, 33, 37, 40,
                                                                               44, 54, 55)]
    w[:8] = np.stack([one_block(m) for m in msgs])
    w_dev = torch.from_numpy(w.view(np.int32)).to(dev)
    got = tsha.sha256_1block(w_dev)
    plain = tsha.sha256_1block_plain(w_dev)
    torch.cuda.synchronize()
    err["sha256_1block"] = max_abs_err(got, plain)
    require(torch.equal(got, plain), "K4 sha256_1block differs from its plain version")
    for i, m in enumerate(msgs):
        require(words_to_bytes(got[i].cpu().numpy()) == hashlib.sha256(m).digest(),
                f"K4 row {i} != hashlib")
    print(f"check K4 sha256_1block: {N_CHECK} messages bit-equal, 8 padded messages = hashlib")

    st = synthetic_epoch_state(cfg, N_CHECK, seed=1, device=dev)
    s01 = rand_words(rng, (N_CHECK, 16), dev)
    got = troot.validator_roots(s01, st)
    plain = troot.validator_roots_plain(s01, st)
    err["validator_roots"] = max_abs_err(got, plain)
    require(torch.equal(got, plain), "K2 validator_roots differs from its plain version")
    print(f"check K2 validator_roots: N={N_CHECK} bit-equal")

    epoch_fn = tepoch.make_epoch_fn(cfg)
    for label, state in (("synthetic", st.clone()),
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

    seed = hashlib.sha256(b"chip_smoke shuffle").digest()
    seed_words = tshuffle.seed_words_tensor(seed, dev)
    n = N_SHUFFLE_CHECK
    pivots = tshuffle.round_pivots(seed_words, n, cfg.shuffle_round_count, tsha.sha256_1block)
    sources = tshuffle.round_sources(seed_words, cfg.shuffle_round_count, (n + 255) // 256,
                                      tsha.sha256_1block)
    got = tshuffle.shuffle_rounds(pivots, sources, n)
    plain = tshuffle.shuffle_rounds_plain(pivots, sources, n)
    torch.cuda.synchronize()
    err["shuffle_rounds"] = max_abs_err(got, plain)
    require(torch.equal(got, plain), "K5 shuffle_rounds differs from its plain version")
    twin = tshuffle.compute_shuffled_indices_np(n, seed, cfg.shuffle_round_count)
    require(np.array_equal(got.cpu().numpy().view(np.uint32), twin),
            "K5 shuffle_rounds differs from the hashlib twin")
    print(f"check K5 shuffle_rounds: n={n}, {cfg.shuffle_round_count} rounds, bit-equal to the "
          "plain version and to the hashlib twin")

    fresh = troot.registry_columns(st)
    for dirty in (300, 5000):
        # an older state: `dirty` rows differ in one of the six columns
        old = st.clone()
        rows = torch.from_numpy(np.random.default_rng(dirty).choice(
            N_CHECK, dirty, replace=False)).to(dev)
        old_cols = troot.registry_columns(old)
        for j in range(6):
            c, pick = old_cols[j], rows[j::6]
            c[pick] = ~c[pick] if c.dtype == torch.bool else c[pick] ^ 1
        cache_k = tuple(c.clone() for c in old_cols)
        cache_p = tuple(c.clone() for c in old_cols)
        count, idx = tinc.dirty_scan(fresh, cache_k)
        pcount, pidx = tinc.dirty_scan_plain(fresh, cache_p)
        torch.cuda.synchronize()
        k = int(count[0])
        take = min(k, tinc.MAX_DIRTY_VALIDATORS)
        same_rows = (torch.equal(torch.sort(idx[:take]).values, pidx[:take]) if k == take else
                     torch.unique(idx[:take]).shape[0] == take
                     and bool(torch.isin(idx[:take], rows).all()))
        err["dirty_scan"] = max(err["dirty_scan"], abs(k - int(pcount[0])),
                                *(max_abs_err(a, b) for a, b in zip(cache_k, cache_p)))
        require(k == int(pcount[0]) == dirty and same_rows
                and all(torch.equal(a, b) and torch.equal(a, f)
                        for a, b, f in zip(cache_k, cache_p, fresh)),
                f"K6 dirty_scan differs from its plain version ({dirty} dirty rows)")
        if k <= tinc.MAX_DIRTY_VALIDATORS:
            tree_k = tinc.build_tree_levels(troot.validator_roots(s01, old))
            tree_p = tinc.build_tree_levels(troot.validator_roots(s01, old))
            tinc.path_fold(tree_k, idx[:k], tinc.FOLD_VALIDATORS, validators=(s01, fresh))
            tinc.path_fold_plain(tree_p, pidx[:k], tinc.FOLD_VALIDATORS,
                                 validators=(s01, fresh))
            torch.cuda.synchronize()
            err["path_fold"] = max(err["path_fold"], max_abs_err(tree_k.buf, tree_p.buf))
            require(torch.equal(tree_k.buf, tree_p.buf), "K7 path_fold differs from its plain "
                    "version")
            require(torch.equal(tree_k.buf, tinc.build_tree_levels(
                troot.validator_roots(s01, st)).buf), "K7 path_fold differs from a rebuild")
        # the whole cache: built on the older state, refreshed to st
        inc = tinc.IncrementalStateRoot(old, s01)
        inc.refresh_after_epochs(st, last_epoch=0, count=0, epochs_per_historical_vector=1)
        for slot_index in (3, cfg.slots_per_historical_root - 1):
            sroot, broot = rand_words(rng, (8,), dev), rand_words(rng, (8,), dev)
            inc.record_state_root(slot_index, sroot)
            inc.record_block_root(slot_index, broot)
            st.state_roots[slot_index] = sroot
            st.block_roots[slot_index] = broot
        roots, ref = inc.device_roots(st.slot), troot.field_roots_plain(st, s01)
        bad = [key for key in troot.DEVICE_FIELDS if not torch.equal(roots[key], ref[key])]
        require(not bad, f"cache refreshed over {dirty} dirty rows differs on {bad}")
        want = "masked" if dirty <= tinc.MAX_DIRTY_VALIDATORS else "full"
        require(inc.last_branch == want, f"{dirty} dirty rows took {inc.last_branch}")
        print(f"check K6 dirty_scan, K7 path_fold: {dirty} dirty rows at N={N_CHECK} bit-equal "
              f"to the plain versions; cache ({inc.last_branch}) and record_* roots = plain path")
    del st, s01, got, plain, ref, out, old, cache_k, cache_p, inc, tree_k, tree_p

    # 4. the main path at N = 2**20
    state = synthetic_epoch_state(cfg, N_MAIN, seed=0, epoch=250, device=dev)
    static01 = rand_words(rng, (N_MAIN, 16), dev)
    ref = state.clone()
    refreshes = []

    def check_roots(label, roots, direct=None):
        """The cached roots against field_roots and the plain path, uncounted."""
        with Aside():
            direct = direct if direct is not None else troot.field_roots(loop.state, static01)
            plain = troot.field_roots_plain(loop.state, static01)
        bad = [key for key in troot.DEVICE_FIELDS
               if not (torch.equal(roots[key], direct[key]) and torch.equal(roots[key], plain[key]))]
        require(len(roots) == 14 and not bad, f"{label}: cached roots differ on {bad}")
        inc = loop.root_cache
        refreshes.append(dict(at=label, epoch=loop.epoch, dirty=inc.last_dirty,
                              branch=inc.last_branch))
        print(f"refresh {label}: epoch {loop.epoch}, {inc.last_dirty} dirty rows, "
              f"branch {inc.last_branch}; 14 roots = field_roots = plain path", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    loop = ResidentEpochLoop(cfg, state, device=dev)
    check_roots("build", loop.device_roots(static01))
    loop.step_epoch()  # warm-up
    loop.flush()
    check_roots("after warm-up", loop.device_roots())
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
    epoch_ms = ev[0].elapsed_time(ev[1]) / TIMED_EPOCHS
    roots_ms = ev[2].elapsed_time(ev[3])
    after_nine = loop.state.clone()
    check_roots(f"after {TIMED_EPOCHS} epochs", loop.device_roots(), direct=roots)
    refresh_ms, refresh_wall = [], []
    for _ in range(SINGLE_EPOCHS):
        loop.step_epoch()
        loop.flush()
        torch.cuda.synchronize()
        wall0 = time.perf_counter()
        ev[0].record()
        cached = loop.device_roots()
        ev[1].record()
        ev[1].synchronize()
        refresh_wall.append(1e3 * (time.perf_counter() - wall0))
        refresh_ms.append(ev[0].elapsed_time(ev[1]))
        check_roots("single epoch", cached)
    launches = dict(build.LAUNCHES)
    peak = max(Aside.peak, torch.cuda.max_memory_allocated())
    root_refresh_ms = sum(refresh_ms) / SINGLE_EPOCHS
    print(f"main path: N={N_MAIN} epoch_ms={epoch_ms:.4f} (host wall "
          f"{1e3 * wall_epochs / TIMED_EPOCHS:.4f}) field_roots_ms={roots_ms:.4f} "
          f"root_refresh_ms={root_refresh_ms:.4f} (host wall "
          f"{sum(refresh_wall) / SINGLE_EPOCHS:.4f}; each {refresh_ms}) "
          f"launches={launches} max_memory_allocated={peak}")
    for name, count in launches.items():
        require(count > 0, f"the main path never launched {name}")
    branches = {r["branch"] for r in refreshes[1:]}
    require({"masked", "full"} <= branches,
            f"the main path must take both refresh branches, took {sorted(branches)}")

    # the plain path on the card, from the same initial state; at the epoch
    # that rotates, the plain sampler on the same columns
    plain_step = tepoch.process_epoch_plain
    epoch = int(ref.slot) // cfg.slots_per_epoch
    rotation = None
    for i in range(1 + TIMED_EPOCHS):
        new, _ = plain_step(cfg, ref)
        ref = new
        ref.slot.add_(cfg.slots_per_epoch)
        epoch += 1
        if i == 0:
            bad = [k for k, t in after_one.items() if not torch.equal(t, getattr(ref, k))]
            require(not bad, f"state after one epoch differs from the plain path on {bad}")
        if epoch % cfg.epochs_per_sync_committee_period == 0:
            with Aside():
                want, n_active = tsync.sync_committee_for_state(cfg, ref, epoch, plain=True)
                torch.cuda.synchronize()
                wall0 = time.perf_counter()
                ev[0].record()
                again, _ = tsync.sync_committee_for_state(cfg, ref, epoch)
                ev[1].record()
                ev[1].synchronize()
            rotation = dict(epoch=epoch, n_active=n_active, ms=ev[0].elapsed_time(ev[1]),
                            wall_ms=1e3 * (time.perf_counter() - wall0),
                            loop_wall_ms=1e3 * loop.sync_rotation_seconds[0])
            epv = cfg.epochs_per_historical_vector
            mix = ref.randao_mixes[(epoch + epv - cfg.min_seed_lookahead - 1) % epv]
            seed = tsync.sync_committee_seed(epoch, mix)
            require(words_to_bytes(seed.cpu().numpy()) == hashlib.sha256(
                b"\x07\x00\x00\x00" + epoch.to_bytes(8, "little")
                + words_to_bytes(mix.cpu().numpy())).digest(), "sync committee seed != hashlib")
            require(loop.current_sync_committee is None and torch.equal(
                loop.next_sync_committee, want) and torch.equal(again, want)
                and want.shape == (cfg.sync_committee_size,),
                f"the epoch-{epoch} sync committee differs from the plain sampler's")
    bad = [k for k, t in after_nine.items() if not torch.equal(t, getattr(ref, k))]
    require(not bad, f"state after {1 + TIMED_EPOCHS} epochs differs from the plain path on {bad}")
    plain_roots = troot.field_roots_plain(ref, static01)
    bad = [k for k in troot.DEVICE_FIELDS if not torch.equal(roots[k], plain_roots[k])]
    require(len(roots) == 14 and not bad, f"field roots differ from the plain path on {bad}")
    require(rotation is not None and loop.sync_committee_updates == 1,
            "epoch 256 must rotate the sync committee once")
    require(len(loop.historical_roots) == 1, "epoch 256 must fire one historical append")
    hist = merkle_root_hashlib([words_to_bytes(r) for r in ref.block_roots.cpu().numpy()])
    hist += merkle_root_hashlib([words_to_bytes(r) for r in ref.state_roots.cpu().numpy()])
    require(words_to_bytes(loop.historical_roots[0].cpu().numpy())
            == hashlib.sha256(hist).digest(), "historical batch root != hashlib")
    print(f"main path check: state after 1 and 9 epochs, 14 field roots = plain path; "
          f"historical batch root = hashlib; epoch-{rotation['epoch']} sync committee "
          f"({cfg.sync_committee_size} of n={rotation['n_active']} active) = plain sampler; "
          f"sync_rotation_ms={rotation['ms']:.4f} (host wall {rotation['wall_ms']:.4f}; in the "
          f"loop {rotation['loop_wall_ms']:.4f})")
    # historical_batch_root (K1 launches) beside its plain version: 2 x 8191
    # tree nodes and the top hash, 16,383 64-byte hashes
    def batch_root(h):
        top = torch.cat([troot._vector_root_words(ref.block_roots, h),
                         troot._vector_root_words(ref.state_roots, h)])
        return h(top[None])[0]

    with Aside():
        hist_ms = time_ms(lambda: tepoch.historical_batch_root(ref.block_roots, ref.state_roots),
                          10)
        hist_plain_ms = time_ms(lambda: batch_root(tsha.sha256_64B_words_plain), 1)
        require(torch.equal(batch_root(tsha.sha256_64B_words_plain), loop.historical_roots[0]),
                "historical batch root differs from its plain version")
    hist_hashes = 2 * (cfg.slots_per_historical_root - 1) + 1
    del ref, after_one, after_nine, plain_roots

    # 5. kernels beside their plain versions at the main path's shapes
    m = N_MAIN // 2  # the largest K1 launch: the first level of the registry tree
    level = rand_words(rng, (m, 16), dev)
    sass = {"sha256_64b": sass_instructions("sha256", "sha256_64b_kernel"),
            "validator_roots": sass_instructions("state_root", "validator_roots_kernel"),
            "sha256_1block": sass_instructions("sha256", "sha256_1block_kernel"),
            "shuffle_rounds": sass_loop_instructions("shuffle", "shuffle_rounds_kernel")}
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
    # K6 over one epoch's change: the cache as it was before a step, against
    # the state after it; a copy of the stale cache for every call
    stale = troot.registry_columns(pre)
    fresh = troot.registry_columns(st)
    k6_dirty = int(torch.stack([a != b for a, b in zip(fresh, stale)]).any(0).sum())
    col_bytes = sum(t.element_size() for t in fresh)  # 41 B a validator
    k6_bytes = (2 * col_bytes * N_MAIN + col_bytes * k6_dirty
                + 8 * min(k6_dirty, tinc.MAX_DIRTY_VALIDATORS) + 4)
    stale_copies = [tuple(c.clone() for c in stale) for _ in range(13)]
    # K7 at the main path's K (the last masked refresh's) and at the budget
    vlevels = tinc.build_tree_levels(troot.validator_roots(static01, st))
    main_k = max([r["dirty"] for r in refreshes if r["branch"] == "masked"][-1], 1)

    def fold_rows(k):
        return torch.from_numpy(np.sort(np.random.default_rng(k).choice(
            N_MAIN, k, replace=False))).to(dev)

    def fold_ops(idx):
        """Hashes a fold needs: 7 a container, then one a distinct path node."""
        nodes = sum(torch.unique(idx >> (lvl + 1)).shape[0] for lvl in range(vlevels.depth))
        return sass["validator_roots"] * idx.shape[0] + sass["sha256_64b"] * nodes

    def fold_ms(idx, plain=False):
        f = tinc.path_fold_plain if plain else tinc.path_fold
        return time_ms(lambda: f(vlevels, idx, tinc.FOLD_VALIDATORS,
                                 validators=(static01, fresh)), 1 if plain else 20)

    # K4 at the rotation's sources batch, K5 at the rotation's n
    n_rot = rotation["n_active"]
    buckets = (n_rot + 255) // 256
    rounds = cfg.shuffle_round_count
    k4_m = rounds * buckets
    k4_msgs = rand_words(rng, (k4_m, 16), dev)
    rot_seed = rand_words(rng, (8,), dev)
    rot_pivots = tshuffle.round_pivots(rot_seed, n_rot, rounds, tsha.sha256_1block)
    rot_sources = tshuffle.round_sources(rot_seed, rounds, buckets, tsha.sha256_1block)
    fresh_k3 = [pre.clone() for _ in range(11)]  # K3 works in place: one copy a call

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / LANE_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")

    with Aside():
        idx_main, idx_cap = fold_rows(main_k), fold_rows(tinc.MAX_DIRTY_VALIDATORS)
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
                 ms=time_ms(lambda: tepoch.epoch_sweep(cfg, fresh_k3.pop()), 10),
                 plain_ms=time_ms(lambda: tepoch.process_epoch_plain(cfg, pre), 2),
                 **bound(0, k3_read + k3_written)),
            dict(name="sha256_1block", source="consensus_specs_tpu_torch/csrc/sha256.cu",
                 replaces="consensus_specs_tpu/ops/sha256_jax.py:70",
                 shape=f"M={k4_m}", ms=time_ms(lambda: tsha.sha256_1block(k4_msgs), 20),
                 plain_ms=time_ms(lambda: tsha.sha256_1block_plain(k4_msgs), 2),
                 **bound(sass["sha256_1block"] * k4_m, 96 * k4_m)),
            # K5's operations: its round loop's instructions, rounds times an
            # index; its bytes: the pivots and digests read once and the map
            # written once (the per-round digest sector re-reads hit L2)
            dict(name="shuffle_rounds", source="consensus_specs_tpu_torch/csrc/shuffle.cu",
                 replaces="consensus_specs_tpu/ops/shuffle.py:97",
                 shape=f"n={n_rot} rounds={rounds}",
                 ms=time_ms(lambda: tshuffle.shuffle_rounds(rot_pivots, rot_sources, n_rot), 20),
                 plain_ms=time_ms(lambda: tshuffle.shuffle_rounds_plain(
                     rot_pivots, rot_sources, n_rot), 2),
                 l2_sector_bytes=32 * rounds * n_rot,
                 **bound(sass["shuffle_rounds"] * rounds * n_rot,
                         4 * rounds + 32 * rounds * buckets + 4 * n_rot)),
            # K6 branches on the data: bytes only, as this epoch's data needs them
            dict(name="dirty_scan", source="consensus_specs_tpu_torch/csrc/incremental_root.cu",
                 replaces="consensus_specs_tpu/engine/incremental_root.py:137",
                 shape=f"N={N_MAIN} dirty={k6_dirty}",
                 ms=time_ms(lambda: tinc.dirty_scan(fresh, stale_copies.pop()), 10),
                 plain_ms=time_ms(lambda: tinc.dirty_scan_plain(fresh, stale_copies.pop()), 1),
                 **bound(0, k6_bytes)),
            dict(name="path_fold", source="consensus_specs_tpu_torch/csrc/incremental_root.cu",
                 replaces="consensus_specs_tpu/engine/incremental_root.py:84",
                 shape=f"K={main_k} depth={vlevels.depth}",
                 ms=fold_ms(idx_main), plain_ms=fold_ms(idx_main, plain=True),
                 **bound(fold_ops(idx_main), 0),
                 ms_k1024=fold_ms(idx_cap), plain_ms_k1024=fold_ms(idx_cap, plain=True),
                 bound_ms_k1024=bound(fold_ops(idx_cap), 0)["bound_ms"]),
        ]
    for row in rows:
        row.update(route="cuda", launches=launches[row["name"]],
                   max_abs_err=err[row["name"]], bit_equal=err[row["name"]] == 0.0,
                   library_ms=None)
    card = card_line()
    print(card)
    print(json.dumps({"kernels": rows, "main_path": {
        "n": N_MAIN, "epoch_ms": epoch_ms, "field_roots_ms": roots_ms,
        "root_refresh_ms": root_refresh_ms, "root_refresh_each_ms": refresh_ms,
        "root_refresh_wall_ms": sum(refresh_wall) / SINGLE_EPOCHS,
        "sync_rotation_ms": rotation["ms"], "sync_rotation_wall_ms": rotation["wall_ms"],
        "sync_rotation_loop_wall_ms": rotation["loop_wall_ms"], "n_active": n_rot,
        "refreshes": refreshes, "max_memory_allocated": peak,
        "historical_batch_root": dict(ms=hist_ms, plain_ms=hist_plain_ms, hashes=hist_hashes,
                                      **bound(sass["sha256_64b"] * hist_hashes, 2 * 8192 * 32
                                              + 32))}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
