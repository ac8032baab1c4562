#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the epoch, BLS, key-aggregation, KZG and
fork-choice paths on one NVIDIA card.

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
   K8-K12 (the BLS field, ladders, point sums, Miller loop and final
   exponentiation) on 8 seeded items with the field's edge values, z = 1
   and 2^64 - 1 and an empty segment, and two pairing cubes against the
   copied oracle; K13 g1_msm on 8 items (64- and 255-bit scalars, windows 4
   and 5, a zero scalar, 2^64 - 1, a repeated point, a P + (-P) pair) and
   K14 g1_subgroup on 8 points (a pad and the on-curve (0, 2) outside the
   subgroup);
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
5. the BLS path, its launch counts zeroed just before and read just after:
   the signature flush of one altair block at N = 2**20 (131 checks with
   distinct messages: the randomized check bucketed to 256, 257 Miller
   loops), the same block with one signature replaced (the per-item pass
   must flag exactly it), one slot's gossip aggregates (64 committees x 16
   aggregators: the grouped check, 65 Miller loops) and that batch with a
   bad item, and the port's BLS shim over 22 byte-level calls (one flush on
   the card; with a bad signature it must raise). Inputs come from seed 0
   (`crypto/bls_synthetic.flush_inputs`, the port's copy of the
   pure-Python oracle);
5b. the block's committee keys (`crypto/msm_synthetic.block_aggregate_inputs`,
   seed 0: 128 attestation committees of 512 and the sync committee of 512,
   66,048 keys as bytes), launch counts zeroed before each part and read
   after it: cold (key caches cleared; every key decompressed on the host,
   129 K14 and 129 K10 launches, each aggregate equal to the oracle's),
   warm (the 128 attestation committees' 65,536 keys validated, no
   committee aggregate: 128 K10 launches, no K14), hot (the committee cache:
   no launch), the flush of the 129 checks, and through the shim the block
   with one key outside the subgroup, which must raise;
5c. the KZG batch at 128 blobs (`msm_synthetic.kzg_inputs`, seed 0): the
   sample batch (two K13 MSMs, one 2-pairing check) accepted, its twin with
   one tampered value rejected, the 128 degree proofs accepted;
5d. the LMD-GHOST head (`forkchoice/synthetic.build_storm`: the fork-choice
   bench's storm tree, seed 2302, with the synthetic registry's balances)
   through `engine/fork_choice.ghost_head_batch` at V = 2**20, launch counts
   zeroed before each part and read after it (one launch of each of K15-K18
   a part): (a) the 512-block tree, one snapshot; (b) 8 snapshots with V/8
   votes swung between the two tips, every other one boosted, in one group
   (the heads must take both tips); (c) 8,192 blocks, 256 epochs without
   finality (boost off: `host_head`'s boost walk is quadratic). Every head
   equals `host_head`; every stage output of K15-K18 is bit-equal to
   `ghost_head_parts` on the same card tensors; (a)'s head also equals the
   plain version's on CPU copies, and (c) is held again at V = 2**16;
6. time each kernel beside its plain version at the main path's shapes,
   and give its least time: operations from the instructions counted in
   its SASS (for K8-K12: the plain version's Fp products on the same
   inputs times the instructions of K8's product), bytes from what this
   run's data needs. K8-K12 are held bit-equal to their plain versions
   there too, at every shape the BLS path gives them (K8 at the block's
   and the gossip's M, K9 at N = 256 and 1,024, K10 on both G2 collapses
   and the 64 G1 segments, K11 at B = 257, 65 and 512, K12's tail at 257
   and 65 and its batch at 256); K13 at (128, 64) and (512, 255), K14 and
   K10's aggregate over a 512-key committee, each bit-equal to its plain
   version there, their least time from the cost functions' point
   operations; K15-K18 at the three fork-choice parts' shapes, their least
   time from the bytes read and written once or the operations the data
   needs, and K16 beside `index_add_`.

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
BLS_KERNELS = ("fp_ops", "rlc_ladders", "point_sums", "miller_loop", "final_exp")
MSM_KERNELS = ("g1_msm", "g1_subgroup")
FC_KERNELS = ("fc_ancestors", "fc_vote_weights", "fc_subtree", "fc_head_walk")
FC_BLOCKS = 512         # the fork-choice bench's default storm tree
FC_LONG_BLOCKS = 8192   # a block a slot for 256 epochs without finality
FC_BATCH = 8
FC_SEED = 1             # the batch's swings (Storm.perturbed)
FC_V_SMALL = 1 << 16    # the long tree's second vote set


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


def check_bls_kernels(dev, err: dict) -> None:
    """K8-K12 each bit-equal to its plain version on the card at a small
    batch (8 items: seeded keys, three messages, z = 1 and 2^64 - 1 among the
    scalars, an empty segment), plus a pairing cube against the oracle."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.crypto.bls_torch import zbits_from_ints
    from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.ops import fp

    rng = np.random.default_rng(3)
    n = 8
    vals = [int.from_bytes(rng.bytes(48), "little") % fp.P for _ in range(2 * n)]
    vals[:4] = [0, 1, fp.P - 1, fp.R_MOD_P]
    words = torch.from_numpy(fp.ints_to_words(vals)).to(dev)
    a, b = words[:n], words[n:]
    for op in range(7):
        got = fp.fp_ops(op, a, b if op in fp._BINARY else None)
        plain = fp.fp_ops_plain(op, a, b if op in fp._BINARY else None)
        err["fp_ops"] = max(err["fp_ops"], max_abs_err(got, plain))
        require(torch.equal(got, plain), f"K8 fp_ops op {op} differs from its plain version")
    F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
    ks = [int(k) for k in rng.integers(1, 2**62, n, dtype=np.int64)]
    hs = [hash_to_curve_g2(b"chip_smoke %d" % (i % 3)) for i in range(n)]
    pks = B.g1_to_words([oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k))
                         for k in ks]).to(dev)
    sigs = B.g2_to_words([oracle.pt_to_affine(F2, oracle.pt_mul(
        F2, oracle.pt_from_affine(F2, h), k)) for h, k in zip(hs, ks)]).to(dev)
    zs = [1, 2**64 - 1] + [int(v) for v in rng.integers(1, 2**63, n - 2, dtype=np.int64)]
    zb = zbits_from_ints(zs, dev)
    for affine in (True, False):
        got = B.rlc_ladders(pks, sigs, zb, affine)
        plain = B.rlc_ladders_plain(pks, sigs, zb, affine)
        err["rlc_ladders"] = max(err["rlc_ladders"], *(max_abs_err(g, p) for g, p in
                                                       zip(got, plain)))
        require(all(torch.equal(g, p) for g, p in zip(got, plain)),
                f"K9 rlc_ladders (affine={affine}) differs from its plain version")
    g1j, g2j = got
    for pts, off in ((g1j, [0, 3, 3, 8]), (g2j, [0, n])):
        off = torch.tensor(off, device=dev)
        got_s, plain_s = B.point_sums(pts, off), B.point_sums_plain(pts, off)
        err["point_sums"] = max(err["point_sums"], max_abs_err(got_s, plain_s))
        require(torch.equal(got_s, plain_s), "K10 point_sums differs from its plain version")
    q = B.g2_to_words(hs).to(dev)
    m = B.miller_loop(q, pks)
    m_plain = B.miller_loop_plain(q, pks)
    err["miller_loop"] = max_abs_err(m, m_plain)
    require(torch.equal(m, m_plain), "K11 miller_loop differs from its plain version")
    for got, plain in ((B.final_exp_batch(m), B.final_exp_batch_plain(m)),
                       (B.final_exp_batch(m[:4], m[4:]), B.final_exp_batch_plain(m[:4], m[4:])),
                       (B.final_exp_tail(m[:-1], m[-1]), B.final_exp_tail_plain(m[:-1], m[-1]))):
        err["final_exp"] = max(err["final_exp"], max_abs_err(got[0], plain[0]))
        require(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
                "K12 final_exp differs from its plain version")
    cube = B.f12_from_words(B.pairing_cube_batch(q[:2], pks[:2]))
    for i, c in enumerate(cube):
        e = oracle.pairing(hs[i], B.affine_from_words(pks[i:i + 1], False)[0])
        require(c == oracle.f12_mul(oracle.f12_sqr(e), e), "pairing cube != oracle")
    print(f"check K8-K12: {n} items bit-equal to the plain versions (K8 all 7 ops with 0, 1, "
          f"p-1, R mod p; K9 both G1 forms with z = 1, 2^64-1; K10 with an empty segment; K12 "
          f"batch, batch with m2, tail); 2 pairing cubes = oracle", flush=True)


def check_msm_kernels(dev, err: dict) -> None:
    """K13 and K14 each bit-equal to its plain version on the card at 8
    items: K13 over 64- and 255-bit scalars at windows 4 and 5 with a zero
    scalar, 2^64 - 1, a repeated point and a P + (-P) pair that cancels; K14
    over 8 points with a pad (Z = 0) and the on-curve (0, 2) outside the
    subgroup."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.ops import bls12 as B

    F1 = oracle.FP_FIELD
    rng = np.random.default_rng(5)
    pts = [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, int(k)))
           for k in rng.integers(1, 2**62, 5, dtype=np.int64)]
    pts += [pts[0], pts[1], (pts[1][0], (-pts[1][1]) % oracle.P)]  # repeat, then P + (-P)
    jac = B._jacobian_words(pts, 0, dev)
    for nbits in (64, 255):
        sc = [int.from_bytes(rng.bytes(32), "little") % (1 << nbits) for _ in pts]
        sc[:2] = [0, 2**64 - 1]
        sc[7] = sc[6]  # the opposite pair cancels
        words = B.scalar_words(sc, nbits).to(dev)
        for window in (4, 5):
            got, plain = B.g1_msm(jac, words, nbits, window), B.g1_msm_plain(jac, words, nbits,
                                                                               window)
            err["g1_msm"] = max(err["g1_msm"], max_abs_err(got, plain))
            require(torch.equal(got, plain), f"K13 g1_msm ({nbits} bits, w={window}) differs "
                    "from its plain version")
            want = B._affine_or_none(plain)
            host = None
            for p, s in zip(pts, sc):
                t = oracle.pt_mul(F1, oracle.pt_from_affine(F1, p), s)
                host = oracle.pt_add(F1, host, t)
            require(want == oracle.pt_to_affine(F1, host), "K13's plain version != the oracle")
    # P + (-P) alone, padded as g1_msm_device pads: the identity, (0, 0)
    cancel = B._jacobian_words(pts[6:] + [oracle.G1_GEN_AFF] * 6, 0, dev)
    words = B.scalar_words([2**64 - 1] * 2 + [0] * 6, 64).to(dev)
    got, plain = B.g1_msm(cancel, words, 64), B.g1_msm_plain(cancel, words, 64)
    err["g1_msm"] = max(err["g1_msm"], max_abs_err(got, plain))
    require(torch.equal(got, plain) and B._affine_or_none(plain) is None,
            "K13 g1_msm on P + (-P) differs from its plain version or is not the identity")
    sub = torch.cat([jac[:6], B._jacobian_words([(0, 2)], 1, dev)])
    got, plain = B.g1_subgroup_check(sub), B.g1_subgroup_check_plain(sub)
    err["g1_subgroup"] = max_abs_err(got.int(), plain.int())
    require(torch.equal(got, plain) and plain.tolist() == [True] * 6 + [False, True],
            f"K14 g1_subgroup differs from its plain version: {got.tolist()}")
    print("check K13-K14: g1_msm bit-equal to its plain version at 8 items (64 and 255 bits, "
          "w = 4 and 5, a zero scalar, 2^64 - 1, a repeated point, P + (-P)) and = the oracle, "
          "and on P + (-P) alone (the identity); g1_subgroup bit-equal with a pad and (0, 2)",
          flush=True)


def timed(fn):
    """fn() between two CUDA events on the current stream and on the host
    clock: (result, event ms, host wall ms)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1]), 1e3 * (time.perf_counter() - wall0)


def bls_main_path(dev, inputs) -> dict:
    """The flush of one block (131 checks: the randomized path, bucketed to
    256), the same block with one signature replaced (the per-item path flags
    exactly it), one slot's gossip aggregates (1024 checks, 64 messages: the
    grouped path) and that batch with one bad item, and the shim over 20
    byte-level calls flushed once on the card, then once with a bad one."""
    from consensus_specs_tpu_torch.crypto import bls, bls_torch
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.utils import bucketing

    block, gossip, shim = inputs
    b = bucketing.pow2_bucket(len(block), 8)
    plan = bucketing.grouped_plan([c.q1 for c in gossip], 8)
    out = {}
    loops0 = B.miller_loop_items
    ok, out["bls_block_flush_ms"], out["bls_block_flush_wall_ms"] = timed(
        lambda: bls_torch.run_checks(block, dev))
    out["block_miller_loops"] = B.miller_loop_items - loops0
    require(ok.all() and bls_torch.LAST_FLUSH == dict(path="rlc", items=b, distinct=b,
                                                      miller_loops=b + 1)
            and out["block_miller_loops"] == b + 1,
            f"block flush: {int(ok.sum())} of {len(block)} ok, {bls_torch.LAST_FLUSH}, "
            f"{out['block_miller_loops']} Miller loops")
    bad_at = len(block) // 2 + 1
    bad = list(block)
    bad[bad_at] = bls_torch.QueuedCheck(block[bad_at].p1, block[bad_at].q1, block[bad_at].p2,
                                        block[bad_at + 1].q2)
    loops0 = B.miller_loop_items
    ok, out["bls_attribution_ms"], out["bls_attribution_wall_ms"] = timed(
        lambda: bls_torch.run_checks(bad, dev))
    out["attribution_miller_loops"] = B.miller_loop_items - loops0
    require(np.flatnonzero(~ok).tolist() == [bad_at]
            and out["attribution_miller_loops"] == b + 1 + 2 * b,
            f"attribution flagged {np.flatnonzero(~ok).tolist()}, not [{bad_at}]")
    loops0 = B.miller_loop_items
    ok, out["bls_gossip_flush_ms"], out["bls_gossip_flush_wall_ms"] = timed(
        lambda: bls_torch.run_checks(gossip, dev))
    out["gossip_miller_loops"] = B.miller_loop_items - loops0
    require(ok.all() and bls_torch.LAST_FLUSH == dict(path="rlc_grouped", items=plan.b_n,
                                                      distinct=plan.b_d,
                                                      miller_loops=plan.b_d + 1)
            and out["gossip_miller_loops"] == plan.b_d + 1,
            f"gossip flush: {int(ok.sum())} ok, {bls_torch.LAST_FLUSH}")
    bad = list(gossip)
    at = len(gossip) // 2
    bad[at] = bls_torch.QueuedCheck(gossip[at].p1, gossip[at].q1, gossip[at].p2,
                                    gossip[at + 1].q2)
    p1s, q1s, p2s, q2s = ([getattr(c, k) for c in bad] for k in ("p1", "q1", "p2", "q2"))
    require(not bls_torch._device_check_all(p1s, q1s, p2s, q2s, dev),
            "the gossip batch with a bad item passed the randomized check")
    bls.use_device(dev)
    pks, msgs, sigs = shim["pks"], shim["msgs"], shim["sigs"]
    flushes = bls.flush_count
    wall0 = time.perf_counter()
    with bls.deferred_verification():
        for i in range(16):
            require(bls.Verify(pks[i], msgs[i], sigs[i]), "a deferred Verify returned False")
        require(bls.FastAggregateVerify(pks[:4], msgs[0], shim["committee_sig"]), "deferred")
        require(bls.AggregateVerify(pks[:2], msgs[:2], shim["multi_sig"]), "deferred")
        for i in range(16, 20):
            require(bls.Verify(pks[i], msgs[i], sigs[i]), "deferred")
    out["bls_shim_flush_wall_ms"] = 1e3 * (time.perf_counter() - wall0)
    out["shim_flush"] = dict(bls_torch.LAST_FLUSH)
    require(bls.flush_count == flushes + 1 and out["shim_flush"]["items"] >= 21,
            "the shim's 22 calls must flush once, on the randomized path")
    raised = False
    try:
        with bls.deferred_verification():
            for i in range(16):
                bls.Verify(pks[i], msgs[i], sigs[i if i != 9 else 10])
    except bls.BLSVerificationError as e:
        raised = "[9]" in str(e)
    require(raised, "the shim's flush with a bad signature must raise for check 9")
    print(f"bls main path: block flush of {len(block)} checks ok through "
          f"{out['block_miller_loops']} Miller loops; bad signature at {bad_at} attributed "
          f"({out['attribution_miller_loops']} Miller loops); gossip flush of {len(gossip)} "
          f"checks over {plan.d} messages ok through {out['gossip_miller_loops']} Miller loops, "
          f"a bad item fails it; shim: 22 calls, one flush on the card, a bad one raised",
          flush=True)
    return out


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def bls_rows(dev, inputs, launches, err, sass_mul) -> list:
    """K8-K12 at every shape of the main path: each output equal to its plain
    version's on every element (K9's two point sets, K12's cube and is_one),
    the time, the plain version's time and its Fp product count on the same
    inputs (the least time: that count times the instructions of one product
    in K8's SASS over the lane issue rate, or the kernel's bytes over HBM's
    rate, the larger). The scalars are seeded, not the flush's CSPRNG draw."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls_torch
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.ops import fp

    block, gossip, _ = inputs
    cols = ([c.p1 for c in block], [c.q1 for c in block], [c.p2 for c in block],
            [c.q2 for c in block])
    b, (q1, p1, q2, p2) = bls_torch._pack_pairing_args(*cols, dev)
    rng = np.random.default_rng(4)
    zb = bls_torch.zbits_from_ints(rng.integers(1, 2**64, b, dtype=np.uint64), dev)
    b_n, b_d, (gq1, gp1, gq2), seg = bls_torch._pack_grouped_args(
        [c.p1 for c in gossip], [c.q1 for c in gossip], [c.q2 for c in gossip], dev)
    gzb = bls_torch.zbits_from_ints(rng.integers(1, 2**64, b_n, dtype=np.uint64), dev)
    flat = torch.from_numpy(fp.ints_to_words(
        [v for c in block for v in (*c.p1, *c.q1[0], *c.q1[1], *c.q2[0], *c.q2[1], *c.p2)]))
    canon = torch.cat([flat, flat[:(b - len(block)) * 12]]).to(dev)  # the flush's M
    gcanon = torch.from_numpy(fp.ints_to_words(  # the gossip flush's M: 64 H(m), 1024 pk, sig
        [v for c in gossip[::b_n // b_d] for v in (*c.q1[0], *c.q1[1])]
        + [v for c in gossip for v in (*c.p1, *c.q2[0], *c.q2[1])])).to(dev)
    r2 = torch.from_numpy(fp.ints_to_words([fp.R2_MOD_P])[0]).to(dev)
    neg_g1 = B.neg_g1_words(dev)[None]
    a1, zsig = B.rlc_ladders(p1, q2, zb)
    whole = torch.tensor([0, b], device=dev)
    aq = B.point_sums(zsig, whole)
    mq, mp = torch.cat([q1, aq]), torch.cat([a1, neg_g1])
    m = B.miller_loop(mq, mp)
    aqs, aps = torch.cat([q1, q2]), torch.cat([p1, p2])  # the attribution's pairs
    m2 = B.miller_loop(aqs, aps)
    g1j, gzsig = B.rlc_ladders(gp1, gq2, gzb, affine_g1=False)
    order, offsets = B.segment_offsets(seg, b_d)
    g1s = g1j[order].contiguous()
    gwhole = torch.tensor([0, b_n], device=dev)
    gmq = torch.cat([gq1, B.point_sums(gzsig, gwhole)])
    gmp = torch.cat([B.point_sums(g1s, offsets), neg_g1])
    gm = B.miller_loop(gmq, gmp)

    def measured(name, label, kernel, plain, reps):
        """(ms, plain_ms, Fp products of the plain version); fails unless
        the kernel's outputs equal the plain version's on every element"""
        muls0 = fp.plain_muls
        want, plain_ms, _ = timed(plain)
        muls = fp.plain_muls - muls0
        got = _outputs(kernel())
        want = _outputs(want)
        require(len(got) == len(want) and all((g is None) == (w is None) for g, w in
                                              zip(got, want)), f"{name} ({label}): outputs")
        pairs = [(g, w) for g, w in zip(got, want) if g is not None]
        err[name] = max(err[name], *(max_abs_err(g, w) for g, w in pairs))
        require(all(torch.equal(g, w) for g, w in pairs),
                f"{name} ({label}) differs from its plain version at the main path's shape")
        return time_ms(kernel, reps, warmup=0), plain_ms, muls

    def bound(muls, nbytes):
        t_ops, t_bytes = muls * sass_mul / LANE_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")

    specs = [
        ("fp_ops", "fp.cu", "consensus_specs_tpu/ops/limb_mont.py:39", f"M={canon.shape[0]} mul",
         lambda: fp.fp_ops(fp.OP_MUL, canon, r2.expand_as(canon)),
         lambda: fp.fp_ops_plain(fp.OP_MUL, canon, r2.expand_as(canon)), 3 * canon.numel() * 4),
        ("rlc_ladders", "rlc.cu", "consensus_specs_tpu/ops/bls12_jax.py:782",
         f"N={b} G1 affine + G2",
         lambda: B.rlc_ladders(p1, q2, zb), lambda: B.rlc_ladders_plain(p1, q2, zb),
         (p1.numel() + q2.numel() + zb.numel() + a1.numel() + zsig.numel()) * 4),
        ("point_sums", "rlc.cu", "consensus_specs_tpu/ops/bls12_jax.py:1014",
         f"G2 N={b} D=1",
         lambda: B.point_sums(zsig, whole), lambda: B.point_sums_plain(zsig, whole),
         (zsig.numel() + aq.numel()) * 4 + 16),
        ("miller_loop", "pairing.cu", "consensus_specs_tpu/ops/bls12_jax.py:514",
         f"B={mq.shape[0]}",
         lambda: B.miller_loop(mq, mp), lambda: B.miller_loop_plain(mq, mp),
         (mq.numel() + mp.numel() + m.numel()) * 4),
        ("final_exp", "pairing.cu", "consensus_specs_tpu/ops/bls12_jax.py:611",
         f"tail B={m.shape[0]}",
         lambda: B.final_exp_tail(m[:-1], m[-1]), lambda: B.final_exp_tail_plain(m[:-1], m[-1]),
         (m.numel() + 144 + 1) * 4),
    ]
    # the other shapes of the main path: (kernel, label, kernel call, plain call, bytes)
    extra = [
        ("fp_ops", "gossip", lambda: fp.fp_ops(fp.OP_MUL, gcanon, r2.expand_as(gcanon)),
         lambda: fp.fp_ops_plain(fp.OP_MUL, gcanon, r2.expand_as(gcanon)),
         3 * gcanon.numel() * 4),
        ("rlc_ladders", "gossip", lambda: B.rlc_ladders(gp1, gq2, gzb, affine_g1=False),
         lambda: B.rlc_ladders_plain(gp1, gq2, gzb, affine_g1=False),
         (gp1.numel() + 2 * gq2.numel() + gzb.numel() + g1j.numel()) * 4),
        ("point_sums", "gossip_g2", lambda: B.point_sums(gzsig, gwhole),
         lambda: B.point_sums_plain(gzsig, gwhole), (gzsig.numel() + aq.numel()) * 4 + 16),
        ("point_sums", "gossip_g1", lambda: B.point_sums(g1s, offsets),
         lambda: B.point_sums_plain(g1s, offsets), (g1s.numel() + b_d * 24) * 4),
        ("miller_loop", "gossip", lambda: B.miller_loop(gmq, gmp),
         lambda: B.miller_loop_plain(gmq, gmp), (gmq.numel() + gmp.numel() + gm.numel()) * 4),
        ("miller_loop", "attribution", lambda: B.miller_loop(aqs, aps),
         lambda: B.miller_loop_plain(aqs, aps), (aqs.numel() + aps.numel() + m2.numel()) * 4),
        ("final_exp", "gossip_tail", lambda: B.final_exp_tail(gm[:-1], gm[-1]),
         lambda: B.final_exp_tail_plain(gm[:-1], gm[-1]), (gm.numel() + 144 + 1) * 4),
        ("final_exp", "attribution_batch", lambda: B.final_exp_batch(m2[:b], m2[b:]),
         lambda: B.final_exp_batch_plain(m2[:b], m2[b:]),
         (m2.numel() + m2.numel() // 2 + b) * 4),
    ]
    rows = {}
    with Aside():
        for name, src, replaces, shape, kernel, plain, nbytes in specs:
            ms, plain_ms, muls = measured(name, shape, kernel, plain,
                                          5 if name == "fp_ops" else 3)
            rows[name] = dict(name=name, source=f"consensus_specs_tpu_torch/csrc/{src}",
                              replaces=replaces, shape=shape, ms=ms, plain_ms=plain_ms,
                              fp_muls=muls, **bound(muls, nbytes))
        for name, label, kernel, plain, nbytes in extra:
            ms, plain_ms, muls = measured(name, label, kernel, plain, 3)
            rows[name][label] = dict(ms=ms, plain_ms=plain_ms, fp_muls=muls,
                                     **bound(muls, nbytes))
    rows = list(rows.values())
    for row in rows:
        row.update(route="cuda", launches=launches[row["name"]], max_abs_err=err[row["name"]],
                   bit_equal=err[row["name"]] == 0.0, library_ms=None,
                   ms_over_bound=row["ms"] / row["bound_ms"])
        print(f"kernel {row['name']} ({row['shape']}): ms={row['ms']:.5f} "
              f"launches={row['launches']} bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
              f"plain_ms={row['plain_ms']:.3f} library_ms=None fp_muls={row['fp_muls']}",
              flush=True)
    return rows


def msm_main_path(dev, agg_in, kzg_in) -> tuple:
    """The block's key aggregation (cold, warm, hot, its flush, a block with a
    key outside the subgroup through the shim) and the KZG batch at 128 blobs
    (samples, a tampered twin, degree proofs): (metrics, launches by part).
    Launch counts are zeroed just before each part and read just after."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls, bls_torch, kzg_batch
    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.kernels import build

    calls, aggregates = agg_in["calls"], agg_in["aggregates"]
    n_att = len(calls) - 1
    out, launches = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        build.reset_launches()
        res, ms, wall = timed(fn)
        launches[name] = {k: v for k, v in build.LAUNCHES.items() if v}
        return res, ms, wall

    def aggregate(subset):
        return [bls_torch.make_fast_aggregate_check(pks, msg, sig, device=dev)
                for pks, msg, sig in subset]

    bls_torch.clear_caches()
    checked0 = bls_torch.pubkey_subgroup_device_total
    wall0 = time.perf_counter()
    for _, _, sig in calls:  # signatures decompressed before: the key work is timed
        bls_torch.g2_from_bytes(sig)
    out["signature_decompress_wall_ms"] = 1e3 * (time.perf_counter() - wall0)
    checks, out["agg_block_cold_ms"], out["agg_block_cold_wall_ms"] = part(
        "cold", lambda: aggregate(calls))
    require(all(c is not None for c in checks)
            and [c.p1 for c in checks] == aggregates, "cold aggregation != the oracle's sums")
    require(launches["cold"] == {"g1_subgroup": len(calls), "point_sums": len(calls)},
            f"cold aggregation launched {launches['cold']}")
    out["cold_keys_checked"] = bls_torch.pubkey_subgroup_device_total - checked0
    require(out["cold_keys_checked"] == sum(len(c[0]) for c in calls),
            "cold aggregation did not check every key once")
    # warm: the attestations' 65,536 keys validated, no committee aggregate
    bls_torch._PK_VALIDATED.clear()
    for pks, _, _ in calls[:n_att]:
        bls_torch._PK_VALIDATED.update((pk, agg_in["keys"][pk]) for pk in pks)
    require(len(bls_torch._PK_VALIDATED) == bls_torch._PK_VALIDATED_MAX, "warm key set size")
    bls_torch._AGG_CACHE.clear()
    warm, out["agg_block_warm_ms"], out["agg_block_warm_wall_ms"] = part(
        "warm", lambda: aggregate(calls[:n_att]))
    require([c.p1 for c in warm] == aggregates[:n_att]
            and launches["warm"] == {"point_sums": n_att},
            f"warm aggregation launched {launches['warm']}")
    hot, out["agg_block_hot_ms"], out["agg_block_hot_wall_ms"] = part(
        "hot", lambda: aggregate(calls[:n_att]))
    require([c.p1 for c in hot] == aggregates[:n_att] and launches["hot"] == {},
            f"hot aggregation launched {launches['hot']}")
    ok, out["agg_block_flush_ms"], out["agg_block_flush_wall_ms"] = part(
        "flush", lambda: bls_torch.run_checks(checks, dev))
    require(ok.all() and bls_torch.LAST_FLUSH["path"] == "rlc", "the block's 129 checks failed")
    bls.use_device(dev)
    bad_calls = [list(c) for c in calls]
    at = len(calls) // 25
    bad_calls[at][0] = list(bad_calls[at][0])
    bad_calls[at][0][17] = oracle.g1_to_bytes((0, 2))  # on the curve, outside the subgroup
    raised = False
    try:
        with bls.deferred_verification():
            for pks, msg, sig in bad_calls:
                bls.FastAggregateVerify(pks, msg, sig)
    except bls.BLSVerificationError as e:
        raised = f"[{at}]" in str(e)
    require(raised, f"the shim's block with a key outside the subgroup must raise for call {at}")
    print(f"block aggregation: {len(calls)} calls, {sum(len(c[0]) for c in calls)} keys; "
          f"cold {launches['cold']}, warm {launches['warm']}, hot {launches['hot']}; every "
          f"aggregate = the oracle's; the flush passed; a key outside the subgroup raised",
          flush=True)

    setup, samples = kzg_in["setup"], kzg_in["samples"]
    ok, out["kzg_batch_128_ms"], out["kzg_batch_128_wall_ms"] = part(
        "kzg_samples", lambda: kzg_batch.batch_verify_samples(setup, samples, device=dev))
    require(ok and {k: launches["kzg_samples"].get(k) for k in ("g1_msm", "miller_loop",
                                                                "final_exp")}
            == {"g1_msm": 2, "miller_loop": 1, "final_exp": 1},
            f"the KZG sample batch failed or missed the card: {launches['kzg_samples']}")
    bad = [list(it) for it in samples]
    at = len(bad) * 3 // 5
    bad[at][2] = list(bad[at][2])
    bad[at][2][-1] = (bad[at][2][-1] + 1) % kzg_batch.MODULUS
    ok, out["kzg_tampered_ms"], _ = part(
        "kzg_tampered",
        lambda: kzg_batch.batch_verify_samples(setup, [tuple(it) for it in bad], device=dev))
    require(not ok and launches["kzg_tampered"].get("g1_msm") == 2,
            "the tampered KZG batch was accepted")
    ok, out["kzg_degree_128_ms"], out["kzg_degree_128_wall_ms"] = part(
        "kzg_degree", lambda: kzg_batch.batch_verify_degree_proofs(
            setup, kzg_in["degree_proofs"], kzg_in["points_count"], device=dev))
    require(ok and launches["kzg_degree"].get("g1_msm") == 2, "the degree-proof batch failed")
    print(f"kzg batch: {len(samples)} samples accepted ({launches['kzg_samples']}), a tampered "
          f"value rejected, {len(kzg_in['degree_proofs'])} degree proofs accepted", flush=True)
    return out, launches


def msm_rows(dev, agg_in, kzg_in, launches, err, sass_mul) -> tuple:
    """K13, K14 and K10's aggregate at the shapes of the paths above: K13 at
    (128, 64) and (512, 255), the KZG batch's two buckets; K14 and K10 over
    one 512-key committee. Each held bit-equal to its plain version there,
    timed beside it; the least time from the point operations the inputs
    need (K13: only the items and window digits that are not zero, so the
    pads count nothing) times the plain version's Fp products an operation
    (one double, one complete add of distinct points) times K8's
    instructions a product. Returns (the K13 and K14 rows, K10's aggregate shape)."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.crypto import kzg_batch
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.ops import fp

    lim = B.to_limbs(B._jacobian_words([oracle.G1_GEN_AFF, agg_in["aggregates"][0]], 0, "cpu"))
    m0 = fp.plain_muls
    B.g1_double(lim[:1])
    per_double = fp.plain_muls - m0
    B.g1_add(lim[:1], lim[1:])
    per_add = fp.plain_muls - m0 - per_double
    rng = np.random.default_rng(6)
    samples = kzg_in["samples"]
    proofs = [kzg_batch._aff(it[3]) for it in samples]
    side64 = (proofs, [int(v) for v in rng.integers(1, 2**63, len(proofs), dtype=np.int64)])
    folded = ([kzg_batch._neg(p) for p in proofs]
              + [kzg_batch._neg(kzg_batch._aff(it[0])) for it in samples]
              + [kzg_batch._aff(g) for g in kzg_in["setup"].g1[:len(samples[0][2])]])
    side255 = (folded, [int.from_bytes(rng.bytes(32), "little") % oracle.R for _ in folded])

    def msm_args(points, scalars, nbits):
        b = B._msm_pow2_pad(len(points))
        pad = b - len(points)
        return (B._jacobian_words(points + [oracle.G1_GEN_AFF] * pad, 0, dev),
                B.scalar_words(scalars + [0] * pad, nbits).to(dev), nbits)

    keys = B._jacobian_words([agg_in["keys"][pk] for pk in agg_in["calls"][0][0]], 0, dev)

    def ops_bound(doubles, adds):
        muls = doubles * per_double + adds * per_add
        return dict(point_ops=doubles + adds, fp_muls=muls,
                    bound_ms=1e3 * muls * sass_mul / LANE_INSTR_PER_S, bound_by="operations")

    shapes = []
    for label, (pts, sc) in (("n=128 nbits=64", side64), ("n=512 nbits=255", side255)):
        a = msm_args(pts, sc, 64 if "64" in label else 255)
        c = B.g1_msm_data_op_counts(a[1], a[2])
        shapes.append(("g1_msm", label, lambda a=a: B.g1_msm(*a), lambda a=a: B.g1_msm_plain(*a),
                       ops_bound(c["doubles"], c["adds"])))
    c = B.g1_ladder_op_counts(keys.shape[0], 255)
    shapes.append(("g1_subgroup", f"n={keys.shape[0]}", lambda: B.g1_subgroup_check(keys),
                   lambda: B.g1_subgroup_check_plain(keys), ops_bound(c["doubles"], c["adds"])))
    shapes.append(("point_sums", f"G1 aggregate n={keys.shape[0]} D=1",
                   lambda: B.g1_aggregate(keys),
                   lambda: B.point_sums_plain(keys, torch.tensor([0, keys.shape[0]]))[0],
                   ops_bound(0, keys.shape[0] - 1)))
    rows = {}
    with Aside():
        for name, label, kernel, plain, bound in shapes:
            want, plain_ms, _ = timed(plain)
            got = kernel()
            got, want = got.int(), want.to(got.device).int()
            err[name] = max(err[name], max_abs_err(got, want))
            require(torch.equal(got, want), f"{name} ({label}) differs from its plain version "
                    "at the main path's shape")
            ms = time_ms(kernel, 3, warmup=1)
            rows.setdefault(name, []).append(dict(shape=label, ms=ms, plain_ms=plain_ms,
                                                  **bound))
            print(f"kernel {name} ({label}): ms={ms:.5f} bound_ms={bound['bound_ms']:.6f} "
                  f"(operations: {bound['point_ops']} point ops, {bound['fp_muls']} Fp "
                  f"products) plain_ms={plain_ms:.3f}", flush=True)
    out = []
    for name, src, replaces in (
            ("g1_msm", "msm.cu", "consensus_specs_tpu/ops/bls12_jax.py:1291"),
            ("g1_subgroup", "msm.cu", "consensus_specs_tpu/ops/bls12_jax.py:1347")):
        first, *more = rows[name]
        out.append(dict(name=name, route="cuda", source=f"consensus_specs_tpu_torch/csrc/{src}",
                        replaces=replaces, launches=launches[name], max_abs_err=err[name],
                        bit_equal=err[name] == 0.0, library_ms=None,
                        ms_over_bound=first["ms"] / first["bound_ms"], **first,
                        **{r["shape"]: r for r in more}))
    return out, rows["point_sums"][0]


# the stage outputs of ops/forkchoice.py each kernel produces
FC_OUTPUTS = {"anc": "fc_ancestors", "direct": "fc_vote_weights", "weight": "fc_subtree",
              "viable": "fc_subtree", "filtered": "fc_head_walk", "head": "fc_head_walk"}


def check_fc_stages(tensors, err, label) -> dict:
    """K15-K18 through `ghost_head_stages` beside `ghost_head_parts` (the
    plain versions) on the same card tensors: every stage output bit-equal.
    Uncounted. Returns the plain parts."""
    import torch

    from consensus_specs_tpu_torch.ops import forkchoice as fco

    with Aside():
        got = fco.ghost_head_stages(*tensors)
        want = fco.ghost_head_parts(*tensors)
        torch.cuda.synchronize()
    for key, kernel in FC_OUTPUTS.items():
        err[kernel] = max(err[kernel], max_abs_err(got[key], want[key]))
        require(torch.equal(got[key], want[key]),
                f"{kernel} ({label}): {key} differs from its plain version")
    return want


def forkchoice_main_path(dev, err) -> tuple:
    """Phase 5d: the LMD-GHOST head through `ghost_head_batch` at V = 2**20,
    launch counts zeroed just before each part and read just after: (a) the
    storm tree of 512 blocks, one snapshot; (b) 8 vote-swung snapshots of it
    in one group (heads on both tips, proposer boost on every other one);
    (c) 8,192 blocks, a chain 256 epochs long without finality. Every head
    equals `host_head`, every kernel's output its plain version's; (a)'s head
    also the plain version's on CPU copies, (c) again with its first 2**16
    votes. The parts are timed warm: a first call of (a), uncounted, loads
    the library and is timed on its own. Returns (metrics, launches by
    part, {part: (tensors, plain parts)})."""
    import dataclasses

    import torch

    from consensus_specs_tpu_torch.engine import fork_choice as fce
    from consensus_specs_tpu_torch.forkchoice import host_head, synthetic
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import forkchoice as fco

    t0 = time.perf_counter()
    storm = synthetic.build_storm(FC_BLOCKS, N_MAIN)
    head_snap = storm.mirror.snapshot()
    batch = storm.perturbed(FC_BATCH, FC_SEED)
    long_storm = synthetic.build_storm(FC_LONG_BLOCKS, N_MAIN)
    long_snap = long_storm.mirror.snapshot()
    t1 = time.perf_counter()
    paths = {"head": [head_snap], "batch8": batch, "nonfinal": [long_snap]}
    oracle = {name: [host_head(s) for s in snaps] for name, snaps in paths.items()}
    print(f"fork-choice inputs: storm trees of {FC_BLOCKS} and {FC_LONG_BLOCKS} blocks, "
          f"{N_MAIN} votes, {FC_BATCH} swung snapshots in {t1 - t0:.1f} s; host_head for "
          f"{sum(map(len, paths.values()))} snapshots in {time.perf_counter() - t1:.1f} s (host)",
          flush=True)
    out, launches, shapes = {}, {}, {}
    with Aside():  # the path's first call loads the kernels' library; not counted
        _, out["fc_first_call_ms"], out["fc_first_call_wall_ms"] = timed(
            lambda: fce.ghost_head_batch(paths["head"], dev))
    for name, snaps in paths.items():
        torch.cuda.synchronize()
        build.reset_launches()
        heads, out[f"fc_{name}_ms"], out[f"fc_{name}_wall_ms"] = timed(
            lambda snaps=snaps: fce.ghost_head_batch(snaps, dev))
        launches[name] = {k: v for k, v in build.LAUNCHES.items() if v}
        require(launches[name] == dict.fromkeys(FC_KERNELS, 1),
                f"fork choice ({name}) launched {launches[name]}, not one of each of K15-K18")
        require(heads.tolist() == oracle[name],
                f"fork choice ({name}): heads {heads.tolist()} != host_head {oracle[name]}")
        [(_, _, tensors)] = fce.group_tensors(snaps, dev)
        want = check_fc_stages(tensors, err, name)
        require(want["head"][:len(snaps)].tolist() == heads.tolist(), f"{name}: plain head")
        shapes[name] = (tensors, want)
    cpu_head = fco.ghost_head_plain(*(t.cpu() for t in shapes["head"][0]))
    require(cpu_head.tolist() == oracle["head"], "the plain head on CPU copies differs")
    tips = storm.tips
    boosted = [k for k, s in enumerate(batch) if s.boost_idx >= 0]
    unboosted = [host_head(dataclasses.replace(batch[k], boost_idx=-1)) for k in boosted]
    require(set(oracle["batch8"]) == set(tips) and boosted,
            f"the batch's heads {oracle['batch8']} must flip between the tips {tips}, with "
            "a proposer boost")
    out["batch8_heads"] = oracle["batch8"]
    out["batch8_boost_flips"] = sum(oracle["batch8"][k] != h for k, h in zip(boosted, unboosted))
    small = dataclasses.replace(long_snap, votes=long_snap.votes[:FC_V_SMALL].copy(),
                                balances=long_snap.balances[:FC_V_SMALL].copy())
    with Aside():
        heads = fce.ghost_head_batch([small], dev)
    [(_, _, tensors)] = fce.group_tensors([small], dev)
    check_fc_stages(tensors, err, f"nonfinal V={FC_V_SMALL}")
    require(heads.tolist() == [host_head(small)], "the long tree's head at V = 2**16")
    out["nonfinal_depth"] = int(long_snap.slots[oracle["nonfinal"][0]])
    print(f"fork choice: head of {FC_BLOCKS} blocks = host_head = the plain head on CPU copies; "
          f"{FC_BATCH} swung snapshots' heads {oracle['batch8']} (tips {tips}; {len(boosted)} "
          f"boosted, {out['batch8_boost_flips']} of them moved by the boost); {FC_LONG_BLOCKS} "
          f"blocks: head at slot {out['nonfinal_depth']} = host_head, again at V = "
          f"{FC_V_SMALL}; K15-K18 bit-equal to their plain versions in every part", flush=True)
    return out, launches, shapes


def forkchoice_rows(shapes, launches, err) -> list:
    """K15-K18 timed beside their plain versions at the three parts' shapes.
    Least time: the bytes each input is read and each output written once
    (and, as `bound_ms_doubling`, K15's bitsets re-read at each doubling
    step), or the operations this data needs: K15's word ORs,
    K16's adds, K17's adds (one a set bit of the bitsets), K18's 10 compares a
    block plus one step a level of the walk. K16's library call:
    `index_add_` of the live votes' balances (exact int64)."""
    import torch

    from consensus_specs_tpu_torch.ops import forkchoice as fco

    def bound(ops, nbytes, **extra):
        t_ops, t_bytes = ops / LANE_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes", ops=ops,
                    bytes=nbytes, **extra)

    rows = {}
    with Aside():
        for label, (t, want) in shapes.items():
            parent, root_words, ck_epochs, ck_rids, is_real, votes, balances, idx_s, ep_s = t
            q, b = parent.shape
            v = votes.shape[1]
            w, levels = fco.n_words(b), fco.doubling_levels(b)
            anc, direct, weight, viable = (want[k] for k in ("anc", "direct", "weight", "viable"))
            bits = fco.unpack_bits(anc, b)
            set_bits = int(bits.sum())
            rows_q = torch.arange(q, device=anc.device)
            walk = int((bits[rows_q, want["head"].long()].sum(1)
                        - bits[rows_q, idx_s[:, 0].long()].sum(1)).sum())
            del bits
            live = (votes >= 0) & (votes < b)
            flat = (rows_q[:, None] * b + votes.long())[live]
            live_bal = balances[live]
            shape = f"B={b} V={v} Q={q}"
            calls = {
                "fc_ancestors": (lambda: fco.ancestors(parent), lambda: fco.ancestors_plain(parent),
                                 bound(q * levels * b * w, q * (4 * b + 4 * b * w),
                                       bound_ms_doubling=1e3 * q * (levels * 4 * b * w + 4 * b * w)
                                       / HBM_BYTES_PER_S), None),
                "fc_vote_weights": (lambda: fco.vote_weights(votes, balances, b),
                                    lambda: fco.vote_weights_plain(votes, balances, b),
                                    bound(q * v, q * (12 * v + 8 * b)),
                                    lambda: torch.zeros(q * b, dtype=torch.int64,
                                                        device=votes.device).index_add_(
                                        0, flat, live_bal)),
                "fc_subtree": (lambda: fco.subtree(anc, direct, parent, ck_epochs, ck_rids, is_real,
                                                   idx_s, ep_s),
                               lambda: fco.subtree_plain(anc, direct, parent, ck_epochs, ck_rids,
                                                         is_real, idx_s, ep_s),
                               bound(set_bits, q * (4 * b * w + 37 * b + 48) + q * 9 * b), None),
                "fc_head_walk": (lambda: fco.head_walk(anc, weight, viable, parent, root_words,
                                                       is_real, idx_s),
                                 lambda: fco.head_walk_plain(anc, weight, viable, parent,
                                                             root_words, is_real, idx_s),
                                 bound(q * 10 * b + walk, q * (82 * b + 16) + q * (b + 4)), None),
            }
            for name, (kernel, plain, bnd, library) in calls.items():
                plain_ms = time_ms(plain, 1)
                ms = time_ms(kernel, 20)
                library_ms = time_ms(library, 20) if library else None
                if library:
                    require(torch.equal(library().view(q, b), direct), "index_add_ != K16's plain")
                rows.setdefault(name, []).append(dict(shape=shape, part=label, ms=ms,
                                                      plain_ms=plain_ms, library_ms=library_ms,
                                                      **bnd))
                print(f"kernel {name} ({shape}): ms={ms:.5f} bound_ms={bnd['bound_ms']:.6f} "
                      f"({bnd['bound_by']}) plain_ms={plain_ms:.3f} library_ms={library_ms}",
                      flush=True)
    out = []
    for name in FC_KERNELS:
        first, *more = rows[name]
        total = sum(part.get(name, 0) for part in launches.values())
        why = (None if name == "fc_vote_weights" else
               "no PyTorch call computes ancestor bitsets, subtree sums over them, the FFG "
               "filter or the greedy walk")
        out.append(dict(name=name, route="cuda",
                        source="consensus_specs_tpu_torch/csrc/forkchoice.cu",
                        replaces="consensus_specs_tpu/ops/forkchoice_jax.py:54",
                        launches=total, max_abs_err=err[name], bit_equal=err[name] == 0.0,
                        library_null_reason=why, ms_over_bound=first["ms"] / first["bound_ms"],
                        **first, **{r["shape"]: r for r in more}))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from consensus_specs_tpu_torch.crypto import bls_synthetic, msm_synthetic
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
    from consensus_specs_tpu_torch.ops import bls12 as tbls
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
    # the local memory the driver holds for the BLS kernels' stacks, outside
    # torch's allocator and so outside max_memory_allocated
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    stack = dict(limit_bytes=tbls.stack_limit())
    torch.cuda.synchronize()
    stack["reserved_bytes"] = free0 - torch.cuda.mem_get_info()[0]
    print(f"bls stack: limit {stack['limit_bytes']} B a thread, {stack['reserved_bytes']} B of "
          f"device memory reserved by the driver", flush=True)
    check_bls_kernels(dev, err)
    check_msm_kernels(dev, err)

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
          f"launches={launches} max_memory_allocated={peak} (beside it the BLS stacks' "
          f"{stack['reserved_bytes']} B held by the driver)")
    for name, count in launches.items():
        require(count > 0 or name in BLS_KERNELS + MSM_KERNELS + FC_KERNELS,
                f"the main path never launched {name}")
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

    # 5. the BLS path: the block flush, its attribution, the gossip flush, the shim
    t0 = time.perf_counter()
    bls_in = bls_synthetic.flush_inputs(seed=0)
    print(f"bls inputs: {len(bls_in[0])} block checks, {len(bls_in[1])} gossip checks, "
          f"{len(bls_in[2]['sks'])} shim keys made on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    build.reset_launches()
    bls_out = bls_main_path(dev, bls_in)
    torch.cuda.synchronize()
    bls_launches = dict(build.LAUNCHES)
    for name in BLS_KERNELS:
        require(bls_launches[name] > 0, f"the BLS path never launched {name}")
    print("bls main path: " + " ".join(f"{k}={v:.4f}" for k, v in bls_out.items()
                                       if k.endswith("_ms"))
          + f" launches={ {k: bls_launches[k] for k in BLS_KERNELS} }", flush=True)

    # 5b, 5c. the block's committee-key aggregation and the KZG batch at 128 blobs
    t0 = time.perf_counter()
    agg_in = msm_synthetic.block_aggregate_inputs(seed=0)
    t1 = time.perf_counter()
    kzg_in = msm_synthetic.kzg_inputs(seed=0)
    print(f"msm inputs: {len(agg_in['calls'])} FastAggregateVerify calls over "
          f"{len(agg_in['keys'])} keys in {t1 - t0:.1f} s, {len(kzg_in['samples'])} KZG sample "
          f"and degree-proof items in {time.perf_counter() - t1:.1f} s (host)", flush=True)
    msm_out, msm_parts = msm_main_path(dev, agg_in, kzg_in)
    msm_launches = {k: sum(part.get(k, 0) for name, part in msm_parts.items() if name != "flush")
                    for k in build.LAUNCHES}
    for name in MSM_KERNELS:
        require(msm_launches[name] > 0, f"the aggregation and KZG paths never launched {name}")
    print("msm main path: " + " ".join(f"{k}={v:.4f}" for k, v in msm_out.items()
                                       if k.endswith("_ms"))
          + f" launches={msm_parts}", flush=True)

    # 5d. the fork-choice head at V = 2**20: the storm, a batch of 8, 8,192 blocks
    fc_out, fc_parts, fc_shapes = forkchoice_main_path(dev, err)
    print("fork choice main path: " + " ".join(f"{k}={v:.4f}" for k, v in fc_out.items()
                                               if k.endswith("_ms"))
          + f" launches={fc_parts}", flush=True)

    # 6. kernels beside their plain versions at the main path's shapes
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
    sass_mul = sass_instructions("fp", "fp_ops_kernelILi0E")
    rows += bls_rows(dev, bls_in, bls_launches, err, sass_mul)
    new_rows, aggregate_row = msm_rows(dev, agg_in, kzg_in, msm_launches, err, sass_mul)
    for row in rows:
        if row["name"] == "point_sums":
            row[aggregate_row["shape"]] = dict(aggregate_row, launches=msm_launches["point_sums"])
    rows += new_rows
    rows += forkchoice_rows(fc_shapes, fc_parts, err)
    card = card_line()
    print(card)
    print(json.dumps({"kernels": rows, "main_path": {
        "n": N_MAIN, "epoch_ms": epoch_ms, "field_roots_ms": roots_ms,
        "root_refresh_ms": root_refresh_ms, "root_refresh_each_ms": refresh_ms,
        "root_refresh_wall_ms": sum(refresh_wall) / SINGLE_EPOCHS,
        "sync_rotation_ms": rotation["ms"], "sync_rotation_wall_ms": rotation["wall_ms"],
        "sync_rotation_loop_wall_ms": rotation["loop_wall_ms"], "n_active": n_rot,
        "refreshes": refreshes, "max_memory_allocated": peak, "bls_stack": stack,
        "historical_batch_root": dict(ms=hist_ms, plain_ms=hist_plain_ms, hashes=hist_hashes,
                                      **bound(sass["sha256_64b"] * hist_hashes, 2 * 8192 * 32
                                              + 32))},
        "bls_path": bls_out, "msm_path": dict(msm_out, launches=msm_parts),
        "forkchoice_path": dict(fc_out, launches=fc_parts)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
