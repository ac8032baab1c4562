#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the epoch, BLS, key-aggregation, KZG,
fork-choice, spec state-transition, light-client read and DAS paths, the
BLS flush over the RNS field, and the multi-device path, on one NVIDIA
card.

    python3 chip_smoke.py [--seed S]

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
   subgroup); K19 tree_root_batch at (K, C) = (1, 16384), (64, 1024),
   (256, 64), (1, 1) and (2, 2) (and the first against a hashlib fold); K20
   multiproof_heap and K21 multiproof_siblings at the read lane's (K, C, Q)
   = (8, 2**18, 512) and at (1, 1, 4), (2, 2, 8), (4, 64, 16) with shallow
   queries only, and (3, 4096, 64) (two K20 launches), pad queries included;
   K24 rns_ops at all 11 op codes on 300 seeded residue vectors with the
   field's edges (0, 1, p, 2p, -1, -p, R, 3p - 1), sum_stack over 1, 3 and 8
   rows, mont_reduce also on wide products and on 127 inputs whose q lies
   next to M_A/4 (the float32 alpha's boundary); K9-K12's RNS instances (one
   warp an item over csrc/fp_rns.cuh) at 4 items, each bit-equal to the RNS
   plain version (z = 0, 1, 2^64 - 1, an empty segment); K25 f12_product over the 8
   Miller values of the K8-K12 check, and K3's epoch_combine over 4 ranks'
   vectors at its three stages;
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
5e. the spec's own `state_transition` (`spec_main_path`): the port's
   compiled altair mainnet spec, routed through the port's bridge
   (`engine/routing.routed_spec`) with `get_total_active_balance` memoized
   (`memoized_total_active_balance`), the BLS shim on the card, N = 2**20
   validators with real keys (`testlib/big_state`, secret key i + 1) at slot
   8188; a proposer state builds and signs the blocks of slots 8189-8193
   (RANDAO reveal, a full sync aggregate of 512, two attestation committees
   of 512 from the slot before) and an importer state applies each with
   `state_transition(..., validate_result=True)` under
   `deferred_verification()`, one flush a block. Slot 8191 -> 8192 crosses
   epoch 256: the historical append (K19), the eth1 reset and the
   sync-committee rotation (K4, K5, KeyValidate, K10). Launch counts are
   zeroed before the first block and read after the last (K19, K3, K4,
   K5, K10, K11, K12 must have run). Then, uncounted: the importer's device
   epoch equals the plain epoch on CPU copies of its input, the appended
   root equals `historical_batch_root` and a hashlib fold, the new sync
   committee's aggregate key equals [sum sk]·G1, the device-assembled state
   root (`assemble_state_root` over `field_roots`) equals the port ssz's
   root, and a tampered twin (one sync-aggregate signature altered) is
   rejected by its flush. It prints `spec_block_ms`, `spec_root_ms`,
   `spec_epoch_ms` with the bridge's stages, and the host set-up times;
5f. the light-client read lane (`proof_main_path`) beside phase 4's
   resident loop (N = 2**20): a ProofService over the loop's six uint64
   columns (balances, effective_balance, inactivity_scores, activation_epoch,
   activation_eligibility_epoch, exit_epoch; 2**18 chunks each), the proof
   bench's queries (`proofs/lane`: RandomState(2302), 341 distinct leaves a
   column, round-robin, 2,046 in all) in flushes of 512 through the port's
   Scheduler, MerkleWorkClass, `multiproof_batch`, K20 and K21. Three
   rounds: cold, then an epoch, `note_epoch(loop.dirty_columns())` and a
   warm round, twice. Launch counts are zeroed before the first round and
   read after the last. Every branch of every round verifies against its
   column's root (the port's host `merkleize_chunks`), 8 a round equal
   `build_chunk_proof`; the hits, misses and invalidations must be what
   `dirty_columns()` implies, no dispatch degraded, the breaker closed, one
   device dispatch a flush, and K20/K21 launched 2 and 1 times a flush. It
   prints the round times, the median flush by stage (provider read, pack,
   device by CUDA events, unpack; spans of an installed tracer),
   `proofs_per_s_warm`, `proof_p99_request_ms` (exact, from the latency
   each prove_many call's queries observed in the lane's
   `proof_request_latency_seconds`, beside its max and the histogram's
   bucket-interpolated p99), the hit ratio and the busy share;
5g. the DAS erasure-coding lane (`das_main_path`) through the port's
   compiled das mainnet spec (`build_spec("das", "mainnet")`, its
   `das_kernels` on the card): (a) `extend_data` on one slot's blobs,
   INITIAL_ACTIVE_SHARDS = 64 of 16,384 points each
   (`testlib/blobs.slot_blobs`, RandomState(--seed)), launch counts zeroed
   before and read after (K22 twice and K23 four times a blob); every first
   half equals its data, and the slot's 64 extension NTTs again as one
   (64, 32,768) K22 call equal K22's plain version on the card and the
   spec's second halves; one blob's (1, 16,384) inverse and (1, 32,768)
   forward NTT and K23 at M = 32,768 equal their plain versions; (b)
   `reconstruct_extended_data` of blob 0 with 256 of its 4,096 samples
   withheld (2,048 points; withholding stops there because the zero
   polynomial stays on the host and is quadratic), counted (K22 six times),
   equal to (a)'s extension; twins with one value altered and with 2,049
   samples withheld must raise AssertionError; (c) `sample_data` and
   `verify_sample` of a 16-point blob with `kzg.insecure_test_setup` (host
   KZG; the spec's `ifft` on K22), and a forged sample refused. It prints
   `das_extend_ms` (the median blob), `das_extend_slot_ms`,
   `das_recover_ms` with its stages (host zero polynomial, NTT calls by
   host wall and by CUDA events, host pointwise and layout) and the busy
   shares (CUDA-event device time over the wall);
5h. phase 5's BLS flushes over the RNS field backend
   (`ops/bls12.set_field_backend("rns")`: K9-K12's RNS instances, one warp
   an item), launch counts zeroed before and read after: the block, the
   block with phase 5's bad signature, the gossip aggregates, the gossip
   batch with phase 5's bad item (the per-item pass must name it, as the
   limb path's does), the shim's 20 calls and their bad twin; every verdict,
   flush record and Miller-loop count equal to phase 5's, the four RNS
   instances launched, no limb K8-K12 launch, and K24 at most the
   conversions (the packing is on the host: none). It prints
   `bls_block_flush_rns_ms` and `bls_gossip_flush_rns_ms` (CUDA events and
   host wall; the block's after one uncounted first flush, which is timed on
   its own as `bls_block_flush_rns_first_ms` with its cudaMalloc calls and
   garbage-collector passes beside the warm flush's), launches by kernel and
   part, K24's a flush, the busy share from uncounted reruns under
   torch.profiler (the kernels' device time over the counted flush's host
   wall), and the phase's own time;
5i. the multi-device path (`mesh_main_path`: consensus_specs_tpu_torch/
   parallel driven by `testlib/mesh_workers.mesh_path`): every kernel is
   built before any rank starts; (a) world size 1 on NCCL in this process
   (`init_process_group("nccl", store=HashStore())`), (b) 4 gloo ranks
   spawned on this one card (`testlib/ranks.run_ranks`), (c) the (2, 2)
   `global_epoch_mesh` over those ranks. Each runs `g1_mesh_sum` over 2**20
   keys [k_i]·G1 made on the card by K9 from seeded 64-bit k_i, the
   ungrouped (`pairing_check_rlc_mesh`, P2 = -G1) and grouped
   (`pairing_check_rlc_grouped_mesh`, 64 messages) checks of phase 5's 1,024
   gossip checks, valid and with phase 5's bad item, three sharded epochs
   over phase 4's registry at N = 2**20 (the first timed apart: it pays the
   gathers' first buffers), one over the ejections-and-queue edge
   state at N = 2**16, and (c) one epoch on the (2, 2) mesh; launch counts
   zeroed before and read after each part (K9-K12 and K25 in every check,
   K3 once and epoch_combine three times an epoch). Every sum equals the
   single-device K10 sum and the oracle's [sum k_i mod r]·G1, every verdict
   the single-device `pairing_check_rlc`'s, every state K3's (sha256 digests
   of the gathered state), on every rank. It prints `mesh_g1_sum_ms`,
   `mesh_rlc_ms`, `mesh_rlc_grouped_ms` and `mesh_epoch_ms` for each world
   size (CUDA events around each part, the host wall of its gathers apart);
   the four ranks share the card's SMs, so their numbers say nothing about
   scaling;
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
   needs, and K16 beside `index_add_`; K19 at the historical append's
   (1, 16384) (the epoch's own vectors) and the Merkle lane's (64, 1024)
   and (256, 64), its least time K*(C-1) hashes of K1's SASS instructions;
   K20 and K21 on the read lane's first flush (8 trees of 2**18 chunks, 512
   queries), bit-equal to their plain versions there, K20's least time
   K*(C-1) hashes of K1's SASS instructions, K21's its rows read and written
   once, K21 beside `index_select` over the rows it gathers; K22 at the
   DAS lane's (64, 32,768) forward, (1, 16,384) inverse and (1, 32,768)
   forward, and K23's product at M = 32,768 and its inverse there, their
   least time from (n/2)·log2 n Fr products (plus n for the 1/n scale) or M
   products times the instructions of K23's product in its SASS, or the
   bytes read and written once; K24's mont_mul at M = 2, 256 and 1,024 and
   mont_reduce at 256, bit-equal to the plain version there, their least
   time the instructions a product needs (3,716) x M or the bytes, the
   larger, and beside it the SASS one lane executes a product and the
   kernel's own time from torch.profiler; K9-K12's RNS
   instances at the block flush's shapes (K9 at N = 256, K10 on its G2
   collapse, K11 at B = 257, K12's tail at 257), bit-equal to the RNS plain
   version there, their least time that version's Fp products x 3,716 lane
   instructions; K25 at the B phase 5i gave it
   (1,024 and 256: a rank's shard of the ungrouped check at world 1 and 4;
   64 and 16: its groups) on the flush's Miller values, bit-equal to its
   plain version there, its least time the plain version's Fp products
   times K8's product instructions; epoch_combine at 1 and 4 ranks, its
   least time the vectors' bytes.

The last three lines are the card, one JSON object with a row per kernel,
and the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import math
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
SPEC_N = 1 << 20        # the spec phase's registry
SPEC_START = 256 * 32 - 4  # the state's slot: the blocks run up to and across epoch 256
SPEC_SLOTS = (8189, 8190, 8191, 8192, 8193)
SPEC_COMMITTEES = (0, 1)  # attestation committees a block, from the slot before
SPEC_KERNELS = ("tree_root_batch", "epoch_sweep", "sha256_1block", "shuffle_rounds",
                "point_sums", "miller_loop", "final_exp")
K19_SHAPES = ((1, 16384), (64, 1024), (256, 64), (1, 1), (2, 2))
# (K, C, Q, shallow): the read lane's main shape, then the edges
MULTIPROOF_SHAPES = ((8, 1 << 18, 512, False), (1, 1, 4, False), (2, 2, 8, False),
                     (4, 64, 16, True), (3, 4096, 64, False))
PROOF_KERNELS = ("multiproof_heap", "multiproof_siblings")
PROOF_ROUNDS = 3         # cold, then two epochs each followed by a warm round
PROOF_ORACLE_CHECKS = 8  # branches a round also held against build_chunk_proof
DAS_KERNELS = ("fr_ntt", "fr_ops")
RNS_KERNELS = ("rns_ops",)
RNS_BLS_KERNELS = ("rlc_ladders_rns", "point_sums_rns", "miller_loop_rns", "final_exp_rns")
DAS_PRESET = "mainnet"   # 64 blobs of 16,384 points a slot
DAS_WITHHELD = 256       # samples withheld from the reconstructed blob (of 4,096)
DAS_SAMPLE_POINTS = 16   # the sampling part's blob: 32 points extended, 4 samples
MESH_KERNELS = ("f12_product", "epoch_combine")
MESH_WORLD = 4           # phase 5i's gloo ranks, all on the one card
MESH_KEYS = 1 << 20      # g1_mesh_sum's keys
MESH_SEED = 10           # the keys' and the mesh flushes' scalars
MESH_EPOCHS = 3          # sharded epochs over phase 4's registry: a first, two timed
MESH_EDGE_N = 1 << 16    # the sharded edge state (ejections and a queue, both past churn)
MESH_F12_SHAPES = (1024, 256, 64, 16)  # K25's B: a rank's shard at world 1 and 4


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
    require(len(sections) == 1, f"SASS of {kernel} not found in {name} (functions: "
            f"{[sec.split(None, 1)[0] for sec in sass.split('Function : ')[1:]][:40]})")
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
    got, plain = B.f12_product(m), B.f12_product_plain(m)
    err["f12_product"] = max_abs_err(got, plain)
    require(torch.equal(got, plain), "K25 f12_product differs from its plain version")
    cube = B.f12_from_words(B.pairing_cube_batch(q[:2], pks[:2]))
    for i, c in enumerate(cube):
        e = oracle.pairing(hs[i], B.affine_from_words(pks[i:i + 1], False)[0])
        require(c == oracle.f12_mul(oracle.f12_sqr(e), e), "pairing cube != oracle")
    print(f"check K8-K12, K25: {n} items bit-equal to the plain versions (K8 all 7 ops with 0, "
          f"1, p-1, R mod p; K9 both G1 forms with z = 1, 2^64-1; K10 with an empty segment; K12 "
          f"batch, batch with m2, tail; K25 over the 8 Miller values); 2 pairing cubes = oracle",
          flush=True)


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


def shim_flushes(dev, shim) -> dict:
    """The port's BLS shim over 20 byte-level calls (16 Verify, a
    FastAggregateVerify of 4 keys, an AggregateVerify of 2, 4 Verify)
    flushed once on `dev`, then 16 with a bad signature at 9, which must
    raise for check 9."""
    from consensus_specs_tpu_torch.crypto import bls, bls_torch

    out = {}
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
    return out


def with_bad_item(checks, at):
    """The checks with item `at` carrying item at + 1's signature."""
    from consensus_specs_tpu_torch.crypto import bls_torch

    bad = list(checks)
    bad[at] = bls_torch.QueuedCheck(checks[at].p1, checks[at].q1, checks[at].p2,
                                    checks[at + 1].q2)
    return bad


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
    out["block_bad_at"] = bad_at = len(block) // 2 + 1
    bad = with_bad_item(block, bad_at)
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
    out["gossip_bad_at"] = at = len(gossip) // 2
    bad = with_bad_item(gossip, at)
    p1s, q1s, p2s, q2s = ([getattr(c, k) for c in bad] for k in ("p1", "q1", "p2", "q2"))
    require(not bls_torch._device_check_all(p1s, q1s, p2s, q2s, dev),
            "the gossip batch with a bad item passed the randomized check")
    out.update(shim_flushes(dev, shim))
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


class HostCosts:
    """While active: the caching allocator's cudaMalloc calls (the growth of
    its `segment.all.allocated` count) and Python's garbage-collector passes
    with their host time; the parts of a flush's first-use cost that a count
    can name."""

    def __enter__(self):
        import gc

        import torch

        self.gc_ms, self.gc_passes, self._t0 = 0.0, 0, None
        self._malloc0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        gc.callbacks.append(self._gc)
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.gc_ms += 1e3 * (time.perf_counter() - self._t0)
            self.gc_passes += 1

    def __exit__(self, *exc):
        import gc

        import torch

        gc.callbacks.remove(self._gc)
        self.cuda_mallocs = (torch.cuda.memory_stats().get("segment.all.allocated", 0)
                             - self._malloc0)
        return False

    def summary(self) -> dict:
        return dict(cuda_mallocs=self.cuda_mallocs, gc_passes=self.gc_passes, gc_ms=self.gc_ms)


def rns_residues(rng, n, dev):
    """n seeded Montgomery values as RNS residues, the field's edges first:
    0, 1, p, 2p, values standing for -1 and -p, R mod p, 3p - 1."""
    import torch

    from consensus_specs_tpu_torch.ops import fp_rns

    p, ma, mab = fp_rns.P, fp_rns.M_A, fp_rns.M_A * fp_rns.M_B
    vals = [int.from_bytes(rng.bytes(48), "little") % p * ma % p for _ in range(n)]
    edges = [0, 1, p, 2 * p, -1, -p, fp_rns.R_MOD_P, 3 * p - 1]
    vals[:min(n, len(edges))] = edges[:n]
    return torch.from_numpy(np.stack([fp_rns._residues(v % mab, fp_rns._PRIMES)
                                      for v in vals])).to(dev)


def alpha_boundary_inputs(dev):
    """mont_reduce inputs whose q = -t·p^-1 mod M_A lies next to M_A/4, where
    the first extension's float32 alpha decides a floor."""
    import torch

    from consensus_specs_tpu_torch.ops import fp_rns

    p, ma = fp_rns.P, fp_rns.M_A
    qs = [ma // 4 + k for k in range(-60, 61)]
    qs += [ma // 4 + int(ma * f) for f in (2**-20, -2**-20, 2**-23, -2**-23, 2**-25, -2**-25)]
    return torch.from_numpy(np.stack([fp_rns._residues((-q * p) % ma, fp_rns._PRIMES)
                                      for q in qs])).to(dev)


def check_rns_kernel(dev, err: dict) -> None:
    """K24 bit-equal to its plain version on the card at every op code: 300
    seeded residue vectors with the field's edges, sum_stack over 1, 3 and 8
    rows, mont_reduce also on wide products and on inputs at the alpha
    boundary, and M = 0 launching nothing."""
    import torch

    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import fp_rns as R

    rng = np.random.default_rng(24)
    a, b = rns_residues(rng, 300, dev), rns_residues(rng, 300, dev).flip(0)
    cases = []
    for op in range(len(R.OP_NAMES)):
        if op == R.OP_SUM_STACK:
            cases += [(op, (torch.stack([a, b] * 4)[:k],)) for k in (1, 3, 8)]
        elif op in R._BINARY:
            cases.append((op, (a, b)))
        elif op == R.OP_MONT_REDUCE:
            wide = R.rns_ops(R.OP_MUL_WIDE, a, b)
            cases.append((op, (torch.cat([a, wide, alpha_boundary_inputs(dev)]),)))
        else:
            cases.append((op, (a,)))
    for op, args in cases:
        got = R.rns_ops(op, *args)
        plain = R.rns_ops_plain(op, *args)
        err["rns_ops"] = max(err["rns_ops"], max_abs_err(got.int(), plain.int()))
        require(torch.equal(got, plain), f"K24 rns_ops {R.OP_NAMES[op]} differs from its plain "
                "version")
    before = build.LAUNCHES["rns_ops"]
    require(R.rns_ops(R.OP_MONT_MUL, a[:0], b[:0]).shape == (0, 64)
            and build.LAUNCHES["rns_ops"] == before, "K24 launched for M = 0")
    print(f"check K24 rns_ops: all {len(R.OP_NAMES)} op codes bit-equal to the plain version on "
          f"300 residue vectors with 0, 1, p, 2p, -1, -p, R, 3p - 1; sum_stack over 1, 3, 8 rows; "
          f"mont_reduce on wide products and 127 alpha-boundary inputs; M = 0 launches nothing",
          flush=True)


def rns_bls_items(n, seed, dev):
    """n seeded (pk, H(m), sig) over two messages as RNS residues on dev."""
    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
    from consensus_specs_tpu_torch.engine.convert import rns_from_words
    from consensus_specs_tpu_torch.ops import bls12 as B

    F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
    ks = [int(k) for k in np.random.default_rng(seed).integers(1, 2**62, n, dtype=np.int64)]
    hs = [hash_to_curve_g2(b"chip_smoke rns %d" % (i % 2)) for i in range(n)]
    pks = [oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k)) for k in ks]
    sigs = [oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k))
            for h, k in zip(hs, ks)]
    return tuple(rns_from_words(t).to(dev) for t in (B.g1_to_words(pks), B.g2_to_words(hs),
                                                     B.g2_to_words(sigs)))


def check_rns_bls_kernels(dev, err: dict) -> None:
    """K9-K12's RNS instances each bit-equal to the RNS plain version on the
    card at 4 items (seeded keys, two messages, z = 0, 1, 2^64 - 1 among the
    scalars, an empty G1 segment): K9 both G1 forms, K10 on G1 segments and
    the G2 collapse, K11, K12's batch mode (with m2) and tail."""
    import torch

    from consensus_specs_tpu_torch.crypto.bls_torch import zbits_from_ints
    from consensus_specs_tpu_torch.ops import bls12 as B

    pks, hs, sigs = rns_bls_items(4, 12, dev)
    zb = zbits_from_ints([0, 1, 2**64 - 1, 987654321987654321], dev)

    def held(name, got, plain):
        pairs = [(g, w) for g, w in zip(_outputs(got), _outputs(plain)) if g is not None]
        err[name] = max(err[name], *(max_abs_err(g, w) for g, w in pairs))
        require(all(torch.equal(g, w) for g, w in pairs),
                f"{name} differs from its plain version at 4 items")

    for affine in (True, False):
        held("rlc_ladders_rns", B.rlc_ladders(pks, sigs, zb, affine),
             B.rlc_ladders_plain(pks, sigs, zb, affine))
    g1j, g2j = B.rlc_ladders(pks, sigs, zb, affine_g1=False)
    for pts, off in ((g1j, [0, 1, 1, 4]), (g2j, [0, 4])):
        off = torch.tensor(off, device=dev)
        held("point_sums_rns", B.point_sums(pts, off), B.point_sums_plain(pts, off))
    m = B.miller_loop(hs, pks)
    held("miller_loop_rns", m, B.miller_loop_plain(hs, pks))
    held("final_exp_rns", B.final_exp_batch(m[:2], m[2:]), B.final_exp_batch_plain(m[:2], m[2:]))
    held("final_exp_rns", B.final_exp_tail(m[:-1], m[-1]), B.final_exp_tail_plain(m[:-1], m[-1]))
    print("check K9-K12 rns instances: 4 items bit-equal to the RNS plain version (K9 both G1 "
          "forms with z = 0, 1, 2^64-1; K10 G1 segments with an empty one, G2 collapse; K11; "
          "K12 batch with m2, tail)", flush=True)


def rns_main_path(dev, inputs, limb: dict) -> tuple:
    """Phase 5h: phase 5's BLS flushes under the "rns" field backend (the
    randomized check and the per-item attribution on K9-K12's RNS
    instances), launch counts zeroed just before and read just after: the
    block (131 checks, the ungrouped path), the block with phase 5's bad
    signature (attribution), the gossip aggregates (1,024 checks over 64
    messages, the grouped path), the gossip batch with phase 5's bad item (it
    fails and the per-item pass names it), the shim's 20 calls and their bad
    twin. Each verdict, flush record and Miller-loop count must be phase 5's
    ("limb"); the four RNS instances launched, no limb K8-K12 launch, no K24
    launch (the packing converts on the host). Before them, uncounted, the
    process's first RNS block flush, timed on its own with its allocator and
    garbage-collector counts (`HostCosts`, also taken on the counted block
    flush). After them, uncounted, the block and gossip flushes again under
    torch.profiler: the kernels' device time, set against the counted
    flush's host wall for the busy share (the profiler slows the host, not
    the kernels). Returns (the numbers, launches, launches by part)."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls_torch
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.profile_main_path import profile_window
    from consensus_specs_tpu_torch.utils import bucketing

    t_phase = time.perf_counter()
    block, gossip, shim = inputs
    b = bucketing.pow2_bucket(len(block), 8)
    plan = bucketing.grouped_plan([c.q1 for c in gossip], 8)
    bad_at, gat = limb["block_bad_at"], limb["gossip_bad_at"]
    bad_block, bad_gossip = with_bad_item(block, bad_at), with_bad_item(gossip, gat)
    with Aside():  # the limb verdicts of the one flush phase 5 does not run
        limb_gossip_named = np.flatnonzero(~bls_torch.run_checks(bad_gossip, dev)).tolist()
    require(limb_gossip_named == [gat], f"limb gossip attribution named {limb_gossip_named}")
    out, by_part = {}, {}
    B.set_field_backend("rns")
    try:
        # the process's first RNS flush, uncounted and timed on its own: it
        # carries a first-use cost that the flushes after it do not
        with Aside(), HostCosts() as first:
            ok, out["bls_block_flush_rns_first_ms"], out["bls_block_flush_rns_first_wall_ms"] = \
                timed(lambda: bls_torch.run_checks(block, dev))
        require(ok.all(), "the first rns block flush failed")
        out["block_first_host_costs"] = first.summary()
        torch.cuda.synchronize()
        build.reset_launches()

        def flush(part, checks):
            before, loops0 = dict(build.LAUNCHES), B.miller_loop_items
            ok, ms, wall = timed(lambda: bls_torch.run_checks(checks, dev))
            by_part[part] = {k: v - before[k] for k, v in build.LAUNCHES.items() if v > before[k]}
            out[f"{part}_miller_loops"] = B.miller_loop_items - loops0
            out[f"{part}_k24_launches"] = by_part[part].get("rns_ops", 0)
            return ok, ms, wall

        with HostCosts() as warm:
            ok, out["bls_block_flush_rns_ms"], out["bls_block_flush_rns_wall_ms"] = flush(
                "block", block)
        out["block_host_costs"] = warm.summary()
        require(ok.all() and bls_torch.LAST_FLUSH == dict(path="rlc", items=b, distinct=b,
                                                          miller_loops=b + 1)
                and out["block_miller_loops"] == limb["block_miller_loops"] == b + 1,
                f"rns block flush: {int(ok.sum())} ok, {bls_torch.LAST_FLUSH}, "
                f"{out['block_miller_loops']} Miller loops")
        ok, out["bls_attribution_rns_ms"], out["bls_attribution_rns_wall_ms"] = flush(
            "attribution", bad_block)
        require(np.flatnonzero(~ok).tolist() == [bad_at]
                and out["attribution_miller_loops"] == limb["attribution_miller_loops"],
                f"rns attribution flagged {np.flatnonzero(~ok).tolist()}, not [{bad_at}]")
        ok, out["bls_gossip_flush_rns_ms"], out["bls_gossip_flush_rns_wall_ms"] = flush(
            "gossip", gossip)
        require(ok.all() and bls_torch.LAST_FLUSH == dict(path="rlc_grouped", items=plan.b_n,
                                                          distinct=plan.b_d,
                                                          miller_loops=plan.b_d + 1)
                and out["gossip_miller_loops"] == limb["gossip_miller_loops"] == plan.b_d + 1,
                f"rns gossip flush: {int(ok.sum())} ok, {bls_torch.LAST_FLUSH}")
        ok, out["bls_gossip_attribution_rns_ms"], out["bls_gossip_attribution_rns_wall_ms"] = \
            flush("gossip_attribution", bad_gossip)
        named = np.flatnonzero(~ok).tolist()
        require(named == limb_gossip_named
                and out["gossip_attribution_miller_loops"] == plan.b_d + 1 + 2 * plan.b_n,
                f"rns gossip attribution named {named}, limb {limb_gossip_named}")
        before = dict(build.LAUNCHES)
        shim_out = shim_flushes(dev, shim)
        by_part["shim"] = {k: v - before[k] for k, v in build.LAUNCHES.items() if v > before[k]}
        out["bls_shim_flush_rns_wall_ms"] = shim_out["bls_shim_flush_wall_ms"]
        out["shim_flush_rns"] = shim_out["shim_flush"]
        require(shim_out["shim_flush"] == limb["shim_flush"],
                f"rns shim flush {shim_out['shim_flush']} != limb {limb['shim_flush']}")
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        require(all(launches[k] > 0 for k in RNS_BLS_KERNELS)
                and not any(launches[k] for k in BLS_KERNELS) and launches["rns_ops"] == 0,
                f"under rns: RNS instances { {k: launches[k] for k in RNS_BLS_KERNELS} }, limb "
                f"K8-K12 { {k: launches[k] for k in BLS_KERNELS} }, K24 {launches['rns_ops']}")
        with Aside():
            for part, checks in (("block", block), ("gossip", gossip)):
                wall_us, rows = profile_window(lambda: bls_torch.run_checks(checks, dev), torch)
                wall = out[f"bls_{part}_flush_rns_wall_ms"]
                device = 1e-3 * sum(r[2] for r in rows) if rows else None
                out[f"{part}_rns_device_ms"] = device
                out[f"{part}_rns_busy_share"] = None if device is None else device / wall
                out[f"{part}_rns_profiled_wall_ms"] = 1e-3 * wall_us
    finally:
        B.set_field_backend("limb")
    out["phase_5h_s"] = time.perf_counter() - t_phase
    print(f"rns main path: block flush of {len(block)} checks ok, {out['block_miller_loops']} "
          f"Miller loops; bad signature at {bad_at} attributed; gossip flush of {len(gossip)} "
          f"over {plan.d} messages ok, {out['gossip_miller_loops']} Miller loops, its bad item "
          f"{gat} named; shim flushed once, its bad call raised; verdicts, records and Miller "
          f"counts = the limb runs'; launches by part {by_part}; K24 a flush: block "
          f"{out['block_k24_launches']}, gossip {out['gossip_k24_launches']}; no limb K8-K12 "
          f"launch; phase 5h took {out['phase_5h_s']:.1f} s", flush=True)
    return out, launches, by_part


def sass_rns_mont_mul() -> int:
    """SASS instructions one lane executes in a Montgomery product on the
    warp-wide field: the bodies of `fp_mul(rns_w)` and `rns_mont_reduce`
    (csrc/fp_rns.cuh, both `__noinline__`, their 2 x 32 shuffle steps
    unrolled), which ptxas places after the last EXIT of the mont_mul
    instance `rns_ops_kernel<5>`. NOPs are left out, and so is the branch
    to itself that follows an EXIT and is never taken. Raises if that code
    branches anywhere else, since the count then would not be the executed
    count."""
    import re

    ops = [(addr, re.sub(r"^@!?U?P[T0-9]+\s+", "", op))
           for addr, op in _sass_ops("fp_rns", "rns_ops_kernelILi5E")]
    last = max(i for i, (_, op) in enumerate(ops) if op.startswith("EXIT"))
    body = []
    for addr, op in ops[last + 1:]:
        target = re.search(r"\bBRA\s+`?\(?(0x[0-9a-f]+)", op)
        if not op.startswith("NOP") and not (target and int(target.group(1), 16) == addr):
            body.append(op)
    branches = [op for op in body if op.split(None, 1)[0].startswith(("BRA", "BRX", "JMP"))]
    require(not branches, f"K24's mont_mul is not straight-line code: {branches[:4]}")
    print(f"sass rns mont_mul a lane: {len(body)} instructions; most used "
          f"{_opcode_mix(body, 8)}", flush=True)
    return len(body)


# K24's least work, in lane instructions, from the arithmetic an RNS product
# needs rather than from the kernel's SASS: a 32 x 32-bit product, or a 64-bit
# multiply-accumulate, is one instruction (IMAD.WIDE.U32); a word reduced by a
# 15-bit prime four (Barrett: a multiply-high, a multiply-subtract, a compare,
# a select); a sum of two residues reduced three (add, subtract, select); a
# float32 multiply or add one.
RNS_REDUCE, RNS_ADD_MOD = 4, 3


def rns_least_instructions(op: str) -> int:
    """Lane instructions one element of `op` ("mont_mul" or "mont_reduce")
    needs by RNS_REDUCE's reckoning, each operation counted once."""
    from consensus_specs_tpu_torch.ops import fp_rns

    k = fp_rns.K_PER_BASE
    mod_mul = 1 + RNS_REDUCE
    # alpha: k float products and sums, the offset and the floor; the k x k
    # multiply-accumulates; a destination channel's -alpha·M_src and reduction
    extend = 2 * k + 2 + k * k + k * (1 + RNS_REDUCE)
    reduce = (2 * k * mod_mul          # base A: q = t·(-p^-1), sigma = q·w^-1
              + extend                 # A -> B
              + k * (mod_mul + RNS_ADD_MOD + 2 * mod_mul)  # base B: q·p, + t, ·M_A^-1, ·w^-1
              + extend)                # B -> A
    return reduce + (2 * k * mod_mul if op == "mont_mul" else 0)  # mul_wide's 64 products


def rns_rows(dev, launches, err) -> list:
    """K24's row: mont_mul at M = 2, 256 and 1,024 and mont_reduce at 256 on
    seeded residues, each equal to the plain version's output on every
    channel, the plain version's time, and the least time: the instructions
    the op needs (`rns_least_instructions`) x M over the lane issue rate, or
    768 bytes an element read and written once (a mont_reduce: 512), the
    larger. Beside it, `sass_bound_ms`: the SASS one lane executes a product
    (`sass_rns_mont_mul`) x 32 lanes x M over the same rate, the floor of the
    kernel as it is written; and `device_ms`, the kernel's own time a launch
    from torch.profiler over 20 launches (`ms`, CUDA events around the
    wrapper's calls, also holds the host's issue time of each launch)."""
    import torch

    from consensus_specs_tpu_torch.ops import fp_rns as R
    from consensus_specs_tpu_torch.profile_main_path import profile_window

    sass = sass_rns_mont_mul()
    least = {name: rns_least_instructions(name) for name in ("mont_mul", "mont_reduce")}
    print(f"rns least instructions an element: {least} (RNS_REDUCE={RNS_REDUCE}); the kernel "
          f"executes {sass} a lane, {32 * sass} a warp (an element)", flush=True)
    rng = np.random.default_rng(240)
    rows = {}
    for opname, op, m in (("mont_mul", R.OP_MONT_MUL, 256), ("mont_mul", R.OP_MONT_MUL, 2),
                          ("mont_mul", R.OP_MONT_MUL, 1024),
                          ("mont_reduce", R.OP_MONT_REDUCE, 256)):
        a, b = rns_residues(rng, m, dev), rns_residues(rng, m, dev).flip(0)
        args = (a, b) if op == R.OP_MONT_MUL else (R.rns_ops(R.OP_MUL_WIDE, a, b),)
        plain, plain_ms, _ = timed(lambda: R.rns_ops_plain(op, *args))
        got = R.rns_ops(op, *args)
        err["rns_ops"] = max(err["rns_ops"], max_abs_err(got, plain))
        require(torch.equal(got, plain), f"K24 {opname} at M={m} differs from its plain version")
        nbytes = (3 if op == R.OP_MONT_MUL else 2) * m * 256
        t_ops, t_bytes = least[opname] * m / LANE_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        _, prof = profile_window(lambda: [R.rns_ops(op, *args) for _ in range(20)], torch)
        k24 = [r for r in prof if "rns_ops_kernel" in r[0]]
        rows[f"{opname} M={m}"] = dict(
            shape=f"{opname} M={m}", ms=time_ms(lambda: R.rns_ops(op, *args), 20),
            device_ms=1e-3 * sum(r[2] for r in k24) / sum(r[1] for r in k24) if k24 else None,
            plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            sass_bound_ms=1e3 * 32 * sass * m / LANE_INSTR_PER_S)
    first = rows.pop("mont_mul M=256")
    row = dict(name="rns_ops", route="cuda", source="consensus_specs_tpu_torch/csrc/fp_rns.cu",
               replaces="consensus_specs_tpu/ops/fp_rns.py:320", launches=launches["rns_ops"],
               max_abs_err=err["rns_ops"], bit_equal=err["rns_ops"] == 0.0, library_ms=None,
               library_null_reason="no PyTorch call computes an RNS Montgomery product "
               "(torch._int_mm covers only the base extensions' products)",
               least_instructions=least, sass_mont_mul_a_lane=sass, **first, **rows)
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]
    for r in [first, *rows.values()]:
        print(f"kernel rns_ops ({r['shape']}): ms={r['ms']:.5f} device_ms={r['device_ms']} "
              f"bound_ms={r['bound_ms']:.7f} ({r['bound_by']}) sass_bound_ms="
              f"{r['sass_bound_ms']:.7f} plain_ms={r['plain_ms']:.3f}", flush=True)
    print(f"kernel rns_ops: launches={row['launches']} on the main path (the RNS flush runs "
          f"K9-K12's RNS instances and packs on the host)", flush=True)
    return [row]


def rns_bls_rows(dev, inputs, launches, err) -> list:
    """K9-K12's RNS instances at the block flush's shapes (K9 at N = 256, G1
    affine and G2; K10 on the G2 collapse of those 256; K11 at B = 257; K12's
    tail at 257), on RNS residues of the flush's own points and seeded
    scalars: each output equal to the RNS plain version's on every element,
    the time, the plain version's time (on the card's tensors) and its Fp
    products (`fp_rns.plain_muls`) on the same inputs; the least time those
    products x the 3,716 lane instructions a product needs
    (`rns_least_instructions`) over the lane issue rate, or the bytes, the
    larger."""
    import torch

    from consensus_specs_tpu_torch.crypto import bls_torch
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.ops import fp_rns as R

    block = inputs[0]
    cols = ([c.p1 for c in block], [c.q1 for c in block], [c.p2 for c in block],
            [c.q2 for c in block])
    B.set_field_backend("rns")
    try:
        b, (q1, p1, q2, _) = bls_torch._pack_pairing_args(*cols, dev)
    finally:
        B.set_field_backend("limb")
    zb = bls_torch.zbits_from_ints(np.random.default_rng(4).integers(1, 2**64, b,
                                                                     dtype=np.uint64), dev)
    a1, zsig = B.rlc_ladders(p1, q2, zb)
    whole = torch.tensor([0, b], device=dev)
    aq = B.point_sums(zsig, whole)
    mq = torch.cat([q1, aq])
    mp = torch.cat([a1, B.neg_g1_words(dev, R.NLIMBS)[None]])
    m = B.miller_loop(mq, mp)
    least = rns_least_instructions("mont_mul")
    specs = [
        ("rlc_ladders_rns", "rlc.cu", "consensus_specs_tpu/ops/bls12_jax.py:782",
         f"N={b} G1 affine + G2", lambda: B.rlc_ladders(p1, q2, zb),
         lambda: B.rlc_ladders_plain(p1, q2, zb),
         (p1.numel() + q2.numel() + zb.numel() + a1.numel() + zsig.numel()) * 4),
        ("point_sums_rns", "rlc.cu", "consensus_specs_tpu/ops/bls12_jax.py:1014",
         f"G2 N={b} D=1", lambda: B.point_sums(zsig, whole),
         lambda: B.point_sums_plain(zsig, whole), (zsig.numel() + aq.numel()) * 4 + 16),
        ("miller_loop_rns", "pairing.cu", "consensus_specs_tpu/ops/bls12_jax.py:514",
         f"B={mq.shape[0]}", lambda: B.miller_loop(mq, mp), lambda: B.miller_loop_plain(mq, mp),
         (mq.numel() + mp.numel() + m.numel()) * 4),
        ("final_exp_rns", "pairing.cu", "consensus_specs_tpu/ops/bls12_jax.py:611",
         f"tail B={m.shape[0]}", lambda: B.final_exp_tail(m[:-1], m[-1]),
         lambda: B.final_exp_tail_plain(m[:-1], m[-1]), (m.numel() + 768 + 1) * 4),
    ]
    rows = []
    with Aside():
        for name, src, replaces, shape, kernel, plain, nbytes in specs:
            muls0 = R.plain_muls
            want, plain_ms, _ = timed(plain)
            muls = R.plain_muls - muls0
            got = _outputs(kernel())
            pairs = [(g, w) for g, w in zip(got, _outputs(want)) if g is not None]
            err[name] = max(err[name], *(max_abs_err(g, w) for g, w in pairs))
            require(all(torch.equal(g, w) for g, w in pairs),
                    f"{name} ({shape}) differs from its plain version at the main path's shape")
            t_ops, t_bytes = muls * least / LANE_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
            rows.append(dict(
                name=name, route="cuda", source=f"consensus_specs_tpu_torch/csrc/{src}",
                replaces=replaces, shape=shape, ms=time_ms(kernel, 3, warmup=0),
                plain_ms=plain_ms, fp_muls=muls, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                launches=launches[name], max_abs_err=err[name], bit_equal=err[name] == 0.0,
                library_ms=None, library_null_reason="no PyTorch call computes a pairing, a "
                "curve ladder or a point sum over an RNS field"))
    for row in rows:
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
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


def check_tree_root_kernel(dev, rng, err) -> None:
    """K19 bit-equal to its plain version at the historical append's shape,
    the Merkle lane's buckets and the edges; the append's shape also against
    a hashlib fold."""
    import torch

    from consensus_specs_tpu_torch.engine import state_root as troot
    from consensus_specs_tpu_torch.ops.sha256_host import merkle_root_hashlib, words_to_bytes

    for k, c in K19_SHAPES:
        chunks = rand_words(rng, (k, c, 8), dev)
        got = troot.tree_root_batch(chunks)
        plain = troot.tree_root_batch_plain(chunks)
        torch.cuda.synchronize()
        err["tree_root_batch"] = max(err["tree_root_batch"], max_abs_err(got, plain))
        require(torch.equal(got, plain), f"K19 tree_root_batch ({k}, {c}) differs from its plain "
                "version")
        if (k, c) == K19_SHAPES[0]:
            require(words_to_bytes(got[0].cpu().numpy()) == merkle_root_hashlib(
                [words_to_bytes(r) for r in chunks[0].cpu().numpy()]), "K19 root != hashlib")
    print(f"check K19 tree_root_batch: {K19_SHAPES} bit-equal, (1, 16384) = hashlib")


def spec_main_path(dev) -> tuple:
    """The spec's own `state_transition` at N = 2**20 (the port's compiled
    altair mainnet spec, routed through the port's bridge, the BLS shim on
    the card): a proposer state builds and signs each block of SPEC_SLOTS
    (RANDAO reveal, a full sync aggregate of 512, the attestations of
    SPEC_COMMITTEES from the slot before; aggregate signatures [sum sk]·H(m)),
    an importer state applies it with `state_transition(...,
    validate_result=True)` under `deferred_verification()`. Slot 8191 ->
    8192 crosses epoch 256: historical append (K19), eth1 reset, rotation.
    Launch counts are zeroed before the first block and read after the last;
    the checks after it are not counted. Returns (metrics, launches, the
    append's (1, 16384) chunks)."""
    import statistics

    import torch

    from consensus_specs_tpu_torch.compiler import build_spec
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.engine import bridge
    from consensus_specs_tpu_torch.engine import epoch as tepoch
    from consensus_specs_tpu_torch.engine import state_root as troot
    from consensus_specs_tpu_torch.engine.routing import memoized_total_active_balance, routed_spec
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops.sha256_host import merkle_root_hashlib, words_to_bytes
    from consensus_specs_tpu_torch.testlib import big_state
    from consensus_specs_tpu_torch.testlib import block as tblock

    out = {}
    spec = build_spec("altair", "mainnet", device=dev)
    bls.use_device("cuda")
    bls.bls_active = True
    t0 = time.perf_counter()
    keys = big_state.real_pubkeys(SPEC_N)
    out["key_gen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    imp = big_state.synthetic_beacon_state(spec, SPEC_N, slot=SPEC_START, pubkeys=keys)
    out["state_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec.hash_tree_root(imp)
    out["first_root_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prop = imp.copy()
    out["state_copy_s"] = time.perf_counter() - t0
    print(f"spec inputs: N={SPEC_N} real keys in {out['key_gen_s']:.1f} s, state built in "
          f"{out['state_build_s']:.1f} s, first root {out['first_root_s']:.1f} s, proposer "
          f"copy {out['state_copy_s']:.1f} s (host)", flush=True)

    stages = []  # one {stage: seconds} a bridge call, in call order

    def stage_timer(name):
        now = time.perf_counter()
        if name == "start":
            stages.append({"_last": now})
        else:
            stages[-1][name] = now - stages[-1]["_last"]
            stages[-1]["_last"] = now

    capture = {}
    block_ms, root_ms = [], []
    pre_next = bytes(imp.next_sync_committee.hash_tree_root())
    torch.cuda.synchronize()
    build.reset_launches()
    with routed_spec(spec, device=dev, stage_timer=stage_timer, capture=capture), \
            memoized_total_active_balance(spec):
        for slot in SPEC_SLOTS:
            tm = {}
            signed = tblock.propose_block(spec, prop, slot, SPEC_COMMITTEES, timings=tm)
            root_ms.append(1e3 * tm["root_s"])
            flushes0 = bls.flush_count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with bls.deferred_verification():
                spec.state_transition(imp, signed, validate_result=True)
            torch.cuda.synchronize()
            block_ms.append(1e3 * (time.perf_counter() - t0))
            require(bls.flush_count == flushes0 + 1, f"block {slot}: not one flush")
            print(f"spec block {slot}: applied in {block_ms[-1]:.1f} ms, proposer root "
                  f"{root_ms[-1]:.1f} ms", flush=True)
        launches = dict(build.LAUNCHES)
        for name in SPEC_KERNELS:
            require(launches[name] > 0, f"the spec path never launched {name}")

        # checks, uncounted: the epoch against the plain version on CPU copies,
        # the append against K1's batch root and hashlib, the rotation, and the
        # device-assembled state root against the port ssz's
        st = imp
        with Aside():
            cfg, pre, post = capture["cfg"], capture["pre"], capture["post"]
            cpu_pre = type(pre)(**{k: v.cpu() for k, v in pre.items()})
            ref, ref_aux = tepoch.process_epoch_plain(cfg, cpu_pre)
            bad = [k for k, t in post.items() if not torch.equal(t.cpu(), getattr(ref, k))]
            require(not bad and torch.equal(capture["aux"].flat().cpu(), ref_aux.flat()),
                    f"the spec path's device epoch differs from the plain epoch on {bad}")
            flags = ref_aux.flat()[:3].tolist()
            require(flags == [True, True, True],
                    f"epoch 256 must fire all three epilogues: {flags}")
            require(len(st.historical_roots) == 1, "epoch 256 must append one historical root")
            oracle = words_to_bytes(tepoch.historical_batch_root(post.block_roots,
                                                                post.state_roots).cpu().numpy())
            # the vectors as the epoch saw them (later slots overwrite rows)
            fold = hashlib.sha256(b"".join(
                merkle_root_hashlib([words_to_bytes(r) for r in v.cpu().numpy()])
                for v in (post.block_roots, post.state_roots))).digest()
            require(bytes(st.historical_roots[0]) == oracle == fold,
                    "the appended historical root differs from historical_batch_root")
            require(bytes(st.current_sync_committee.hash_tree_root()) == pre_next,
                    "the rotation did not move next_sync_committee to current")
            members = [tblock.pubkey_to_privkey(pk) - 1 for pk in st.next_sync_committee.pubkeys]
            require(bytes(st.next_sync_committee.aggregate_pubkey)
                    == big_state.aggregate_pubkey_of(members),
                    "the new sync committee's aggregate key differs from [sum sk]·G1")
            dev_st, _ = bridge.state_to_device(spec, st, dev)
            static01 = torch.from_numpy(troot.validator_static_leaves(st).view(np.int32)).to(dev)
            assembled = troot.assemble_state_root(spec, st, troot.field_roots(dev_st, static01))
            require(assembled == bytes(spec.hash_tree_root(st)),
                    "the device-assembled state root differs from the port ssz's root")
            chunks = torch.cat([post.block_roots, post.state_roots])[None].contiguous()
        # the tampered twin: the next block with one sync-aggregate signature
        # altered, the block otherwise valid; its flush must fail
        def tamper(block):
            block.body.sync_aggregate.sync_committee_signature = bls.Sign(
                1, b"tampered sync aggregate")

        with Aside():
            signed = tblock.propose_block(spec, prop, SPEC_SLOTS[-1] + 1, SPEC_COMMITTEES,
                                          edit=tamper)
            try:
                with bls.deferred_verification():
                    spec.state_transition(imp, signed, validate_result=True)
                rejected = False
            except bls.BLSVerificationError:
                rejected = True
        require(rejected, "the tampered block passed")
    epoch_stages = {k: 1e3 * v for k, v in stages[-1].items() if k != "_last"}
    out.update(spec_block_ms=statistics.median(block_ms), spec_block_each_ms=block_ms,
               spec_root_ms=statistics.median(root_ms), spec_root_each_ms=root_ms,
               spec_epoch_ms=sum(epoch_stages.values()), spec_epoch_stages_ms=epoch_stages,
               tampered_rejected=rejected)
    print(f"spec path check: epoch 256's device post-state = plain epoch (CPU); historical "
          f"root = historical_batch_root = hashlib; rotation's aggregate = [sum sk]·G1; "
          f"assembled state root = ssz root; {len(SPEC_SLOTS)} blocks' signatures passed, "
          f"the tampered twin rejected", flush=True)
    return out, launches, chunks


def check_multiproof_kernels(dev, rng, err) -> None:
    """K20 and K21 bit-equal to their plain versions at the read lane's main
    shape and at the edges: one leaf, two leaves, shallow queries (root and
    interior nodes only) and a depth that takes two K20 launches."""
    import torch

    from consensus_specs_tpu_torch.ops import multiproof as tmp

    for k, c, q, shallow in MULTIPROOF_SHAPES:
        chunks = rand_words(rng, (k, c, 8), dev)
        tree_ids = torch.from_numpy(rng.integers(0, k, q).astype(np.int32)).to(dev)
        top = min(2 * c, 16) if shallow else 2 * c
        gidx = rng.integers(1 if shallow else c, top, q).astype(np.int32)
        gidx[0] = 1  # a pad query: the root of tree 0
        tree_ids[0] = 0
        gidx = torch.from_numpy(gidx).to(dev)
        d = max((c - 1).bit_length(), 1)
        heap = tmp.multiproof_heap(chunks)
        heap_plain = tmp.multiproof_heap_plain(chunks)
        got = tmp.multiproof_gather(heap, tree_ids, gidx, d)
        plain = tmp.multiproof_gather_plain(heap_plain, tree_ids, gidx, d)
        torch.cuda.synchronize()
        err["multiproof_heap"] = max(err["multiproof_heap"], max_abs_err(heap, heap_plain))
        err["multiproof_siblings"] = max(err["multiproof_siblings"],
                                         *(max_abs_err(a, b) for a, b in zip(got, plain)))
        require(torch.equal(heap, heap_plain),
                f"K20 multiproof_heap ({k}, {c}) differs from its plain version")
        require(all(torch.equal(a, b) for a, b in zip(got, plain)),
                f"K21 multiproof_siblings ({k}, {c}, {q}) differs from its plain version")
    print(f"check K20 multiproof_heap, K21 multiproof_siblings: (K, C, Q, shallow) "
          f"{MULTIPROOF_SHAPES} bit-equal to the plain versions")


def first_flush_inputs(cls, loop, queries, dev) -> tuple:
    """The kernel inputs of the read lane's first flush, taken before it
    runs: the first slice's requests as ProofService submits them on a cold
    cache (one chunk tuple a column), packed by `MerkleWorkClass.pack`."""
    import torch

    from consensus_specs_tpu_torch.proofs import lane
    from consensus_specs_tpu_torch.sched import Request

    first = queries[:lane.FLUSH]
    cols = {c: tuple(map(bytes, lane.column_chunks(loop, c))) for c, _ in first}
    reqs = [Request(work_class="merkle", kind="multiproof", payload=(cols[c], g))
            for c, g in first]
    n_chunks = loop.state.balances.shape[0] // 4
    words, tree_ids, gidx, _ = cls.pack(reqs, [(i, g) for i, (_, g) in enumerate(first)],
                                        n_chunks)
    return tuple(torch.from_numpy(a).to(dev) for a in (words.view(np.int32), tree_ids, gidx))


def weighted_quantile(values, weights, q) -> float:
    """The q-quantile of values each observed `weight` times: the smallest
    value whose cumulative weight reaches q of the total."""
    pairs = sorted(zip(values, weights))
    rank, cum = q * sum(weights), 0
    for v, w in pairs:
        cum += w
        if cum >= rank:
            return v
    return pairs[-1][0]


PROOF_STAGES = ("proofs.provider_read", "merkle.pack", "merkle.device", "merkle.unpack")


def _flush_stages(spans) -> list:
    """Per flush (a prove_many call that flushed): its wall and the seconds
    of each stage span inside it, and the device's CUDA-event time."""
    flushes, cur = [], {}
    for sp in spans:
        if sp["name"] == "proofs.prove_many":
            if cur:
                flushes.append(dict(cur, wall=sp["duration"]))
            cur = {}
        elif sp["name"] in PROOF_STAGES:
            cur[sp["name"]] = cur.get(sp["name"], 0.0) + sp["duration"]
            if sp["name"] == "merkle.device":
                cur["device_event_ms"] = (cur.get("device_event_ms", 0.0)
                                          + sp["attrs"]["device_event_ms"])
    return flushes


def proof_main_path(dev, loop) -> tuple:
    """Phase 5f, the read lane (see the module docstring): three rounds of
    the proof bench's queries through ProofService -> Scheduler ->
    MerkleWorkClass -> multiproof_batch -> K20 + K21, beside the resident
    loop, whose dirty columns invalidate the cache between rounds. Returns
    (the lane's numbers, its K20/K21 launches, the first flush's kernel
    inputs)."""
    import statistics

    import torch

    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.obs import metrics as tmetrics
    from consensus_specs_tpu_torch.obs import trace as ttrace
    from consensus_specs_tpu_torch.ops import multiproof as tmp
    from consensus_specs_tpu_torch.proofs import ProofService, lane
    from consensus_specs_tpu_torch.sched import MerkleWorkClass, Scheduler
    from consensus_specs_tpu_torch.ssz.merkle import merkleize_chunks
    from consensus_specs_tpu_torch.ssz.proofs import build_chunk_proof, is_valid_merkle_branch

    reg = tmetrics.MetricsRegistry()
    cls = MerkleWorkClass(device=dev)
    sched = Scheduler(classes=[cls], registry=reg)
    svc = ProofService(scheduler=sched, registry=reg)
    lane.register_loop_columns(svc, loop)
    n_chunks = loop.state.balances.shape[0] // 4
    depth = (n_chunks - 1).bit_length()
    queries = lane.build_queries(n_chunks, lane.QUERIES)
    slices = [queries[i:i + lane.FLUSH] for i in range(0, len(queries), lane.FLUSH)]
    k20_a_flush = -(-depth // tmp.HEAP_FOLD_MAX_LEVELS)
    print(f"read lane: N={loop.state.balances.shape[0]}, {len(lane.COLUMNS)} columns of "
          f"{n_chunks} chunks, {len(queries)} distinct leaf queries (RandomState"
          f"({lane.SEED}), round-robin) in flushes of {lane.FLUSH}, {PROOF_ROUNDS} rounds, "
          f"from epoch {loop.epoch}", flush=True)

    def totals(series):
        return sum(reg.counters_matching(series).values())

    inputs = first_flush_inputs(cls, loop, queries, dev)
    tracer = ttrace.Tracer(registry=reg, max_spans=1 << 16).install()
    rounds, flushes_expected = [], 0
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        for r in range(PROOF_ROUNDS):
            dirty, dropped, want_dropped = None, 0, 0
            if r:
                loop.step_epoch()
                loop.flush()
                dirty = loop.dirty_columns()
                cached = {c: len(svc.cache.entries(c)) for c in lane.COLUMNS}
                want_dropped = sum(n for c, n in cached.items() if dirty[c])
                dropped = svc.note_epoch(dirty)
            stale = {c for c in lane.COLUMNS if r == 0 or dirty[c]}
            want_flushes = sum(1 for s in slices if any(c in stale for c, _ in s))
            want_hits = sum(1 for c, _ in queries if c not in stale)
            hits0, misses0 = totals("proof_cache_hits_total"), totals("proof_cache_misses_total")
            wall0 = time.perf_counter()
            branches = lane.prove_round(svc, queries)
            wall = time.perf_counter() - wall0
            hits = totals("proof_cache_hits_total") - hits0
            misses = totals("proof_cache_misses_total") - misses0
            require(dropped == want_dropped,
                    f"round {r}: {dropped} branches invalidated, the dirty columns held "
                    f"{want_dropped}")
            require(hits == want_hits and misses == len(queries) - want_hits,
                    f"round {r}: {hits} hits, {misses} misses; dirty_columns() implies "
                    f"{want_hits} hits")
            flushes_expected += want_flushes
            # every branch against its column's root (uncounted host work)
            verify0 = time.perf_counter()
            chunks = {c: lane.column_chunks(loop, c) for c in lane.COLUMNS}
            roots = {c: merkleize_chunks(ch) for c, ch in chunks.items()}
            for (c, g), br in zip(queries, branches):
                i = g - n_chunks
                require(len(br) == depth and is_valid_merkle_branch(
                    chunks[c][i], br, depth, i, roots[c]),
                    f"round {r}: the branch of {c} leaf {i} does not verify")
            picks = [(j * len(queries)) // PROOF_ORACLE_CHECKS + r
                     for j in range(PROOF_ORACLE_CHECKS)]
            for j in picks:
                c, g = queries[j]
                require(list(branches[j]) == build_chunk_proof(chunks[c], g),
                        f"round {r}: the branch of query {j} differs from build_chunk_proof")
            verify_s = time.perf_counter() - verify0
            rounds.append(dict(round=r, wall_ms=1e3 * wall, flushes=want_flushes, hits=hits,
                               misses=misses, invalidated=dropped,
                               dirty=sorted(stale) if r else None, verify_s=verify_s))
            print(f"read lane round {r}: {1e3 * wall:.4f} ms, {want_flushes} flushes, {hits} "
                  f"hits, {misses} misses, {dropped} invalidated"
                  + (f", dirty {sorted(stale)}" if r else "")
                  + f"; {len(queries)} branches verified against the column roots, "
                  f"{PROOF_ORACLE_CHECKS} = build_chunk_proof ({verify_s:.1f} s)", flush=True)
        torch.cuda.synchronize()
        launches = {k: build.LAUNCHES[k] for k in ("multiproof_heap", "multiproof_siblings")}
        spans = tracer.spans()
    finally:
        tracer.uninstall()
    degraded = reg.counter_value("sched_degraded_total", work_class="merkle")
    device_dispatch = reg.counter_value("sched_dispatch_total", work_class="merkle",
                                        path="device")
    require(degraded == 0 and sched.breaker("merkle").state == "closed",
            f"read lane degraded {degraded} dispatches, breaker {sched.breaker('merkle').state}")
    require(device_dispatch == flushes_expected,
            f"{device_dispatch} device dispatches for {flushes_expected} flushes")
    require(launches == {"multiproof_heap": k20_a_flush * flushes_expected,
                         "multiproof_siblings": flushes_expected},
            f"K20/K21 launches {launches} for {flushes_expected} flushes")
    flushes = _flush_stages(spans)
    require(len(flushes) == flushes_expected, f"{len(flushes)} flush spans")
    med = {name: 1e3 * statistics.median(f.get(name, 0.0) for f in flushes)
           for name in PROOF_STAGES + ("wall",)}
    device_ms = statistics.median(f["device_event_ms"] for f in flushes)
    warm = [x["wall_ms"] for x in rounds[1:]]
    # p99 exactly: every query of a prove_many call observes that call's
    # latency, so weight each call's latency by its query count (the
    # histogram's buckets only bound it)
    hist = reg.histogram("proof_request_latency_seconds")
    calls = [sp["attrs"] for sp in spans if sp["name"] == "proofs.prove_many"]
    lat = [a["request_latency_s"] for a in calls]
    n_q = [a["queries"] for a in calls]
    require(sum(n_q) == hist.count == PROOF_ROUNDS * len(queries)
            and math.isclose(sum(t * n for t, n in zip(lat, n_q)), hist.sum, rel_tol=1e-9),
            f"{sum(n_q)} queries in the prove_many spans, {hist.count} latency observations")
    busy = sum(f["device_event_ms"] for f in flushes) / sum(x["wall_ms"] for x in rounds)
    out = dict(
        proof_cold_round_ms=rounds[0]["wall_ms"], proof_warm_round_ms=min(warm),
        proof_warm_round_each_ms=warm, proof_flush_ms=med["wall"],
        proof_flush_stages_ms=dict(provider_read=med["proofs.provider_read"],
                                   pack=med["merkle.pack"], device_wall=med["merkle.device"],
                                   device_events=device_ms, unpack=med["merkle.unpack"]),
        proof_flush_each_ms=[1e3 * f["wall"] for f in flushes],
        proofs_per_s_warm=len(queries) / (min(warm) / 1e3),
        proof_p99_request_ms=1e3 * weighted_quantile(lat, n_q, 0.99),
        proof_p50_request_ms=1e3 * weighted_quantile(lat, n_q, 0.50),
        proof_max_request_ms=1e3 * max(lat), proof_p99_request_ms_buckets=1e3 * hist.p99(),
        proof_cache_hit_ratio=reg.gauge_value("proof_cache_hit_ratio"),
        proof_busy_share=busy, queries=len(queries), columns=len(lane.COLUMNS),
        chunks_per_column=n_chunks, flushes=flushes_expected, rounds=rounds,
        sched_dispatch_device=device_dispatch, sched_degraded=degraded,
        breaker=sched.breaker("merkle").state)
    return out, launches, inputs


def multiproof_rows(inputs, launches, err, sass_sha, bound) -> list:
    """K20 and K21 at the read lane's main shape (the first flush's inputs:
    8 trees of 2^18 chunks, 512 queries), each held bit-equal to its plain
    version on the same tensors, beside its bound and, for K21, one
    `index_select` over the rows it gathers."""
    import torch

    from consensus_specs_tpu_torch.ops import multiproof as tmp

    words, tree_ids, gidx = inputs
    k, c, q = words.shape[0], words.shape[1], gidx.shape[0]
    d = max((c - 1).bit_length(), 1)
    heap = tmp.multiproof_heap(words)
    heap_plain = tmp.multiproof_heap_plain(words)
    got = tmp.multiproof_gather(heap, tree_ids, gidx, d)
    plain = tmp.multiproof_gather_plain(heap, tree_ids, gidx, d)
    torch.cuda.synchronize()
    err["multiproof_heap"] = max(err["multiproof_heap"], max_abs_err(heap, heap_plain))
    err["multiproof_siblings"] = max(err["multiproof_siblings"],
                                     *(max_abs_err(a, b) for a, b in zip(got, plain)))
    require(torch.equal(heap, heap_plain) and all(torch.equal(a, b) for a, b in zip(got, plain)),
            "K20/K21 differ from their plain versions on the read lane's flush")
    flat = heap.reshape(-1, 8)
    idx = tmp.gather_rows_index(tree_ids, gidx, k, c, d)
    require(torch.equal(flat.index_select(0, idx)[:q * d].reshape(q, d, 8), got[0]),
            "index_select over K21's rows differs from K21")
    rows_out = q * d + q + k
    shape = f"K={k} C={c} Q={q} D={d}"
    common = dict(route="cuda", source="consensus_specs_tpu_torch/csrc/multiproof.cu", shape=shape)
    k20 = dict(name="multiproof_heap", replaces="consensus_specs_tpu/ops/multiproof_jax.py:29",
               **common, ms=time_ms(lambda: tmp.multiproof_heap(words), 20),
               plain_ms=time_ms(lambda: tmp.multiproof_heap_plain(words), 2),
               library_ms=None, library_null_reason="no PyTorch call hashes",
               hashes=k * (c - 1), **bound(sass_sha * k * (c - 1), 32 * k * c + 32 * k * 2 * c))
    k21 = dict(name="multiproof_siblings", replaces="consensus_specs_tpu/ops/multiproof_jax.py:29",
               **common, ms=time_ms(lambda: tmp.multiproof_gather(heap, tree_ids, gidx, d), 50),
               plain_ms=time_ms(lambda: tmp.multiproof_gather_plain(heap, tree_ids, gidx, d), 5),
               library_ms=time_ms(lambda: flat.index_select(0, idx), 50),
               library_note="index_select over the precomputed rows; excludes the index "
                            "arithmetic", rows=rows_out,
               **bound(0, 2 * 32 * rows_out + 8 * q))
    for row in (k20, k21):
        row.update(launches=launches[row["name"]], max_abs_err=err[row["name"]],
                   bit_equal=err[row["name"]] == 0.0)
        print(f"kernel {row['name']} ({shape}): ms={row['ms']:.5f} bound_ms={row['bound_ms']:.6f} "
              f"({row['bound_by']}) plain_ms={row['plain_ms']:.3f} library_ms={row['library_ms']} "
              f"launches {row['launches']}", flush=True)
    return [k20, k21]


class FrClock:
    """While active: a CUDA event pair around every kernel entry call (the
    C function a wrapper launches through `build.entry`: K22's log2 n stage
    grids, K23's one), and the host clock around ops/fr's `ntt_ints` and
    `inv_ints` and crypto/das's `_zero_poly`: the DAS stages' device and
    host times. Events around the whole wrapper would also count the host
    work inside it (allocations, checks) while the card waits. The events
    add a few microseconds a call."""

    def __enter__(self):
        import torch

        from consensus_specs_tpu_torch.crypto import das
        from consensus_specs_tpu_torch.kernels import build
        from consensus_specs_tpu_torch.ops import fr

        self.events, self.host = [], Counter()
        entry = build.entry

        def timed_entry(*spec):
            fn = entry(*spec)

            def launch(*args):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                rc = fn(*args)
                ev[1].record()
                self.events.append(ev)
                return rc
            return launch

        def host(name, fn):
            def wrapped(*args, **kw):
                t0 = time.perf_counter()
                res = fn(*args, **kw)
                self.host[name] += 1e3 * (time.perf_counter() - t0)
                return res
            return wrapped

        self.saved = [(build, "entry", entry), (fr, "ntt_ints", fr.ntt_ints),
                      (fr, "inv_ints", fr.inv_ints), (das, "_zero_poly", das._zero_poly)]
        build.entry = timed_entry
        fr.ntt_ints, fr.inv_ints = host("ntt_ints", fr.ntt_ints), host("inv_ints", fr.inv_ints)
        das._zero_poly = host("zero_poly", das._zero_poly)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def device_ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def das_main_path(dev, seed, err) -> tuple:
    """Phase 5g, the DAS lane (see the module docstring): (a) the compiled
    das mainnet spec's `extend_data` on one slot's seeded blobs, (b)
    `reconstruct_extended_data` of one blob with DAS_WITHHELD samples
    withheld and its two failing twins, (c) `sample_data` / `verify_sample`
    at DAS_SAMPLE_POINTS points. Returns (the lane's numbers, K22/K23
    launches by part, the kernel rows' inputs)."""
    import statistics

    import torch

    from consensus_specs_tpu_torch.compiler import build_spec
    from consensus_specs_tpu_torch.crypto import bls, kzg, kzg_shim
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import fr
    from consensus_specs_tpu_torch.testlib import blobs as tblobs

    spec = build_spec("das", DAS_PRESET, device=dev)
    n = tblobs.blob_points(spec)
    t0 = time.perf_counter()
    data = tblobs.slot_blobs(spec, seed)
    out = dict(das_inputs_s=time.perf_counter() - t0, blobs=len(data), points=n)
    # set-up: the twiddle tables of the lane's three transforms, built once
    # a process on the host (inside the first call's CUDA events otherwise)
    t0 = time.perf_counter()
    for size, inverse in ((n, True), (2 * n, False), (2 * n, True)):
        fr.twiddles(size, inverse, dev)
    out["das_twiddles_s"] = time.perf_counter() - t0
    print(f"das inputs: {len(data)} blobs of {n} points (RandomState({seed})) in "
          f"{out['das_inputs_s']:.1f} s, twiddle tables in {out['das_twiddles_s']:.2f} s "
          "(host)", flush=True)
    parts = {}

    def counted(part):
        parts[part] = {k: build.LAUNCHES[k] for k in DAS_KERNELS}

    # (a) one slot's extensions through the spec
    published, each = [], []
    torch.cuda.synchronize()
    build.reset_launches()
    with FrClock() as clock:
        wall0 = time.perf_counter()
        for blob in data:
            t0 = time.perf_counter()
            published.append(spec.extend_data(blob))
            each.append(1e3 * (time.perf_counter() - t0))
        slot_ms = 1e3 * (time.perf_counter() - wall0)
        ext_device_ms = clock.device_ms()
    counted("extension")
    require(parts["extension"] == {"fr_ntt": 2 * len(data), "fr_ops": 4 * len(data)},
            f"the extensions launched {parts['extension']}: want K22 twice and K23 four "
            "times a blob")
    require(all(spec.unextend_data(p) == b for p, b in zip(published, data)),
            "an extension's first half differs from its data")
    # the slot's extension NTTs again as one batch, held against the plain
    # version on the card and against the spec's second halves
    with Aside():
        perm = fr.bit_reverse_perm(n).to(dev)
        words = torch.from_numpy(fr.ints_to_words([v for b in data for v in b])).to(dev)
        r2 = torch.from_numpy(fr.ints_to_words([fr.R2_MOD_R])[0].copy()).to(dev)
        one = torch.from_numpy(fr.ints_to_words([1])[0].copy()).to(dev)
        mont = fr.fr_ops(fr.OP_MUL, words, r2).reshape(len(data), n, 8)[:, perm]
        coeffs = fr.ntt(mont, inverse=True)
        padded = torch.cat([coeffs, torch.zeros_like(coeffs)], dim=1).contiguous()
        full = fr.ntt(padded)
        full_plain = fr.ntt_plain(padded)
        torch.cuda.synchronize()
        err["fr_ntt"] = max(err["fr_ntt"], max_abs_err(full, full_plain))
        require(torch.equal(full, full_plain),
                f"K22 at ({len(data)}, {2 * n}) differs from its plain version")
        odd = fr.fr_ops(fr.OP_MUL, full[:, 1::2].reshape(-1, 8).contiguous(), one)
        odd = odd.reshape(len(data), n, 8)[:, perm]
        want = torch.from_numpy(fr.ints_to_words([v for p in published for v in p[n:]])).to(dev)
        require(torch.equal(odd.reshape(-1, 8), want),
                "the batched extension differs from the spec's second halves")
        for x, inverse in ((mont[:1].contiguous(), True), (padded[:1].contiguous(), False)):
            got, plain = fr.ntt(x, inverse), fr.ntt_plain(x, inverse)
            err["fr_ntt"] = max(err["fr_ntt"], max_abs_err(got, plain))
            require(torch.equal(got, plain), f"K22 at (1, {x.shape[1]}) differs from its plain "
                    "version")
        conv = words[:2 * n].contiguous()
        for op, b in ((fr.OP_MUL, r2), (fr.OP_MUL, one), (fr.OP_INV, None)):
            got, plain = fr.fr_ops(op, conv, b), fr.fr_ops_plain(
                op, conv, None if b is None else b.expand_as(conv))
            err["fr_ops"] = max(err["fr_ops"], max_abs_err(got, plain))
            require(torch.equal(got, plain), f"K23 op {op} at M={2 * n} differs from its plain "
                    "version")
    print(f"das extension check: {len(data)} first halves = data; the ({len(data)}, {2 * n}) "
          f"batch of extension NTTs = K22's plain version = the spec's second halves; one "
          f"blob's (1, {n}) inverse and (1, {2 * n}) forward NTT and K23 at M={2 * n} = plain",
          flush=True)

    # (b) one blob rebuilt from its samples, DAS_WITHHELD withheld
    samples, gone = tblobs.withheld_samples(spec, published[0], DAS_WITHHELD, seed)
    torch.cuda.synchronize()
    build.reset_launches()
    with FrClock() as clock:
        t0 = time.perf_counter()
        rebuilt = spec.reconstruct_extended_data(samples)
        recover_ms = 1e3 * (time.perf_counter() - t0)
        rec_device_ms = clock.device_ms()
        host = dict(clock.host)
    counted("reconstruction")
    require(rebuilt == published[0], "the reconstruction differs from the extension")
    require(parts["reconstruction"]["fr_ntt"] == 6,
            f"the reconstruction launched K22 {parts['reconstruction']['fr_ntt']} times, not 6")
    with Aside():
        altered = list(samples)
        k = next(i for i, s in enumerate(samples) if s is not None)
        vals = [int(v) for v in samples[k].data]
        vals[3] = (vals[3] + 1) % fr.R_MODULUS
        altered[k] = spec.DASSample(slot=samples[k].slot, shard=samples[k].shard,
                                    index=samples[k].index,
                                    data=spec.Vector[spec.BLSPoint, len(vals)](*vals))
        too_few, _ = tblobs.withheld_samples(spec, published[0], len(samples) // 2 + 1, seed)
        refused = []
        for twin in (altered, too_few):
            try:
                spec.reconstruct_extended_data(twin)
                refused.append(False)
            except AssertionError:
                refused.append(True)
    require(refused == [True, True], f"a failing twin was reconstructed: {refused}")
    stages = dict(zero_poly_host=host.get("zero_poly", 0.0), ntt_device_events=rec_device_ms,
                  ntt_calls_host_wall=host.get("ntt_ints", 0.0) + host.get("inv_ints", 0.0))
    stages["pointwise_and_layout_host"] = (recover_ms - stages["zero_poly_host"]
                                           - stages["ntt_calls_host_wall"])
    print(f"das reconstruction check: {len(samples)} samples, {len(gone)} withheld "
          f"({len(gone) * int(spec.POINTS_PER_SAMPLE)} points), rebuilt = the extension; the "
          f"twin with one value altered and the twin with {len(samples) // 2 + 1} withheld "
          "raised AssertionError", flush=True)

    # (c) sampling and verification at the tests' width (host KZG)
    setup = kzg.insecure_test_setup(2 * DAS_SAMPLE_POINTS + 2)
    kzg_shim.use_setup(setup)
    bls_was, bls.bls_active = bls.bls_active, True
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        small = spec.extend_data(data[0][:DAS_SAMPLE_POINTS])
        drawn = spec.sample_data(spec.Slot(0), spec.Shard(0), small)
        commitment = spec.commit_to_data(spec.ifft(spec.reverse_bit_order_list(small)))
        for s in drawn:
            spec.verify_sample(s, len(drawn), commitment)
        sampling_ms = 1e3 * (time.perf_counter() - t0)
        counted("sampling")
        with Aside():
            s = drawn[0]
            forged = spec.DASSample(slot=s.slot, shard=s.shard, index=s.index, proof=s.proof,
                                    data=spec.Vector[spec.BLSPoint, len(s.data)](
                                        *[(int(v) + 1) % fr.R_MODULUS for v in s.data]))
            try:
                spec.verify_sample(forged, len(drawn), commitment)
                forged_refused = False
            except AssertionError:
                forged_refused = True
    finally:
        kzg_shim.use_setup(None)
        bls.bls_active = bls_was
    require(parts["sampling"]["fr_ntt"] == 4, f"sampling launched {parts['sampling']}")
    require(forged_refused, "a forged sample passed verify_sample")
    print(f"das sampling check: {len(drawn)} samples of a {DAS_SAMPLE_POINTS}-point blob "
          f"verified against its commitment ({sampling_ms:.1f} ms, host KZG); a forged sample "
          "refused", flush=True)

    out.update(das_extend_ms=statistics.median(each), das_extend_slot_ms=slot_ms,
               das_extend_each_ms=each, das_extend_device_ms=ext_device_ms,
               das_extend_busy_share=ext_device_ms / slot_ms, das_recover_ms=recover_ms,
               das_recover_stages_ms=stages, das_recover_busy_share=rec_device_ms / recover_ms,
               das_busy_share=(ext_device_ms + rec_device_ms) / (slot_ms + recover_ms),
               withheld_samples=len(gone), withheld_points=len(gone) * int(spec.POINTS_PER_SAMPLE),
               das_sampling_ms=sampling_ms, sampling_points=DAS_SAMPLE_POINTS,
               sampling_samples=len(drawn), twins_refused=refused, forged_refused=forged_refused)
    inputs = dict(batch=padded, inverse=mont[:1].contiguous(), forward=padded[:1].contiguous(),
                  conv=conv, r2=r2)
    return out, parts, inputs


def das_rows(inputs, parts, err, sass_fr_mul, bound) -> list:
    """K22 at the slot's (64, 32,768) batch of extension NTTs, one blob's
    (1, 16,384) inverse and (1, 32,768) forward; K23 at the conversions'
    M = 32,768 (and the recovery's inversions there): each timed by CUDA
    events beside its plain version, its least time from (n/2)·log2 n Fr
    products (plus n for the inverse's 1/n) of K23's product SASS count, or
    the bytes read and written once."""
    from consensus_specs_tpu_torch.ops import fr

    def k22(x, inverse):
        b, n = x.shape[0], x.shape[1]
        products = b * ((n // 2) * (n.bit_length() - 1) + (n if inverse else 0))
        return dict(shape=f"B={b} n={n} {'inverse' if inverse else 'forward'}",
                    ms=time_ms(lambda: fr.ntt(x, inverse), 10),
                    plain_ms=time_ms(lambda: fr.ntt_plain(x, inverse), 1, warmup=0),
                    fr_products=products,
                    **bound(sass_fr_mul * products, 2 * 32 * b * n + 32 * (n - 1)))

    def k23(op, x, b):
        m = x.shape[0]
        e = fr.R_MODULUS - 2  # the inverse: a square a bit of e, a product a set bit
        products = m * ((e.bit_length() + bin(e).count("1")) if op == fr.OP_INV else 1)
        bb = None if b is None else b.expand_as(x)
        return dict(shape=f"M={m} {'inv' if op == fr.OP_INV else 'mul'}",
                    ms=time_ms(lambda: fr.fr_ops(op, x, b), 20),
                    plain_ms=time_ms(lambda: fr.fr_ops_plain(op, x, bb), 1, warmup=0),
                    fr_products=products,
                    **bound(sass_fr_mul * products, 2 * 32 * m + (32 if b is not None else 0)))

    first, *more = (k22(inputs["batch"], False), k22(inputs["inverse"], True),
                    k22(inputs["forward"], False))
    ntt_row = dict(name="fr_ntt", route="cuda", source="consensus_specs_tpu_torch/csrc/ntt.cu",
                   replaces="consensus_specs_tpu/ops/fr_jax.py:106", **first,
                   **{r["shape"]: r for r in more})
    conv, *inv = (k23(fr.OP_MUL, inputs["conv"], inputs["r2"]),
                  k23(fr.OP_INV, inputs["conv"], None))
    ops_row = dict(name="fr_ops", route="cuda", source="consensus_specs_tpu_torch/csrc/ntt.cu",
                   replaces="consensus_specs_tpu/ops/limb_mont.py:39", **conv,
                   **{r["shape"]: r for r in inv})
    rows = [ntt_row, ops_row]
    for row in rows:
        name = row["name"]
        row.update(launches=parts["extension"][name] + parts["reconstruction"][name],
                   launches_by_part={p: c[name] for p, c in parts.items()},
                   max_abs_err=err[name], bit_equal=err[name] == 0.0, library_ms=None,
                   library_null_reason="no PyTorch call computes 255-bit modular arithmetic "
                                       "(torch.fft is floating point)")
        for r in [row] + [v for v in row.values() if isinstance(v, dict) and "ms" in v]:
            print(f"kernel {name} ({r['shape']}): ms={r['ms']:.5f} bound_ms={r['bound_ms']:.6f} "
                  f"({r['bound_by']}) plain_ms={r['plain_ms']:.3f} launches {row['launches']} "
                  f"{row['launches_by_part']}", flush=True)
    return rows


def mesh_inputs(bls_in) -> dict:
    """Phase 5's slot of 1,024 gossip checks packed on the host as the mesh
    collectives take them, valid and with phase 5's bad item: ungrouped (an
    H(m) an item, P2 = -G1) and grouped (64 messages); seeded scalars, the
    same on every rank."""
    from consensus_specs_tpu_torch.crypto import bls_torch
    from consensus_specs_tpu_torch.ops import bls12 as B

    require(B.field_backend() == "limb", "the mesh path packs limb words")
    _, gossip, _ = bls_in
    zs = np.random.default_rng(MESH_SEED).integers(1, 2**64, len(gossip), dtype=np.uint64)
    out = {"ungrouped": {}, "grouped": {}}
    for name, checks in (("valid", gossip), ("bad", with_bad_item(gossip, len(gossip) // 2))):
        p1s, q1s, p2s, q2s = ([getattr(c, k) for c in checks] for k in ("p1", "q1", "p2", "q2"))
        b, (q1, p1, q2, p2) = bls_torch._pack_pairing_args(p1s, q1s, p2s, q2s, "cpu")
        b_n, b_d, (gq1, gp1, gq2), seg = bls_torch._pack_grouped_args(p1s, q1s, q2s, "cpu")
        require(b == b_n == len(checks) and b_d == len(set(q1s)),
                f"gossip packs to {b}, {b_n}, {b_d}")
        zb = bls_torch.zbits_from_ints(zs)
        out["ungrouped"][name] = (q1, p1, q2, p2, zb)
        out["grouped"][name] = (gq1, gp1, gq2, zb, seg)
    return out


def mesh_main_path(dev, bls_in, cfg) -> tuple:
    """Phase 5i: the multi-device path (consensus_specs_tpu_torch/parallel,
    driven by testlib/mesh_workers.mesh_path), (a) at world size 1 on NCCL in
    this process and (b) on MESH_WORLD gloo ranks sharing this card, (c) the
    (2, 2) mesh over those ranks: every sum, verdict and state against the
    single-device path's on the same inputs (uncounted)."""
    import torch
    import torch.distributed as dist

    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.engine import epoch as tepoch
    from consensus_specs_tpu_torch.engine.convert import epoch_state_from_numpy
    from consensus_specs_tpu_torch.engine.resident import step_body
    from consensus_specs_tpu_torch.engine.synthetic import (
        edge_epoch_state_numpy,
        synthetic_epoch_state,
    )
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.parallel import collectives as C
    from consensus_specs_tpu_torch.testlib import mesh_workers as MW
    from consensus_specs_tpu_torch.testlib.ranks import run_ranks

    t_phase = time.perf_counter()
    inputs = mesh_inputs(bls_in)
    edge = edge_epoch_state_numpy(cfg, "ejections_and_queue", MESH_EDGE_N, 0)
    ref = {"verdicts": {}, "digests": {}}
    with Aside():  # the single-device path on the same inputs
        pts, k_sum = MW.mesh_keys(MESH_KEYS, MESH_SEED, dev)
        whole = torch.tensor([0, MESH_KEYS], device=dev)
        ref["g1_sum"] = B.affine_from_words(B.point_sums(pts, whole), False)[0]
        want = oracle.pt_to_affine(oracle.FP_FIELD, oracle.pt_mul(oracle.FP_FIELD,
                                                                 oracle.G1_GEN, k_sum))
        require(ref["g1_sum"] == want, "the single-device key sum differs from the oracle's")
        del pts
        for name, args in inputs["ungrouped"].items():
            q1, p1, q2, _, zb = (t.to(dev) for t in args)
            ref["verdicts"][f"ungrouped_{name}"] = bool(B.pairing_check_rlc(q1, p1, q2, zb))
        for name, args in inputs["grouped"].items():
            ref["verdicts"][f"grouped_{name}"] = bool(B.pairing_check_rlc(
                *(t.to(dev) for t in args)))
        require(ref["verdicts"] == {"ungrouped_valid": True, "ungrouped_bad": False,
                                    "grouped_valid": True, "grouped_bad": False},
                f"single-device verdicts {ref['verdicts']}")
        st = synthetic_epoch_state(cfg, N_MAIN, seed=0, epoch=250, device=dev)
        step = step_body(cfg)
        for k in range(MESH_EPOCHS):
            step(st)
            if k == 0:
                ref["digests"]["epoch1_balances"] = MW.state_digest(st, ("balances",))
        ref["digests"]["epochs"] = MW.state_digest(st)
        del st
        est = epoch_state_from_numpy(edge, dev)
        ref["edge_aux"] = tepoch.make_epoch_fn(cfg)(est)[1].flat().cpu().numpy()
        ref["digests"]["edge"] = MW.state_digest(est)
        torch.cuda.synchronize()
    args = (cfg, inputs, MESH_KEYS, MESH_SEED, N_MAIN, MESH_EPOCHS, edge)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        one = MW.mesh_path(0, 1, "cuda", *args, False)
    finally:
        dist.destroy_process_group()
    t1 = time.perf_counter()
    four = run_ranks(MW.mesh_path, MESH_WORLD, "gloo", "cuda", *args, True)
    t2 = time.perf_counter()
    for r in [one] + four:
        who = f"world {r['world']} rank {r['rank']}"
        require(r["k_sum"] == k_sum and r["g1_sum"] == ref["g1_sum"],
                f"{who}: g1_mesh_sum differs from the single-device sum")
        require(r["verdicts"] == ref["verdicts"], f"{who}: verdicts {r['verdicts']}")
        for key in ("epoch1_balances", "epochs", "edge"):
            require(r["digests"][key] == ref["digests"][key],
                    f"{who}: the sharded {key} state differs from K3's")
        require(np.array_equal(r["edge_aux"], ref["edge_aux"]), f"{who}: edge aux differs")
        parts = r["parts"]
        for name in ("ungrouped_valid", "ungrouped_bad", "grouped_valid", "grouped_bad"):
            for k in ("rlc_ladders", "point_sums", "miller_loop", "final_exp", "f12_product"):
                require(parts[name]["launches"].get(k, 0) > 0, f"{who}: {name} never launched {k}")
        k10 = 3 if MESH_KEYS // r["world"] > C.SEGMENT else 2  # segments, block, partials
        require(parts["g1_sum"]["launches"].get("point_sums", 0) == k10,
                f"{who}: g1_mesh_sum launched K10 {parts['g1_sum']['launches']}")
        for name in [f"epoch{k + 1}" for k in range(MESH_EPOCHS)] + ["edge"]:
            require(parts[name]["launches"].get("epoch_sweep", 0) == 1
                    and parts[name]["launches"].get("epoch_combine", 0) == 3,
                    f"{who}: {name} launched {parts[name]['launches']}")
    for r in four:
        require(r["digests"]["hierarchical_balances"] == ref["digests"]["epoch1_balances"],
                f"rank {r['rank']}: the (2, 2) mesh's balances differ from the flat mesh's")
        require(r["coordinate"] == (r["rank"] // 2, r["rank"] % 2), "(2, 2) coordinates")
        require(r["parts"]["hierarchical"]["launches"].get("epoch_combine", 0) == 3,
                "the (2, 2) step must combine three times")

    def clocks(r):
        p = r["parts"]
        return dict(mesh_g1_sum_ms=p["g1_sum"]["ms"], mesh_rlc_ms=p["ungrouped_valid"]["ms"],
                    mesh_rlc_grouped_ms=p["grouped_valid"]["ms"],
                    mesh_epoch_ms=sum(p[f"epoch{k + 1}"]["ms"]
                                      for k in range(1, MESH_EPOCHS)) / (MESH_EPOCHS - 1),
                    mesh_epoch_first_ms=p["epoch1"]["ms"],
                    gather_wall_ms={k: v["gather_wall_ms"] for k, v in p.items()},
                    wall_ms={k: v["wall_ms"] for k, v in p.items()},
                    launches={k: v["launches"] for k, v in p.items()})

    out = dict(world1=clocks(one), world4=[clocks(r) for r in four],
               world1_setup_s=t1 - t0, world4_spawn_s=t2 - t1, phase_s=time.perf_counter() - t_phase,
               keys=MESH_KEYS, checks=len(bls_in[1]), groups=inputs["grouped"]["valid"][0].shape[0],
               n=N_MAIN, edge_n=MESH_EDGE_N)
    launches = {k: sum(r["parts"][p]["launches"].get(k, 0) for r in [one] + four
                       for p in r["parts"]) for k in ("f12_product", "epoch_combine")}
    w1 = out["world1"]
    print(f"mesh path (a) world 1, NCCL: mesh_g1_sum_ms={w1['mesh_g1_sum_ms']:.4f} "
          f"mesh_rlc_ms={w1['mesh_rlc_ms']:.4f} mesh_rlc_grouped_ms="
          f"{w1['mesh_rlc_grouped_ms']:.4f} mesh_epoch_ms={w1['mesh_epoch_ms']:.4f} (the first "
          f"{w1['mesh_epoch_first_ms']:.4f}; CUDA events around each part; host wall of its "
          f"gathers {w1['gather_wall_ms']}) launches="
          f"{w1['launches']}", flush=True)
    for r, c in zip(four, out["world4"]):
        print(f"mesh path (b) world {MESH_WORLD} rank {r['rank']}, gloo on one card (the ranks "
              f"share its SMs: these say nothing about scaling): mesh_g1_sum_ms="
              f"{c['mesh_g1_sum_ms']:.4f} mesh_rlc_ms={c['mesh_rlc_ms']:.4f} mesh_rlc_grouped_ms="
              f"{c['mesh_rlc_grouped_ms']:.4f} mesh_epoch_ms={c['mesh_epoch_ms']:.4f} (the first "
              f"{c['mesh_epoch_first_ms']:.4f}; host wall of gathers {c['gather_wall_ms']}); (c) "
              f"(2, 2) epoch "
              f"{r['parts']['hierarchical']['ms']:.4f} ms", flush=True)
    print(f"mesh path check: {MESH_KEYS} keys' sum = single-device K10 = oracle at world 1 and "
          f"{MESH_WORLD}; {out['checks']}-check ungrouped and {out['groups']}-group grouped "
          f"verdicts (valid, bad) = "
          f"single-device; {MESH_EPOCHS} sharded epochs at N={N_MAIN}, the edge state at "
          f"N={MESH_EDGE_N} and the (2, 2) epoch = K3; phase {out['phase_s']:.1f} s (world 1 "
          f"{out['world1_setup_s']:.1f} s, world {MESH_WORLD} spawn and run "
          f"{out['world4_spawn_s']:.1f} s)", flush=True)
    return out, launches, inputs


def mesh_rows(dev, inputs, launches, err, sass_mul, bound) -> list:
    """K25 at the shapes phase 5i gave it (a rank's shard of the 1,024
    checks at world 1 and 4, a rank's 64 and 16 groups) on the flush's own
    Miller values, bit-equal to its plain version there, beside that
    version's time and Fp products (the least time: those products times K8's
    product instructions, or the bytes); epoch_combine at 1 and 4 ranks."""
    import torch

    from consensus_specs_tpu_torch.engine import epoch as tepoch
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.ops import fp

    q1, p1, q2, _, zb = (t.to(dev) for t in inputs["ungrouped"]["valid"])
    m = B.miller_loop(q1, B.rlc_randomize_g1(p1, zb))
    shapes = {}
    for b in MESH_F12_SHAPES:
        mb = m[:b].contiguous()
        muls0 = fp.plain_muls
        plain, plain_ms, _ = timed(lambda: B.f12_product_plain(mb))
        muls = fp.plain_muls - muls0
        got = B.f12_product(mb)
        err["f12_product"] = max(err["f12_product"], max_abs_err(got, plain))
        require(torch.equal(got, plain), f"K25 f12_product (B={b}) differs from its plain version")
        bd = bound(muls * sass_mul, 2 * mb.numel() * 4 + 144 * 4)
        shapes[b] = dict(shape=f"B={b}", ms=time_ms(lambda: B.f12_product(mb), 10),
                         plain_ms=plain_ms, fp_muls=muls, **bd)
    first, *more = shapes.values()
    rows = [dict(name="f12_product", route="cuda", source="consensus_specs_tpu_torch/csrc/pairing.cu",
                 replaces="consensus_specs_tpu/ops/bls12_jax.py:1061",
                 launches=launches["f12_product"], max_abs_err=err["f12_product"],
                 bit_equal=err["f12_product"] == 0.0, library_ms=None,
                 library_null_reason="no PyTorch call multiplies in Fp12", **first,
                 **{r["shape"]: r for r in more})]
    for r in shapes.values():
        print(f"kernel f12_product ({r['shape']}): ms={r['ms']:.5f} bound_ms={r['bound_ms']:.6f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.3f} fp_muls={r['fp_muls']}", flush=True)
    combine = {}
    for w in (1, MESH_WORLD):
        parts = torch.from_numpy(np.random.default_rng(w).integers(0, 2**40, (w, 32))).to(dev)
        got, plain = tepoch.epoch_combine(parts, 0), tepoch.epoch_combine_plain(parts, 0)
        require(torch.equal(got, plain), "epoch_combine differs from its plain version")
        combine[w] = dict(shape=f"w={w}", ms=time_ms(lambda: tepoch.epoch_combine(parts, 0), 20),
                          plain_ms=time_ms(lambda: tepoch.epoch_combine_plain(parts, 0), 3),
                          **bound(0, (w + 1) * 32 * 8))
    first, *more = combine.values()
    rows.append(dict(name="epoch_combine", route="cuda",
                     source="consensus_specs_tpu_torch/csrc/epoch.cu",
                     replaces="consensus_specs_tpu/parallel/mesh.py:30",
                     launches=launches["epoch_combine"], max_abs_err=err["epoch_combine"],
                     bit_equal=err["epoch_combine"] == 0.0, library_ms=None,
                     library_null_reason="no one PyTorch call folds sums, a max, an OR and a "
                     "copy by slot", **first, **{r["shape"]: r for r in more}))
    for r in combine.values():
        print(f"kernel epoch_combine ({r['shape']}): ms={r['ms']:.5f} "
              f"bound_ms={r['bound_ms']:.6f} plain_ms={r['plain_ms']:.3f}", flush=True)
    return rows


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="the DAS lane's blobs (phase 5g)")
    args = ap.parse_args(argv)
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

    parts = torch.from_numpy(rng.integers(-2**62, 2**62, (MESH_WORLD, 32))).to(dev)
    for stage in range(3):
        got, plain = tepoch.epoch_combine(parts, stage), tepoch.epoch_combine_plain(parts, stage)
        err["epoch_combine"] = max(err["epoch_combine"], max_abs_err(got, plain))
        require(torch.equal(got, plain), f"K3 epoch_combine (stage {stage}) differs from its "
                "plain version")
    print(f"check K3 epoch_combine: {MESH_WORLD} ranks' vectors at stages 0-2 bit-equal")

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
    check_tree_root_kernel(dev, rng, err)
    check_multiproof_kernels(dev, np.random.default_rng(20), err)
    check_rns_kernel(dev, err)
    check_rns_bls_kernels(dev, err)

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
        require(count > 0 or name in BLS_KERNELS + MSM_KERNELS + FC_KERNELS + PROOF_KERNELS
                + DAS_KERNELS + RNS_KERNELS + RNS_BLS_KERNELS + MESH_KERNELS,
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
    # the append's oracle, historical_batch_root (27 K1 launches, the path
    # before K19), beside its plain version: 2 x 8191 tree nodes and the top
    # hash, 16,383 64-byte hashes; reported in the K19 row as k1_path_ms
    def batch_root(h):
        top = torch.cat([troot._vector_root_words(ref.block_roots, h),
                         troot._vector_root_words(ref.state_roots, h)])
        return h(top[None])[0]

    with Aside():
        k1_path_ms = time_ms(lambda: tepoch.historical_batch_root(ref.block_roots, ref.state_roots),
                          10)
        k1_path_plain_ms = time_ms(lambda: batch_root(tsha.sha256_64B_words_plain), 1)
        require(torch.equal(batch_root(tsha.sha256_64B_words_plain), loop.historical_roots[0]),
                "historical batch root differs from its plain version")
    k1_path_hashes = 2 * (cfg.slots_per_historical_root - 1) + 1
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

    # 5e. the spec's state_transition at N = 2**20 across epoch 256
    spec_out, spec_launches, k19_chunks = spec_main_path(dev)
    print("spec main path: " + " ".join(f"{k}={v:.4f}" for k, v in spec_out.items()
                                        if k.endswith("_ms") and not isinstance(v, (list, dict)))
          + f" stages_ms={spec_out['spec_epoch_stages_ms']} launches="
          f"{ {k: v for k, v in spec_launches.items() if v} }", flush=True)

    # 5f. the read lane beside the resident loop: the proof bench's queries
    # through the proof service, the scheduler and K20 + K21
    proof_out, proof_launches, proof_inputs = proof_main_path(dev, loop)
    stages = proof_out["proof_flush_stages_ms"]
    print(f"read lane main path: proof_cold_round_ms={proof_out['proof_cold_round_ms']:.4f} "
          f"proof_warm_round_ms={proof_out['proof_warm_round_ms']:.4f} (each "
          f"{proof_out['proof_warm_round_each_ms']}) proof_flush_ms="
          f"{proof_out['proof_flush_ms']:.4f} (median of {proof_out['flushes']}: provider read "
          f"{stages['provider_read']:.4f}, pack {stages['pack']:.4f}, device "
          f"{stages['device_events']:.4f} by CUDA events ({stages['device_wall']:.4f} host wall), "
          f"unpack {stages['unpack']:.4f}) proofs_per_s_warm={proof_out['proofs_per_s_warm']:.1f} "
          f"proof_p99_request_ms={proof_out['proof_p99_request_ms']:.4f} (exact; max "
          f"{proof_out['proof_max_request_ms']:.4f}, bucket-interpolated p99 "
          f"{proof_out['proof_p99_request_ms_buckets']:.4f}) "
          f"proof_cache_hit_ratio={proof_out['proof_cache_hit_ratio']:.4f} busy share "
          f"{proof_out['proof_busy_share']:.4f} (CUDA-event device time over the rounds' wall); "
          f"sched_dispatch_total{{path=device}}={proof_out['sched_dispatch_device']} "
          f"sched_degraded_total={proof_out['sched_degraded']} breaker "
          f"{proof_out['breaker']} launches={proof_launches}", flush=True)

    # 5g. the DAS lane: one slot's 64 blobs of 16,384 points extended through
    # the compiled das mainnet spec, one blob reconstructed, sampling
    das_out, das_parts, das_inputs = das_main_path(dev, args.seed, err)
    stages = das_out["das_recover_stages_ms"]
    print(f"das lane main path: das_extend_ms={das_out['das_extend_ms']:.4f} (median of "
          f"{das_out['blobs']}) das_extend_slot_ms={das_out['das_extend_slot_ms']:.4f} (device "
          f"{das_out['das_extend_device_ms']:.4f} by CUDA events, busy share "
          f"{das_out['das_extend_busy_share']:.4f}) das_recover_ms={das_out['das_recover_ms']:.4f} "
          f"(zero polynomial {stages['zero_poly_host']:.4f} host; NTT and inverse calls "
          f"{stages['ntt_calls_host_wall']:.4f} host wall, {stages['ntt_device_events']:.4f} "
          f"device by CUDA events; pointwise and layout {stages['pointwise_and_layout_host']:.4f} "
          f"host; busy share {das_out['das_recover_busy_share']:.4f}) busy share "
          f"{das_out['das_busy_share']:.4f} launches={das_parts}", flush=True)

    # 5h. phase 5's BLS flushes over the RNS field backend (K9-K12's RNS instances)
    rns_out, rns_launches, rns_parts = rns_main_path(dev, bls_in, bls_out)
    print("rns main path: " + " ".join(f"{k}={'not measured' if v is None else f'{v:.4f}'}"
                                       for k, v in rns_out.items()
                                       if k.endswith(("_ms", "_share")))
          + f" first flush {rns_out['block_first_host_costs']} warm block flush "
          f"{rns_out['block_host_costs']}"
          + f" launches={ {k: v for k, v in rns_launches.items() if v} }", flush=True)

    # 5i. the multi-device path: world size 1 on NCCL, 4 gloo ranks on this
    # card, the (2, 2) mesh
    mesh_out, mesh_launches, mesh_in = mesh_main_path(dev, bls_in, cfg)

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
    # K19 at the historical append's (1, 16384) and the Merkle lane's
    # buckets: K*(C-1) hashes of K1's instructions each, K*C rows read once
    k19 = {}
    with Aside():
        for k, c in K19_SHAPES[:3]:
            chunks = (k19_chunks if (k, c) == (1, 16384)
                      else rand_words(rng, (k, c, 8), dev))
            build.reset_launches()
            troot.tree_root_batch(chunks)
            k19[(k, c)] = dict(
                shape=f"K={k} C={c}", launches_a_call=build.LAUNCHES["tree_root_batch"],
                ms=time_ms(lambda: troot.tree_root_batch(chunks), 20),
                plain_ms=time_ms(lambda: troot.tree_root_batch_plain(chunks), 1),
                **bound(sass["sha256_64b"] * k * (c - 1), 32 * k * c + 32 * k))
    first, *more = k19.values()
    rows.append(dict(name="tree_root_batch", route="cuda",
                     source="consensus_specs_tpu_torch/csrc/tree_root.cu",
                     replaces="consensus_specs_tpu/engine/state_root.py:114",
                     launches=spec_launches["tree_root_batch"],
                     max_abs_err=err["tree_root_batch"],
                     bit_equal=err["tree_root_batch"] == 0.0, library_ms=None,
                     library_null_reason="no PyTorch call hashes",
                     k1_path_ms=k1_path_ms, k1_path_plain_ms=k1_path_plain_ms,
                     k1_path_hashes=k1_path_hashes, **first,
                     **{r["shape"]: r for r in more}))
    for r in k19.values():
        print(f"kernel tree_root_batch ({r['shape']}): ms={r['ms']:.5f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) plain_ms={r['plain_ms']:.3f} "
              f"launches a call {r['launches_a_call']}", flush=True)
    with Aside():
        rows += multiproof_rows(proof_inputs, proof_launches, err, sass["sha256_64b"], bound)
    sass_fr_mul = sass_instructions("ntt", "fr_ops_kernelILi0E")
    with Aside():
        rows += das_rows(das_inputs, das_parts, err, sass_fr_mul, bound)
    with Aside():
        rows += rns_rows(dev, rns_launches, err)
    rows += rns_bls_rows(dev, bls_in, rns_launches, err)
    with Aside():
        rows += mesh_rows(dev, mesh_in, mesh_launches, err, sass_mul, bound)
    card = card_line()
    print(card)
    print(json.dumps({"kernels": rows, "main_path": {
        "n": N_MAIN, "epoch_ms": epoch_ms, "field_roots_ms": roots_ms,
        "root_refresh_ms": root_refresh_ms, "root_refresh_each_ms": refresh_ms,
        "root_refresh_wall_ms": sum(refresh_wall) / SINGLE_EPOCHS,
        "sync_rotation_ms": rotation["ms"], "sync_rotation_wall_ms": rotation["wall_ms"],
        "sync_rotation_loop_wall_ms": rotation["loop_wall_ms"], "n_active": n_rot,
        "refreshes": refreshes, "max_memory_allocated": peak, "bls_stack": stack},
        "bls_path": bls_out, "msm_path": dict(msm_out, launches=msm_parts),
        "forkchoice_path": dict(fc_out, launches=fc_parts),
        "spec_path": dict(spec_out, n=SPEC_N, slots=SPEC_SLOTS, committees=SPEC_COMMITTEES,
                          launches=spec_launches),
        "proof_path": dict(proof_out, launches=proof_launches),
        "das_path": dict(das_out, seed=args.seed, launches=das_parts),
        "rns_path": dict(rns_out, launches=rns_parts),
        "mesh_path": dict(mesh_out, launches=mesh_launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
