"""Where the time of the port's main path goes on the card.

    python -m consensus_specs_tpu_torch.profile_main_path [--n N] [--epochs K]

Builds the kernels, puts a synthetic altair-mainnet registry of N
validators on the card (default 2**20, seed 0, from epoch 250), warms the
resident loop up and builds its Merkle cache, then profiles four windows
with torch.profiler: K resident epochs (default 8), one `field_roots`, one
epoch followed by the `device_roots()` refresh of the cache, one
sync-committee sample (the rotation's work) on the current columns, and
the BLS flushes of one block (131 checks) and of one slot's gossip
aggregates (1024 checks), from `crypto/bls_synthetic.flush_inputs(0)`
after one warm-up flush each, the same two flushes over the RNS field
backend (K9-K12's RNS instances; the block flush's warm-up is the
process's first RNS flush, and it and a second one run under cProfile to
show what the first use costs; their launches by kernel, and K24's by op
code, are printed from one counted flush each, and the block flush runs
under cProfile too), the block's cold committee-key aggregation
(129 FastAggregateVerify calls over 66,048 keys, key caches cleared,
signatures decompressed before), the KZG sample batch at 128 blobs
(`crypto/msm_synthetic`, seed 0) and the fork-choice head at V = N
(`forkchoice/synthetic`: one snapshot of the 512-block storm tree, a batch
of 8 swung snapshots, one of 8,192 blocks; each after a warm-up call), the
read lane over the loop's columns (`proofs/lane`: a cold round of the proof
bench's queries, then one warm flush of 512 after an epoch's invalidation
under torch.profiler and another under cProfile), and the spec's
`state_transition` at N (`--spec-n`, default 2**20; the routed altair
mainnet spec, real keys, blocks at slots 8189-8193 as
`chip_smoke.py` phase 5e builds them): the importer's epoch-256 block and
the next block under torch.profiler, the proposer's epoch-256 block and the
importer's block before the boundary under cProfile, and the DAS lane (the
compiled das mainnet spec, `testlib/blobs`, seed 0: `extend_data` on one
slot's 64 blobs of 16,384 points and `reconstruct_extended_data` of one
blob with 256 of its 4,096 samples withheld under torch.profiler, 8
extensions under cProfile). For each window it prints the
host wall time, the device time summed over every device-side record, the
device busy share (the activities of one stream do not overlap), and the
activities that took the most device time. The last windows run the K
epochs, the gossip flush, the cold aggregation, the KZG batch and the
fork-choice batch of 8 under cProfile and print the host functions with the most own time. Needs a
card; without one it exits nonzero.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def profile_window(fn, torch):
    """fn() under torch.profiler, recording the device side only (host ops
    would slow the host and are not read): (host wall us, [(key, count,
    device us)] of the device-side records, most device time first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels, memsets and copies
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return wall_us, rows


def _first_use(label, fn, torch) -> None:
    """fn() twice under cProfile, the first time being its first in the
    process: both host walls, the caching allocator's cudaMalloc calls of
    each, and the host functions whose own time grew most on the first."""
    import cProfile
    import pstats

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        fn()
        torch.cuda.synchronize()
        prof.disable()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0) - mallocs
        own = {k: (v[1], v[2]) for k, v in pstats.Stats(prof).stats.items()}
        runs.append((wall_ms, mallocs, own))
    (w1, m1, own1), (w2, m2, own2) = runs
    print(f"first use, {label} under cProfile: first {w1:.1f} ms ({m1} cudaMalloc calls), "
          f"second {w2:.1f} ms ({m2}); own time grown most on the first:")
    grown = sorted(((t - own2.get(k, (0, 0.0))[1], n, own2.get(k, (0, 0.0))[0], k)
                    for k, (n, t) in own1.items()), reverse=True)
    for dt, n1, n2, (path, line, name) in grown[:12]:
        print(f"    {1e3 * dt:10.1f} ms  calls {n1} / {n2}  {path.rsplit('/', 2)[-1]}:{line}"
              f"({name})")


def _print_window(label, wall_us, rows) -> None:
    device_us = sum(r[2] for r in rows)
    if not rows:
        print(f"{label}: wall {wall_us:.1f} us; device time not measured "
              "(the profiler recorded no device activity)")
        return
    print(f"{label}: wall {wall_us:.1f} us, device {device_us:.1f} us, "
          f"busy share {device_us / wall_us:.4f}, idle share {1 - device_us / wall_us:.4f}")
    for key, count, us in rows[:12]:
        print(f"    {us:12.1f} us  {count:6d}x  {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--spec-n", type=int, default=1 << 20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_main_path: needs an NVIDIA card", file=sys.stderr)
        return 2
    from .crypto import bls_synthetic, bls_torch, kzg_batch, msm_synthetic
    from .engine.fork_choice import ghost_head_batch
    from .engine.resident import ResidentEpochLoop
    from .engine.state import EpochConfig
    from .engine.sync_committee import sync_committee_for_state
    from .engine.synthetic import synthetic_epoch_state
    from .forkchoice import synthetic as fc_synthetic
    from .kernels import build
    from .ops import bls12, fp_rns

    build.build_all()
    dev = torch.device("cuda")
    cfg = EpochConfig.altair_mainnet()
    rng = np.random.default_rng(0)
    static01 = torch.from_numpy(rng.integers(0, 2**32, (args.n, 16), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)
    loop = ResidentEpochLoop(cfg, synthetic_epoch_state(cfg, args.n, seed=0, epoch=250,
                                                        device=dev), device=dev)
    loop.device_roots(static01)
    loop.run_epochs(2)
    loop.field_roots(static01)
    loop.device_roots()

    def epochs():
        loop.run_epochs(args.epochs)
        loop.flush()

    def refresh():
        loop.step_epoch()
        loop.device_roots()

    def rotation():
        period = cfg.epochs_per_sync_committee_period
        sync_committee_for_state(cfg, loop.state, (loop.epoch // period + 1) * period)

    block, gossip, _ = bls_synthetic.flush_inputs(0)

    def flush(checks):
        if not bls_torch.run_checks(checks, dev).all():
            raise RuntimeError("a valid synthetic batch failed its check")

    def block_flush():
        flush(block)

    def gossip_flush():
        flush(gossip)

    block_flush()
    gossip_flush()

    def rns(fn):
        """fn under the "rns" field backend (K9-K12's RNS instances)."""
        def run():
            bls12.set_field_backend("rns")
            try:
                fn()
            finally:
                bls12.set_field_backend("limb")
        return run

    _first_use("the BLS block flush over the RNS field", rns(block_flush), torch)
    rns(gossip_flush)()

    agg_in = msm_synthetic.block_aggregate_inputs(0)
    kzg_in = msm_synthetic.kzg_inputs(0)
    for _, _, sig in agg_in["calls"]:
        bls_torch.g2_from_bytes(sig)

    def cold_aggregation():
        bls_torch.clear_caches()
        for pks, msg, sig in agg_in["calls"]:
            if bls_torch.make_fast_aggregate_check(pks, msg, sig, device=dev) is None:
                raise RuntimeError("a valid synthetic committee failed to aggregate")

    def kzg_samples():
        if not kzg_batch.batch_verify_samples(kzg_in["setup"], kzg_in["samples"], device=dev):
            raise RuntimeError("the synthetic KZG batch failed")

    kzg_samples()

    storm = fc_synthetic.build_storm(512, args.n)
    fc_head = [storm.mirror.snapshot()]
    fc_batch = storm.perturbed(8, 1)
    fc_long = [fc_synthetic.build_storm(8192, args.n).mirror.snapshot()]

    def fc_heads(snaps):
        return lambda: ghost_head_batch(snaps, dev)

    for snaps in (fc_head, fc_batch, fc_long):
        fc_heads(snaps)()

    print(f"card: {torch.cuda.get_device_name(0)}; N={args.n}")
    for label, fn in ((f"{args.epochs} resident epochs", epochs),
                      ("field_roots", lambda: loop.field_roots(static01)),
                      ("one epoch + device_roots refresh", refresh),
                      ("sync-committee sample", rotation),
                      (f"BLS block flush ({len(block)} checks)", block_flush),
                      (f"BLS gossip flush ({len(gossip)} checks)", gossip_flush),
                      (f"BLS block flush over the RNS field ({len(block)} checks)",
                       rns(block_flush)),
                      (f"BLS gossip flush over the RNS field ({len(gossip)} checks)",
                       rns(gossip_flush)),
                      (f"cold key aggregation ({len(agg_in['calls'])} calls)", cold_aggregation),
                      (f"KZG sample batch ({len(kzg_in['samples'])} blobs)", kzg_samples),
                      ("fork-choice head (512 blocks)", fc_heads(fc_head)),
                      ("fork-choice batch of 8 (512 blocks)", fc_heads(fc_batch)),
                      ("fork-choice head (8192 blocks)", fc_heads(fc_long))):
        _print_window(label, *profile_window(fn, torch))

    for label, fn in (("block", block_flush), ("gossip", gossip_flush)):
        torch.cuda.synchronize()
        build.reset_launches()
        fp_rns.OP_LAUNCHES.clear()
        rns(fn)()
        torch.cuda.synchronize()
        print(f"launches in one {label} flush over the RNS field: "
              f"{ {k: v for k, v in build.LAUNCHES.items() if v} }; K24 "
              f"{build.LAUNCHES['rns_ops']} by op {dict(fp_rns.OP_LAUNCHES)}")

    import cProfile
    import io
    import pstats

    for label, fn in ((f"{args.epochs} resident epochs", epochs),
                      ("the BLS gossip flush", gossip_flush),
                      ("the BLS block flush over the RNS field", rns(block_flush)),
                      ("the cold key aggregation", cold_aggregation),
                      ("the KZG sample batch", kzg_samples),
                      ("the fork-choice batch of 8", fc_heads(fc_batch))):
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        fn()
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
        print(f"host, {label} under cProfile (own time):")
        print("\n".join(line for line in out.getvalue().splitlines() if line.strip())[:4000])
    _profile_read_lane(loop, dev, torch)
    _profile_das_lane(dev, torch)
    _profile_spec_path(args.spec_n, dev, torch)
    return 0


def _profile_das_lane(dev, torch):
    """The DAS lane's windows (see the module docstring)."""
    from .compiler import build_spec
    from .ops import fr
    from .testlib import blobs

    spec = build_spec("das", "mainnet", device=dev)
    data = blobs.slot_blobs(spec, 0)
    n = blobs.blob_points(spec)
    for size, inverse in ((n, True), (2 * n, False), (2 * n, True)):
        fr.twiddles(size, inverse, dev)  # set-up, once a process
    published = [spec.extend_data(data[0])]
    samples, _ = blobs.withheld_samples(spec, published[0], 256, 0)

    def extend_slot():
        published[1:] = [spec.extend_data(b) for b in data[1:]]

    def reconstruct():
        if spec.reconstruct_extended_data(samples) != published[0]:
            raise RuntimeError("the reconstruction differs from the extension")

    print(f"das lane: {len(data)} blobs of {blobs.blob_points(spec)} points")
    _print_window(f"das extend_data ({len(data) - 1} blobs)", *profile_window(extend_slot, torch))
    _print_window("das reconstruct_extended_data (256 of 4,096 samples withheld)",
                  *profile_window(reconstruct, torch))
    _host_profile("8 das extensions", lambda: [spec.extend_data(b) for b in data[:8]], torch)


def _profile_read_lane(loop, dev, torch):
    """The read lane over the loop's columns (the proof bench's queries):
    a cold round fills the cache, then one epoch and its invalidation before
    each window; one warm flush (512 queries) under torch.profiler, another
    under cProfile."""
    from .proofs import ProofService, lane
    from .sched import MerkleWorkClass, Scheduler

    svc = ProofService(scheduler=Scheduler(classes=[MerkleWorkClass(device=dev)]))
    lane.register_loop_columns(svc, loop)
    queries = lane.build_queries(loop.state.balances.shape[0] // 4)
    lane.prove_round(svc, queries)

    def invalidate():
        loop.step_epoch()
        loop.flush()
        return svc.note_epoch(loop.dirty_columns())

    def warm_flush():
        svc.prove_many(queries[:lane.FLUSH])

    dropped = invalidate()
    _print_window(f"read lane: one warm flush ({lane.FLUSH} queries, {dropped} branches "
                  "invalidated by the epoch before)", *profile_window(warm_flush, torch))
    invalidate()
    _host_profile(f"one warm read-lane flush ({lane.FLUSH} queries)", warm_flush, torch)


def _host_profile(label, fn, torch):
    import cProfile
    import io
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
    print(f"host, {label} under cProfile ({wall:.3f} s; own time):")
    print("\n".join(line for line in out.getvalue().splitlines() if line.strip())[:4000])


def _profile_spec_path(n, dev, torch):
    """The spec path's windows (see the module docstring)."""
    from .compiler import build_spec
    from .crypto import bls
    from .engine.routing import memoized_total_active_balance, routed_spec
    from .testlib import big_state
    from .testlib import block as tblock

    spec = build_spec("altair", "mainnet", device=dev)
    bls.use_device("cuda")
    bls.bls_active = True
    imp = big_state.synthetic_beacon_state(spec, n, slot=8188,
                                           pubkeys=big_state.real_pubkeys(n))
    spec.hash_tree_root(imp)
    prop = imp.copy()
    blocks = {}

    def propose(slot):
        blocks[slot] = tblock.propose_block(spec, prop, slot, (0, 1))

    def apply(slot):
        with bls.deferred_verification():
            spec.state_transition(imp, blocks[slot], validate_result=True)

    print(f"spec path: N={n}")
    with routed_spec(spec, device=dev), memoized_total_active_balance(spec):
        for slot in (8189, 8190):
            propose(slot)
            apply(slot)
        propose(8191)
        _host_profile("the importer's block 8191", lambda: apply(8191), torch)
        _host_profile("the proposer's block 8192 (epoch 256)", lambda: propose(8192), torch)
        propose(8193)
        for label, slot in (("the importer's block 8192 (epoch 256)", 8192),
                            ("the importer's block 8193", 8193)):
            _print_window(label, *profile_window(lambda: apply(slot), torch))


if __name__ == "__main__":
    sys.exit(main())
