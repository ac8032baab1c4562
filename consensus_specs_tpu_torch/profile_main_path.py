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
after one warm-up flush each, the block's cold committee-key aggregation
(129 FastAggregateVerify calls over 66,048 keys, key caches cleared,
signatures decompressed before), the KZG sample batch at 128 blobs
(`crypto/msm_synthetic`, seed 0) and the fork-choice head at V = N
(`forkchoice/synthetic`: one snapshot of the 512-block storm tree, a batch
of 8 swung snapshots, one of 8,192 blocks; each after a warm-up call). For
each window it prints the
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


def _profile(fn, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side records only (kernels, memsets, copies): host ops also
    # carry the device time of the kernels they launched
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return wall_us, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--epochs", type=int, default=8)
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
                      (f"cold key aggregation ({len(agg_in['calls'])} calls)", cold_aggregation),
                      (f"KZG sample batch ({len(kzg_in['samples'])} blobs)", kzg_samples),
                      ("fork-choice head (512 blocks)", fc_heads(fc_head)),
                      ("fork-choice batch of 8 (512 blocks)", fc_heads(fc_batch)),
                      ("fork-choice head (8192 blocks)", fc_heads(fc_long))):
        wall_us, rows = _profile(fn, torch)
        device_us = sum(r[2] for r in rows)
        if not rows:
            print(f"{label}: wall {wall_us:.1f} us; device time not measured "
                  "(the profiler recorded no device activity)")
            continue
        print(f"{label}: wall {wall_us:.1f} us, device {device_us:.1f} us, "
              f"busy share {device_us / wall_us:.4f}, idle share {1 - device_us / wall_us:.4f}")
        for key, count, us in rows[:12]:
            print(f"    {us:12.1f} us  {count:6d}x  {key[:90]}")

    import cProfile
    import io
    import pstats

    for label, fn in ((f"{args.epochs} resident epochs", epochs),
                      ("the BLS gossip flush", gossip_flush),
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
