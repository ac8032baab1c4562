"""Time K8's inverse, K9, K10, K11, K12, K13, K25, K22 and K23 in any
checkout of the port, so that two checkouts can be timed in turns on one
card.

    python3 consensus_specs_tpu_torch/time_bls_kernels.py [--root CHECKOUT] [--out FILE]
        [--rows SUBSTRING,...] [--profile]

Imports `consensus_specs_tpu_torch` from CHECKOUT (default: the checkout
this file is in), builds its kernels there, and times with CUDA events, at
the main path's shapes: K8 op 5 (the inverse) at M = 256; K10's committee
sum (`g1_aggregate`, one 512-key segment), its G2 collapse at N = 256 and
1,024 in both fields and its grouped G1 sums (64 segments of 16); K13 at
the KZG batch's two shapes, (128, 64) and (512, 255), with the inputs
`chip_smoke.py` builds (`kzg_msm_args`); K9 at N = 256 (G1 affine and G2,
the block flush's launch), G1 alone and G2 alone, and at the gossip's 1,024
(G1 Jacobian and G2); K11 at B = 257 and 1,025; K12's tail at B = 257 and
its batch mode at 256 items with m2; K9, K11 and K12 in the limb field and
over RNS residues; K25 at B = 256 and 1,024; K22 at the DAS lane's
shapes, (1, 16,384) inverse, (1, 32,768) and (64, 32,768) forward, K23's
product at M = 32,768, and one DAS transform on canonical words with its
conversions at (1, 32,768) (`ntt_words` where the checkout has it, else
K23's product by R^2 mod r, K22, K23's product by 1: the same function,
the same digest). The inputs are seeded and made with the
checkout's own wrappers (keys sk_0 + j as `crypto/msm_synthetic` makes a
committee, G2 points from K9's ladders over 8 hashed messages, Miller values
from K11 over 8 pairs, tiled), so two checkouts see the same inputs; every
output's sha256 is printed beside its time, and two checkouts that compute
the same function print the same digests (RNS residues follow a kernel's
order of operations: a checkout that changes it prints other digests for
the same values mod p). `--rows` keeps the rows whose
name holds one of the substrings; `--profile` runs each kept row once more
under `torch.profiler` and prints the device time of every CUDA kernel it
launched (K13's three kernels apart, say). Prints one JSON object (and
writes it to FILE): the card, the checkout, and per row its ms and digest
(and its kernels' device times under `--profile`). Needs a card; exits
nonzero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def kzg_msm_args(kzg_in, dev, seed: int = 6) -> dict:
    """K13's arguments at the KZG batch's two shapes, as `chip_smoke.py`
    times them: (128, 64), the 128 sample proofs with 63-bit scalars, and
    (512, 255), the folded side (negated proofs, negated commitments, the
    setup's first points) with 255-bit scalars mod r, each padded to its
    power-of-two bucket with the generator and zero scalars. `kzg_in` is
    `crypto.msm_synthetic.kzg_inputs(seed=0)`. Returns {label: (points,
    scalars, nbits)}."""
    import numpy as np

    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.crypto import kzg_batch
    from consensus_specs_tpu_torch.ops import bls12 as B

    rng = np.random.default_rng(seed)
    samples = kzg_in["samples"]
    proofs = [kzg_batch._aff(it[3]) for it in samples]
    side64 = (proofs, [int(v) for v in rng.integers(1, 2**63, len(proofs), dtype=np.int64)])
    folded = ([kzg_batch._neg(p) for p in proofs]
              + [kzg_batch._neg(kzg_batch._aff(it[0])) for it in samples]
              + [kzg_batch._aff(g) for g in kzg_in["setup"].g1[:len(samples[0][2])]])
    side255 = (folded, [int.from_bytes(rng.bytes(32), "little") % oracle.R for _ in folded])
    out = {}
    for label, (points, scalars), nbits in (("n=128 nbits=64", side64, 64),
                                             ("n=512 nbits=255", side255, 255)):
        pad = B._msm_pow2_pad(len(points)) - len(points)
        out[label] = (B._jacobian_words(points + [oracle.G1_GEN_AFF] * pad, 0, dev),
                      B.scalar_words(scalars + [0] * pad, nbits).to(dev), nbits)
    return out


def kernel_times(fn) -> list:
    """[(kernel name, calls, device us)] of the CUDA kernels one call of fn
    launches, from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us and ev.count and not ev.key.startswith(("aten::", "cuda", "Activity")):
            rows.append((ev.key, ev.count, float(us)))
    return sorted(rows, key=lambda r: -r[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows", default="")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from consensus_specs_tpu_torch.kernels import build

    keep = [k for k in args.rows.split(",") if k]
    dev = torch.device("cuda")
    rows = fr_rows(dev)
    if not keep or any(not any(k in name for name in rows) for k in keep):
        rows.update(bls_rows(dev))
    reports = build.build_all(("ntt",))
    # registers, stack and spills of K9's, K10's, K11's, K13's, K22's and
    # K23's kernels, ladders and program interpreters, an instance a line
    ptxas, keys = [], ("ladders_kernel", "miller_loop_kernel", "scalar_mul", "slp_run",
                       "sums_kernel", "msm_", "fr_ntt_", "fr_ops_kernel")
    for text in list(BUILT.values()) + list(reports.values()):
        lines = text.splitlines()
        ptxas += [" | ".join(x.strip() for x in lines[i:i + 3]) for i, line in enumerate(lines)
                  if "Function properties for" in line and any(k in line for k in keys)]
    for line in ptxas:
        print("ptxas", line, flush=True)
    from consensus_specs_tpu_torch.ops import bls12 as B

    pkg = Path(B.__file__).resolve().parents[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"card": card, "package": str(pkg), "ptxas": ptxas, "rows": {}}
    for name, (fn, reps) in rows.items():
        if keep and not any(k in name for k in keep):
            continue
        res = fn()
        torch.cuda.synchronize()
        res = tuple(t for t in (res if isinstance(res, tuple) else (res,)) if t is not None)
        digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in res)).hexdigest()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out["rows"][name] = {"ms": start.elapsed_time(end) / reps, "reps": reps,
                             "sha256": digest[:16]}
        print(f"{name}: {out['rows'][name]['ms']:.5f} ms ({reps} reps) {digest[:16]}",
              flush=True)
        if args.profile:
            kernels = kernel_times(fn)
            out["rows"][name]["kernels_us"] = kernels
            for kname, calls, us in kernels:
                print(f"  {name} kernel {kname[:90]}: {calls} calls, {us:.2f} us", flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


BUILT: dict = {}  # ptxas reports of the BLS sources, when bls_rows built them


def fr_rows(dev) -> dict:
    """{row: (fn, reps)} of K22 and K23 at the DAS lane's shapes, on
    numpy-seeded canonical words (valid Montgomery words too)."""
    import numpy as np
    import torch

    from consensus_specs_tpu_torch.ops import fr

    rng = np.random.default_rng(17)
    top = fr.R_MODULUS >> 224  # a top word below r's keeps every value below r

    def words(b, n):
        w = rng.integers(0, 1 << 32, (b, n, 8), dtype=np.uint64)
        w[..., 7] %= top
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    x16, x32, x64 = words(1, 16384), words(1, 32768), words(64, 32768)
    flat = x32.reshape(-1, 8)
    r2 = torch.from_numpy(fr.ints_to_words([fr.R2_MOD_R])[0].copy()).to(dev)
    one = torch.from_numpy(fr.ints_to_words([1])[0].copy()).to(dev)
    for size, inverse in ((16384, True), (32768, False)):
        fr.twiddles(size, inverse, dev)  # built once, outside the timed calls

    if hasattr(fr, "ntt_words"):
        def das_transform():
            return fr.ntt_words(x32)
    else:
        def das_transform():
            mont = fr.fr_ops(fr.OP_MUL, flat, r2).reshape(x32.shape)
            return fr.fr_ops(fr.OP_MUL, fr.ntt(mont).reshape(-1, 8), one)
    return {
        "fr_ntt_1x16384_inv": (lambda: fr.ntt(x16, True), 50),
        "fr_ntt_1x32768": (lambda: fr.ntt(x32), 50),
        "fr_ntt_64x32768": (lambda: fr.ntt(x64), 10),
        "fr_ops_mul_32768": (lambda: fr.fr_ops(fr.OP_MUL, flat, r2), 50),
        "das_transform_32768": (das_transform, 50),
    }


def bls_rows(dev) -> dict:
    """{row: (fn, reps)} of K8's inverse, K9-K13 and K25 (the module
    docstring's shapes); builds their sources first."""
    import numpy as np
    import torch

    from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
    from consensus_specs_tpu_torch.crypto.bls_torch import zbits_from_ints
    from consensus_specs_tpu_torch.crypto import msm_synthetic
    from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
    from consensus_specs_tpu_torch.engine.convert import rns_from_words
    from consensus_specs_tpu_torch.kernels import build
    from consensus_specs_tpu_torch.ops import bls12 as B
    from consensus_specs_tpu_torch.ops import fp

    BUILT.update(build.build_all(("fp", "rlc", "pairing", "msm")))
    F1 = oracle.FP_FIELD
    rng = np.random.default_rng(0)
    sk0 = int(rng.integers(1, 2**62))
    pt, keys = oracle.pt_mul(F1, oracle.G1_GEN, sk0), []
    for _ in range(512):
        keys.append(oracle.pt_to_affine(F1, pt))
        pt = oracle.pt_add(F1, pt, oracle.G1_GEN)
    committee = B._jacobian_words(keys, 0, dev)
    hs = [hash_to_curve_g2(b"time_bls_kernels %d" % i) for i in range(8)]
    q8 = B.g2_to_words(hs)
    p_aff = B.g1_to_words(keys)
    z = zbits_from_ints([int(v) for v in rng.integers(1, 2**63, 1024, dtype=np.int64)]).to(dev)
    g1j, _ = B.rlc_ladders(torch.cat([p_aff, p_aff]).to(dev), None, z, affine_g1=False)
    _, g2j = B.rlc_ladders(None, q8[torch.arange(256) % 8].to(dev), z[:256])
    _, g2k = B.rlc_ladders(None, q8[torch.arange(1024) % 8].to(dev), z)
    rg2j, rg2k = (rns_from_words(t.cpu()).to(dev) for t in (g2j, g2k))
    msm = kzg_msm_args(msm_synthetic.kzg_inputs(seed=0), dev)
    seg16 = torch.arange(0, 1025, 16, device=dev)
    idx = torch.arange(513) % 8
    m = B.miller_loop(q8[idx].to(dev), p_aff[idx].to(dev))
    m1, m2 = m[:256].contiguous(), torch.roll(m, 3, 0)[:256].contiguous()
    r257, r1, r2 = (rns_from_words(t.cpu()).to(dev) for t in (m[:257], m1, m2))
    inv_in = torch.from_numpy(fp.ints_to_words(
        [int.from_bytes(rng.bytes(48), "little") % fp.P for _ in range(256)])).to(dev)
    f12 = torch.from_numpy(fp.ints_to_mont_words(
        [int.from_bytes(rng.bytes(48), "little") % fp.P for _ in range(12 * 1024)])).reshape(
        1024, 12, 12).to(dev)

    sigs = q8[torch.arange(1024) % 8].to(dev)
    pk1024 = torch.cat([p_aff, p_aff]).to(dev)
    mq = {b: q8[torch.arange(b) % 8].to(dev) for b in (257, 1025)}
    mp = {b: pk1024[torch.arange(b) % 512].contiguous() for b in (257, 1025)}
    rk, rs = (rns_from_words(t.cpu()).to(dev) for t in (pk1024, sigs))
    rmq = {b: rns_from_words(t.cpu()).to(dev) for b, t in mq.items()}
    rmp = {b: rns_from_words(t.cpu()).to(dev) for b, t in mp.items()}

    def ladders(k, s, n, affine=True):
        return lambda: B.rlc_ladders(None if k is None else k[:n], None if s is None else s[:n],
                                     z[:n], affine)

    return {
        "rlc_ladders_N256": (ladders(pk1024, sigs, 256), 3),
        "rlc_ladders_g1_N256": (ladders(pk1024, None, 256), 3),
        "rlc_ladders_g2_N256": (ladders(None, sigs, 256), 3),
        "rlc_ladders_gossip_N1024": (ladders(pk1024, sigs, 1024, False), 3),
        "rlc_ladders_rns_N256": (ladders(rk, rs, 256), 3),
        "rlc_ladders_rns_g1_N256": (ladders(rk, None, 256), 3),
        "rlc_ladders_rns_g2_N256": (ladders(None, rs, 256), 3),
        "rlc_ladders_rns_gossip_N1024": (ladders(rk, rs, 1024, False), 3),
        "miller_loop_B257": (lambda: B.miller_loop(mq[257], mp[257]), 3),
        "miller_loop_B1025": (lambda: B.miller_loop(mq[1025], mp[1025]), 3),
        "miller_loop_rns_B257": (lambda: B.miller_loop(rmq[257], rmp[257]), 3),
        "miller_loop_rns_B1025": (lambda: B.miller_loop(rmq[1025], rmp[1025]), 3),
        "fp_ops_inv_M256": (lambda: fp.fp_ops(fp.OP_INV, inv_in), 20),
        "point_sums_g1_aggregate_512": (lambda: B.g1_aggregate(committee), 20),
        "point_sums_g2_N256": (lambda: B.point_sums(g2j, torch.tensor([0, 256], device=dev)),
                               10),
        "point_sums_rns_g2_N256": (lambda: B.point_sums(rg2j, torch.tensor([0, 256], device=dev)),
                                   5),
        "point_sums_g2_N1024": (lambda: B.point_sums(g2k, torch.tensor([0, 1024], device=dev)),
                                10),
        "point_sums_rns_g2_N1024": (
            lambda: B.point_sums(rg2k, torch.tensor([0, 1024], device=dev)), 5),
        "point_sums_g1_64x16": (lambda: B.point_sums(g1j, seg16), 10),
        "g1_msm_128x64": (lambda: B.g1_msm(*msm["n=128 nbits=64"]), 5),
        "g1_msm_512x255": (lambda: B.g1_msm(*msm["n=512 nbits=255"]), 5),
        "final_exp_tail_B257": (lambda: B.final_exp_tail(m[:256], m[256]), 3),
        "final_exp_batch_256": (lambda: B.final_exp_batch(m1, m2), 3),
        "final_exp_rns_tail_B257": (lambda: B.final_exp_tail(r257[:256], r257[256]), 3),
        "final_exp_rns_batch_256": (lambda: B.final_exp_batch(r1, r2), 3),
        "f12_product_B256": (lambda: B.f12_product(f12[:256]), 5),
        "f12_product_B1024": (lambda: B.f12_product(f12), 5),
    }


if __name__ == "__main__":
    sys.exit(main())
