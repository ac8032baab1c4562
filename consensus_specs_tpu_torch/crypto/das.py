"""Data-availability sampling: erasure extension, recovery, sample checks.

The port's copy of the JAX package's crypto/das.py, with the same public
names. Reference parity: specs/das/das-core.md — reverse-bit-order sample
layout (:66-77), `das_fft_extension` (:90-107), `recover_data` (:108-130),
`check_multi_kzg_proof` (:131-137), `sample_data` / `verify_sample` /
`reconstruct_extended_data` (:154-186).

Model: a blob is n field elements, viewed as evaluations of a degree-<n
polynomial P on the even-indexed 2n-th roots of unity (= the n-th roots).
Extension doubles it to evaluations on ALL 2n-th roots; any n of the 2n
points recover P (Reed-Solomon rate 1/2, the spec's
DATA_AVAILABILITY_INVERSE_CODING_RATE = 2). Samples are
POINTS_PER_SAMPLE-sized cosets in reverse-bit-order layout so each sample is
contiguous AND forms a multiplicative coset — the property `verify_sample`'s
multi-KZG check relies on.

Device mapping: every NTT (the extension's two, recovery's six at n2) runs
through `ops/fr.ntt_ints` on `device`: the Montgomery conversions on K23,
the transform on K22 on "cuda" (the default; raises without a card), the
plain versions on "cpu". A failed launch raises; nothing falls back to the
host. `use_device=False` keeps the reference's O(n^2) `host_ntt`. The
zero polynomial (O(missing^2)) and recovery's pointwise products stay on
the host, as in the reference; recovery's n2 inversions on the coset run
as one K23 `inv` on `device` (the reference's `pow(z, r - 2, r)` a point
costs about 0.2 ms of host time each, seconds at mainnet width).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..ops import fr
from ..ops.fr_host import R_MODULUS as MODULUS
from ..ops.fr_host import host_ntt, root_of_unity
from . import kzg


def _ntt(values: list[int], inverse: bool, use_device: bool, device) -> list[int]:
    """One NTT of a list of ints: K23 + K22 (or their plain versions) on
    `device`, or the host DFT with use_device=False."""
    if use_device:
        return fr.ntt_ints(values, inverse, device)
    return host_ntt(values, inverse=inverse)

# --- reverse-bit-order layout (das-core.md:66-77) ---------------------------


def reverse_bit_order(n: int) -> list[int]:
    """Permutation mapping natural index -> reverse-bit-order position."""
    assert n & (n - 1) == 0
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]


def to_rbo(values: list[int]) -> list[int]:
    perm = reverse_bit_order(len(values))
    return [values[perm[i]] for i in range(len(values))]


def from_rbo(values: list[int]) -> list[int]:
    perm = reverse_bit_order(len(values))
    out = [0] * len(values)
    for i in range(len(values)):
        out[perm[i]] = values[i]
    return out


# --- extension (das-core.md:90-107) -----------------------------------------


def data_to_coeffs(data: list[int], use_device: bool = True, device="cuda") -> list[int]:
    """Coefficients of the degree-<n polynomial through the blob's evals
    (one inverse NTT; shared by extension and commitment so each runs once)."""
    return _ntt(data, True, use_device, device)


def _extension_from_coeffs(coeffs: list[int], use_device: bool, device="cuda") -> list[int]:
    """Odd-root evaluations from coefficient form: zero-pad to 2n, NTT on the
    doubled domain, take odd positions (even positions reproduce the data —
    asserted in tests)."""
    n = len(coeffs)
    padded = coeffs + [0] * n
    return _ntt(padded, False, use_device, device)[1::2]


def das_fft_extension(data: list[int], use_device: bool = True, device="cuda") -> list[int]:
    """Given P's evaluations on the even 2n-th roots (w^0, w^2, ...), return
    its evaluations on the odd 2n-th roots (w^1, w^3, ...)."""
    return _extension_from_coeffs(data_to_coeffs(data, use_device, device), use_device, device)


def extend_data(data: list[int], use_device: bool = True, device="cuda") -> list[int]:
    """Interleave original (even positions) and extension (odd positions) to
    the full 2n-point evaluation vector in natural domain order."""
    odd = das_fft_extension(data, use_device, device)
    out = []
    for e, o in zip(data, odd):
        out.extend((e, o))
    return out


# --- recovery (das-core.md:108-130) -----------------------------------------


def _zero_poly(missing: list[int], n2: int) -> list[int]:
    """Coefficients of Z(x) = prod_{i in missing} (x - w^i) over the 2n domain."""
    w = root_of_unity(n2)
    coeffs = [1]
    for i in missing:
        root = pow(w, i, MODULUS)
        nxt = [0] * (len(coeffs) + 1)
        for j, c in enumerate(coeffs):
            nxt[j + 1] = (nxt[j + 1] + c) % MODULUS
            nxt[j] = (nxt[j] - c * root) % MODULUS
        coeffs = nxt
    return coeffs


def recover_data(samples: dict[int, int], n2: int, use_device: bool = True,
                 device="cuda") -> list[int]:
    """Recover all n2 = 2n evaluations from any >= n of them.

    samples: {natural-domain index -> value}. Standard zero-poly technique:
    with Z vanishing on the missing set, (D·Z) is known everywhere (zero at
    missing points), so interpolate E = D·Z, then D = E/Z evaluated via a
    coset where Z never vanishes."""
    assert len(samples) >= n2 // 2, "not enough samples to recover"
    missing = [i for i in range(n2) if i not in samples]
    if not missing:
        return [samples[i] for i in range(n2)]

    def ntt(vals, inverse=False):
        return _ntt(vals, inverse, use_device, device)

    z_coeffs = _zero_poly(missing, n2)
    z_coeffs_padded = z_coeffs + [0] * (n2 - len(z_coeffs))
    z_evals = ntt(z_coeffs_padded)
    # E(w^i) = D(w^i)·Z(w^i); zero wherever D is unknown (Z vanishes there)
    e_evals = [(samples.get(i, 0) * z_evals[i]) % MODULUS for i in range(n2)]
    e_coeffs = ntt(e_evals, inverse=True)
    # move to coset g·w^i (g any non-root): scale coeffs by g^k
    g = 7
    scale, gs = 1, []
    for _ in range(n2):
        gs.append(scale)
        scale = scale * g % MODULUS
    e_coset = ntt([c * s % MODULUS for c, s in zip(e_coeffs, gs)])
    z_coset = ntt([c * s % MODULUS for c, s in zip(z_coeffs_padded, gs)])
    if use_device:  # the n2 inversions in one K23 launch (zero maps to zero, as pow's)
        z_inv = fr.inv_ints(z_coset, device)
    else:
        z_inv = [pow(z, MODULUS - 2, MODULUS) for z in z_coset]
    d_coset = [e * zi % MODULUS for e, zi in zip(e_coset, z_inv)]
    d_coeffs_scaled = ntt(d_coset, inverse=True)
    g_inv = pow(g, MODULUS - 2, MODULUS)
    scale, d_coeffs = 1, []
    for c in d_coeffs_scaled:
        d_coeffs.append(c * scale % MODULUS)
        scale = scale * g_inv % MODULUS
    # Rate-1/2 RS consistency: valid inputs interpolate to a degree-<n
    # polynomial; any corrupted/inconsistent sample generically leaks into
    # the top half of the coefficients. This is the real integrity check —
    # matching back the provided samples alone is NOT sufficient (the coset
    # quotient agrees with them by construction on most index sets).
    assert all(c == 0 for c in d_coeffs[n2 // 2 :]), "samples inconsistent (not a rate-1/2 codeword)"
    recovered = ntt(d_coeffs)
    for i, v in samples.items():
        assert recovered[i] == v % MODULUS, "recovery inconsistent with provided samples"
    return recovered


# --- sampling (das-core.md:131-186) -----------------------------------------


@dataclass(frozen=True)
class Sample:
    """One publishable sample: a contiguous run of POINTS_PER_SAMPLE values in
    reverse-bit-order layout (= one multiplicative coset) plus its KZG
    multiproof."""

    index: int
    values: tuple
    proof: object  # G1 point


def sample_cosets(n2: int, points_per_sample: int) -> list[tuple[int, list[int]]]:
    """(coset_shift, natural-domain indices) per sample. In reverse-bit-order
    layout, sample k covers rbo positions [k·m, (k+1)·m) whose natural indices
    form the coset w2n^rev(k)·H with H the (n2/m)-stride subgroup."""
    m = points_per_sample
    perm = reverse_bit_order(n2)
    inv = [0] * n2
    for i, p in enumerate(perm):
        inv[p] = i
    w = root_of_unity(n2)
    out = []
    for k in range(n2 // m):
        idxs = [inv[k * m + j] for j in range(m)]
        # all idxs share residue class structure: idxs = {base + t·(n2/m)}
        shift = pow(w, min(idxs), MODULUS)
        out.append((shift, idxs))
    return out


def sample_data(setup: kzg.KZGSetup, data: list[int], points_per_sample: int,
                use_device: bool = True, device="cuda") -> tuple[bytes, list[Sample]]:
    """Extend the blob, commit to it, and emit all samples with multiproofs
    (das-core.md `sample_data` :154-168)."""
    n = len(data)
    # one INTT serves both the extension and the commitment
    coeffs = data_to_coeffs(data, use_device, device)
    odd = _extension_from_coeffs(coeffs, use_device, device)
    full = []
    for e, o in zip(data, odd):
        full.extend((e, o))
    n2 = 2 * n
    commitment = kzg.commit(setup, coeffs)
    samples = []
    for k, (shift, idxs) in enumerate(sample_cosets(n2, points_per_sample)):
        # order values by ascending power within the coset so they line up
        # with the interpolation domain {shift·w_m^j}
        m = len(idxs)
        stride = n2 // m
        base = min(idxs)
        ordered = [full[(base + t * stride) % n2] for t in range(m)]
        proof, ys = kzg.prove_coset(setup, coeffs, shift, m)
        assert ys == ordered, "coset layout mismatch"
        samples.append(Sample(index=k, values=tuple(ordered), proof=proof))
    return commitment, samples


def verify_sample(setup: kzg.KZGSetup, commitment, sample: Sample, n2: int,
                  points_per_sample: int) -> bool:
    """`verify_sample` (das-core.md:169-176): one multi-KZG check per sample.

    Sample contents are untrusted network input: wrong index or wrong value
    count is a clean rejection (a short values tuple must not be allowed to
    verify against a smaller coset than the index claims)."""
    if len(sample.values) != points_per_sample:
        return False
    cosets = sample_cosets(n2, points_per_sample)
    if not 0 <= sample.index < len(cosets):
        return False
    shift, _ = cosets[sample.index]
    return kzg.verify_coset(setup, commitment, shift, list(sample.values), sample.proof)


def reconstruct_extended_data(samples: list[Sample], n2: int, points_per_sample: int,
                              use_device: bool = True, device="cuda") -> list[int]:
    """`reconstruct_extended_data` (das-core.md:177-186): scatter sample values
    back to natural-domain indices and run recovery."""
    cosets = sample_cosets(n2, points_per_sample)
    known: dict[int, int] = {}
    for s in samples:
        # untrusted input: reject bad indices/shapes instead of crashing or
        # (negative index) silently scattering to the wrong coset
        if not 0 <= s.index < len(cosets):
            raise ValueError(f"sample index {s.index} out of range")
        if len(s.values) != points_per_sample:
            raise ValueError(f"sample {s.index} has {len(s.values)} values, want {points_per_sample}")
        shift, idxs = cosets[s.index]
        stride = n2 // points_per_sample
        base = min(idxs)
        for t, v in enumerate(s.values):
            known[(base + t * stride) % n2] = v
    return recover_data(known, n2, use_device, device)
