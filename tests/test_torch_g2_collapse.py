"""K10's G2 collapse on the CPU: the plain version in the kernel's order
(`segment_sums_limbs` over `g2_sum_units(N)` units) against JAX's
`g2_sum_reduce` -> `g2_jacobian_to_affine`, the same words in the limb
field and equal mod p over RNS (its residues are redundant), at N that
give one unit (5), a partial last round (27: 4 units) and the levels the
card's limb instance runs across blocks (64: 16 units, two blocks), with P +
P and P + (-P) meeting in a unit's fold, at the tree's first level and at
its last, random points with infinity among them, and all at infinity
(`crypto/msm_synthetic.g2_sum_cases`); and the affine step's group programs
(`aff_norm`, the inverse, `aff_out`) bit-equal to the plain affine image in
both fields. The card-only tests hold the kernel to this plain version.
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu_torch.crypto import msm_synthetic
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import bls12_programs as programs
from consensus_specs_tpu_torch.ops import fp_rns as R


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def backend(request):
    """JAX's field as the test asks, restored after (the backend is module
    state; the default is "rns")."""
    saved = K.field_backend()
    K.set_field_backend(request.param)
    yield request.param
    K.set_field_backend(saved)


def test_g2_sum_units():
    """A power of two at most N / 4, in [1, 256]: about four points a unit."""
    want = {0: 1, 1: 1, 7: 1, 8: 2, 27: 4, 64: 16, 70: 16, 256: 64, 1023: 128, 1024: 256,
            4096: 256}
    assert {n: B.g2_sum_units(n) for n in want} == want


def _jax_sum(pts, field):
    """JAX's sum and affine image of Jacobian G2 words or residues (N, 3, 2,
    w) -> (2, 2, w) in the same form."""
    if field == "limb":
        jp = tuple(convert.f2_to_jax(pts[:, c]) for c in range(3))
        ax, ay = K.g2_jacobian_to_affine(K.g2_sum_reduce(jp))
        return torch.stack([convert.f2_from_jax(ax), convert.f2_from_jax(ay)])
    jp = tuple((convert.rns_to_jax(pts[:, c, 0]), convert.rns_to_jax(pts[:, c, 1]))
               for c in range(3))
    ax, ay = K.g2_jacobian_to_affine(K.g2_sum_reduce(jp))
    return torch.stack([torch.stack([convert.rns_from_jax(np.asarray(c)) for c in v], -2)
                        for v in (ax, ay)])


CASES = [(field, n, case) for field in ("limb", "rns") for n in (5, 27, 64)
         for case in ("random", "infinity", "fold", "tree", "last_double", "last_cancel")
         if (case != "tree" or n >= 16) and (case not in ("last_double", "last_cancel") or n >= 8)
         and (field == "limb" or n > 5)]


@pytest.mark.parametrize("backend,n,case", [(f, n, c) for f, n, c in CASES],
                         indirect=["backend"])
def test_g2_collapse_matches_jax(backend, n, case):
    pts = msm_synthetic.g2_sum_cases(n, B.g2_sum_units(n), n)[case]
    if backend == "rns":
        pts = convert.rns_from_words(pts)
    got = B.point_sums_plain(pts, torch.tensor([0, n]))
    assert got.shape == (1, 2, 2, pts.shape[-1])
    want = _jax_sum(pts, backend)
    if backend == "limb":
        assert torch.equal(got[0], want)
        values = got[0].flatten().tolist()
    else:
        values = R.mont_batch_to_ints(got[0])
        assert values == R.mont_batch_to_ints(want)
    if case in ("infinity", "last_cancel"):
        assert not any(values)  # (0, 0)


@pytest.mark.parametrize("field", ["limb", "rns"])
def test_g2_affine_programs_match_plain(field):
    """`aff_norm`, one unit's inverse and `aff_out` played over the plain
    field give the plain affine image's words or residues, infinity's (0, 0)
    too."""
    pts = msm_synthetic.g2_sum_cases(8, 2, 3)["random"]
    if field == "rns":
        pts = convert.rns_from_words(pts)
    F = B.word_field(pts.shape[-1])
    want = F.from_plain(B.jac_to_affine(B._Fp2, F.to_plain(pts)))
    got = programs.g2_affine_mirror(pts)
    assert torch.equal(got, want)
    # entry 3 is at infinity: (0, 0)
    assert not any(R.mont_batch_to_ints(got[3]) if field == "rns" else got[3].flatten().tolist())
