"""The port's mesh collectives (consensus_specs_tpu_torch/parallel/
collectives.py, row 16) on gloo ranks on the CPU, K25's plain version, and
[z]·(-G1) on K9.

One spawn of four ranks (`testlib/ranks.run_ranks`, workers in
`testlib/mesh_workers.collectives_ranks`) runs every mesh case: the G1 sum
on meshes of 1, 2 and 4 ranks, the ValueErrors, and the randomized checks on
two 2-rank meshes side by side, while this process computes the references
(the single-device `pairing_check_rlc`, the oracle's pairing products).
Every comparison is exact: canonical affine coordinates and booleans. Three
tests hold the three collectives against the JAX package's on its 8-device
CPU mesh, one a collective, at the smallest n of
tests/test_mesh_collectives.py: the G1 sum (which compiles no pairing) in
tier-1, the two randomized checks `slow` (JAX's mesh pairing programs
compile for more than 20 minutes on the CPU).
"""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls12_jax as K
from consensus_specs_tpu_torch.crypto import bls12_381 as oracle
from consensus_specs_tpu_torch.crypto.bls_torch import zbits_from_ints
from consensus_specs_tpu_torch.crypto.hash_to_curve import hash_to_curve_g2
from consensus_specs_tpu_torch.engine import convert
from consensus_specs_tpu_torch.ops import bls12 as B
from consensus_specs_tpu_torch.ops import fp
from consensus_specs_tpu_torch.parallel import collectives as C
from consensus_specs_tpu_torch.testlib import mesh_workers
from consensus_specs_tpu_torch.testlib.ranks import run_ranks

F1, F2 = oracle.FP_FIELD, oracle.FP2_FIELD
R = oracle.R
N_MULTIPLES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def limb_backend():
    K.set_field_backend("limb")
    yield
    K.set_field_backend("rns")


def _g1(k):
    return oracle.pt_to_affine(F1, oracle.pt_mul(F1, oracle.G1_GEN, k % R))


def _g2(h, k):
    return oracle.pt_to_affine(F2, oracle.pt_mul(F2, oracle.pt_from_affine(F2, h), k % R))


def _neg1(pt):
    return pt[0], (-pt[1]) % oracle.P


def _neg2(pt):
    return pt[0], tuple((-c) % oracle.P for c in pt[1])


HS = [hash_to_curve_g2(b"collectives %d" % i) for i in range(4)]
SKS = [1000 + 17 * i for i in range(8)]
ZS = [int(z) for z in np.random.default_rng(11).integers(1, 2**63, 8, dtype=np.int64)]
ZS[5], ZS[7] = ZS[4], ZS[6]


def _ungrouped_items():
    """8 valid (pk, H(m), sig) over 4 messages. Items 4-7 (rank 1's block
    on 2 ranks) are two pairs (pk, H, sig), (-pk, H, -sig) under equal z,
    so that rank's partial sum_i [z_i]·sig_i is infinity."""
    items = [(_g1(SKS[i]), HS[i], _g2(HS[i], SKS[i])) for i in range(4)]
    for j in (0, 1):
        pk, sig = _g1(SKS[4 + 2 * j]), _g2(HS[j], SKS[4 + 2 * j])
        items += [(pk, HS[j], sig), (_neg1(pk), HS[j], _neg2(sig))]
    return items


def _general_items():
    """8 items e([a]G1, H)·e([-c]G1, [a/c]H) == 1: the second pairing is
    not e(-G1, sig)."""
    out = []
    for i in range(8):
        a, c = SKS[i], 7 + 3 * i
        out.append((_g1(a), HS[i % 4], _g1(-c), _g2(HS[i % 4], a * pow(c, -1, R))))
    return out


def _words(p1s, q1s, p2s, q2s, zs):
    return (B.g2_to_words(q1s), B.g1_to_words(p1s), B.g2_to_words(q2s), B.g1_to_words(p2s),
            zbits_from_ints(zs))


def _ungrouped_cases() -> dict:
    items = _ungrouped_items()
    pks, hs, sigs = (list(col) for col in zip(*items))
    bad_sigs = list(sigs)
    bad_sigs[1] = sigs[2]
    gen = _general_items()
    g_p1, g_q1, g_p2, g_q2 = (list(col) for col in zip(*gen))
    g_bad = list(g_q2)
    g_bad[2] = g_q2[3]
    neg = [B.NEG_G1] * 8
    return {"neg_valid": (*_words(pks, hs, neg, sigs, ZS), True),
            "neg_tampered": (*_words(pks, hs, neg, bad_sigs, ZS), True),
            "general_valid": (*_words(g_p1, g_q1, g_p2, g_q2, ZS), False),
            "general_tampered": (*_words(g_p1, g_q1, g_p2, g_bad, ZS), False)}


def _grouped_cases() -> dict:
    """D = 4 messages, 8 items two a group; `bad` has item 5 carrying item
    4's signature; `empty` leaves group 2 without a member (its items signed
    for message 3 instead), every item valid."""
    def case(seg, sigs=None):
        sks = SKS
        sigs = sigs or [_g2(HS[g], sk) for g, sk in zip(seg, sks)]
        return (B.g2_to_words(HS), B.g1_to_words([_g1(k) for k in sks]), B.g2_to_words(sigs),
                zbits_from_ints(ZS), torch.tensor(seg, dtype=torch.int64))

    seg = [0, 0, 1, 1, 2, 2, 3, 3]
    sigs = [_g2(HS[g], sk) for g, sk in zip(seg, SKS)]
    bad = list(sigs)
    bad[5] = sigs[4]
    return {"valid": case(seg, sigs), "bad": case(seg, bad),
            "empty": case([0, 0, 1, 1, 3, 3, 3, 3])}


def _g1_cases() -> dict:
    pts, _ = C.g1_small_multiples(N_MULTIPLES, "cpu")
    # [1]G, -[1]G, then [3]G .. [8]G: rank 0's block on 2 ranks and on 4
    # ranks sums to infinity
    cancel = torch.cat([pts[:1], C.jacobian_from_affine(B.g1_to_words([_neg1(_g1(1))])),
                        pts[2:8]])
    return {"multiples": pts, "cancel": cancel}


def _oracle_product(rows) -> bool:
    """The oracle's prod_i e(P1_i, Q1_i)·e(P2_i, Q2_i) == 1 (one final
    exponentiation)."""
    f = oracle.F12_ONE
    for p1, q1, p2, q2 in rows:
        f = oracle.f12_mul(f, oracle.pairing(q1, p1, final_exp=False))
        f = oracle.f12_mul(f, oracle.pairing(q2, p2, final_exp=False))
    return oracle.final_exponentiation(f) == oracle.F12_ONE


@pytest.fixture(scope="module")
def mesh_run():
    ungrouped, grouped, g1 = _ungrouped_cases(), _grouped_cases(), _g1_cases()

    def references():
        refs = {name: bool(B.pairing_check_rlc(q1, p1, q2, zb))
                for name, (q1, p1, q2, _, zb, neg) in ungrouped.items() if neg}
        gen = _general_items()
        bad = [list(r) for r in gen]
        bad[2][3] = gen[3][3]
        refs["general_valid"] = _oracle_product(gen)
        refs["general_tampered"] = _oracle_product(bad)
        return refs

    ranks, refs = run_ranks(mesh_workers.collectives_ranks, 4, "gloo", "cpu", g1, ungrouped,
                            grouped, meanwhile=references)
    return ranks, refs


@pytest.mark.parametrize("case", ["multiples", "cancel"])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_g1_mesh_sum_matches_oracle(mesh_run, case, size):
    ranks, _ = mesh_run
    k = N_MULTIPLES * (N_MULTIPLES + 1) // 2 if case == "multiples" else sum(range(3, 9))
    want = _g1(k)
    assert [r["g1"][case][size] for r in ranks] == [want] * 4


def test_g1_mesh_sum_shard_of_infinity():
    """The cancelling case's first block really sums to infinity, which
    K10 gives as (0, 0) and `jacobian_from_affine` takes back to Z = 0."""
    pts = _g1_cases()["cancel"]
    part = B.point_sums(pts[:2], torch.tensor([0, 2]))
    assert not bool(part.any())
    jac = C.jacobian_from_affine(part)
    assert not bool(jac[:, 2].any())
    one = C.jacobian_from_affine(B.point_sums(pts[2:3], torch.tensor([0, 1])))
    assert torch.equal(one[0, 2], torch.from_numpy(fp.ints_to_mont_words([1])[0]))


def test_ungrouped_rank_partial_is_infinity():
    """The valid batch's block of rank 1 (items 4-7 on 2 ranks) has
    sum_i [z_i]·sig_i = infinity, by the oracle."""
    acc = None
    for (_, _, sig), z in list(zip(_ungrouped_items(), ZS))[4:]:
        acc = oracle.pt_add(F2, acc, oracle.pt_mul(F2, oracle.pt_from_affine(F2, sig), z))
    assert acc is None or oracle.pt_to_affine(F2, acc) is None


@pytest.mark.parametrize("name", ["neg_valid", "neg_tampered"])
def test_rlc_mesh_matches_single_device(mesh_run, name):
    ranks, refs = mesh_run
    assert refs[name] is (name == "neg_valid")
    assert [r["ungrouped"][name] for r in ranks[:2]] == [refs[name]] * 2


@pytest.mark.parametrize("name", ["general_valid", "general_tampered"])
def test_rlc_mesh_general_matches_oracle(mesh_run, name):
    ranks, refs = mesh_run
    assert refs[name] is (name == "general_valid")
    assert [r["ungrouped"][name] for r in ranks[:2]] == [refs[name]] * 2


@pytest.mark.parametrize("name,want", [("valid", True), ("bad", False), ("empty", False)])
def test_rlc_grouped_mesh_verdicts(mesh_run, name, want):
    ranks, _ = mesh_run
    assert [r["grouped"][name] for r in ranks[2:]] == [want] * 2


@pytest.mark.parametrize("what", ["g1_n", "rlc_n", "grouped_d", "grouped_n"])
def test_mesh_value_errors(mesh_run, what):
    ranks, _ = mesh_run
    assert [r["raises"][what] for r in ranks] == [True] * 4


def _f12_values(seed, n):
    rng = np.random.default_rng(seed)
    ints = [int.from_bytes(rng.bytes(48), "little") % oracle.P for _ in range(12 * n)]
    return torch.from_numpy(fp.ints_to_mont_words(ints)).reshape(n, 12, fp.NWORDS)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_f12_product_matches_fold_and_jax(limb_backend, n):
    m = _f12_values(20 + n, n)
    got = B.f12_product(m)
    assert got.shape == (12, fp.NWORDS) and torch.equal(got, B.f12_product_plain(m))
    acc = B._f12_limbs(m[0])
    for k in range(1, n):
        acc = B.f12_mul(acc, B._f12_limbs(m[k]))
    assert torch.equal(got, B._f12_words(acc))
    if n == 3:  # JAX's eager tree costs seconds a level on the CPU
        want = K.f12_prod_reduce(convert.f12_to_jax(m))
        assert torch.equal(got, convert.f12_from_jax(want)[0])
    with pytest.raises(ValueError):
        B.f12_product(m[:0])


def test_g1_fixed_mul_neg_g1_matches_oracle_and_jax(limb_backend):
    zs = [1, 2, 2**64 - 1, 0] + [int(z) for z in np.random.default_rng(3).integers(
        1, 2**63, 4, dtype=np.int64)]
    jac = B.g1_fixed_mul_neg_g1(zbits_from_ints(zs))
    aff = B.affine_from_words(B.point_sums(jac, torch.arange(len(zs) + 1)), False)
    want = [_g1(-z) if z % R else (0, 0) for z in zs]
    assert aff == want
    bits = np.array([[(z >> i) & 1 for i in range(64)] for z in zs], dtype=bool)
    # JAX caches its window tables in the field backend of the first call:
    # build them on the limb field here, and leave no limb tables behind
    K._neg_g1_window_tables.cache_clear()
    try:
        x, y = K._g1_jacobian_to_affine_batch(K.g1_fixed_mul_neg_g1(bits))
    finally:
        K._neg_g1_window_tables.cache_clear()
    theirs = torch.stack([convert.fp_from_jax_limbs(x), convert.fp_from_jax_limbs(y)], 1)
    assert B.affine_from_words(theirs, False) == want


def _jax_pairing_words(qx, qy, px, py):
    """JAX limb-backend pairing arguments -> the port's (Q, P) words."""
    q = torch.stack([convert.f2_from_jax(qx), convert.f2_from_jax(qy)], 1)
    p = torch.stack([convert.fp_from_jax_limbs(px), convert.fp_from_jax_limbs(py)], 1)
    return q, p


def _jax_mesh():
    import jax

    from consensus_specs_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:8])


def _jax_zbits(n):
    """(n scalars as ints, JAX's (n, 64) bool bits of them): one seeded draw
    for every collective's comparison."""
    zs = [int(z) for z in np.random.default_rng(13).integers(1, 2**63, 32, dtype=np.int64)][:n]
    return zs, np.array([[(z >> i) & 1 for i in range(64)] for z in zs], dtype=bool)


def _swapped(px, py, at):
    """One item's G1 coordinates swapped (tests/test_mesh_collectives.py's
    tampering)."""
    import jax

    px, py = np.asarray(px).copy(), np.asarray(py).copy()
    px[at], py[at] = py[at].copy(), px[at].copy()
    return jax.numpy.asarray(px), jax.numpy.asarray(py)


# The port's collectives held against the JAX package's on its 8-device CPU
# mesh, one test a collective, on the inputs of tests/test_mesh_collectives.py
# (its smallest n) carried across as words; the port runs on gloo ranks while
# this process runs JAX's program. The G1 sum compiles no pairing and comes
# first.


def test_g1_mesh_sum_matches_jax_on_its_mesh(limb_backend):
    """`g1_mesh_sum` of [1]G .. [32]G on 1, 2 and 4 gloo ranks equals JAX's
    `g1_mesh_sum` on its 8-device mesh (n = 32, the smallest n of
    tests/test_mesh_collectives.py)."""
    from consensus_specs_tpu.parallel import collectives as JC

    pts, _ = C.g1_small_multiples(32, "cpu")

    def jax_sum():
        jpts, _ = JC.g1_small_multiples(32)
        gx, gy = K.g1_to_affine(JC.g1_mesh_sum(jpts, _jax_mesh()))
        return K.F.from_mont_int(np.asarray(gx)), K.F.from_mont_int(np.asarray(gy))

    ranks, j_sum = run_ranks(mesh_workers.g1_sum_ranks, 4, "gloo", "cpu", {"multiples": pts},
                             meanwhile=jax_sum)
    assert j_sum == _g1(32 * 33 // 2)
    for r in ranks:
        assert set(r["multiples"].values()) == {j_sum}


@pytest.mark.slow
def test_pairing_check_rlc_mesh_matches_jax_on_its_mesh(limb_backend):
    """`pairing_check_rlc_mesh` on 2 gloo ranks against JAX's on its mesh:
    n = 16 over 4 messages, both forms (P2 = -G1 collapsed, and general),
    valid and with item 3's pubkey coordinates swapped."""
    import jax

    from consensus_specs_tpu.crypto.bls_jax import bench_pairing_args
    from consensus_specs_tpu.parallel import collectives as JC

    n = 16
    zs, jz = _jax_zbits(n)
    qx, qy, px, py, q2x, q2y, p2x, p2y = bench_pairing_args(n, distinct=4)
    cases, jax_args = {}, {}
    for tag, (ax, ay) in (("valid", (px, py)), ("swapped", _swapped(px, py, 3))):
        for neg in (True, False):
            name = f"{tag}_{'neg' if neg else 'general'}"
            jax_args[name] = (qx, qy, ax, ay, neg)
            q1, p1 = _jax_pairing_words(qx, qy, ax, ay)
            q2, p2 = _jax_pairing_words(q2x, q2y, p2x, p2y)
            cases[name] = (q1, p1, q2, p2, zbits_from_ints(zs), neg)

    def jax_verdicts():
        mesh = _jax_mesh()
        return {name: bool(np.asarray(JC.pairing_check_rlc_mesh(
            mesh, a, b, c, d, q2x, q2y, p2x, p2y, jax.numpy.asarray(jz), p2_is_neg_g1=neg)))
            for name, (a, b, c, d, neg) in jax_args.items()}

    ranks, want = run_ranks(mesh_workers.mesh_check_ranks, 2, "gloo", "cpu", "rlc", cases,
                            meanwhile=jax_verdicts)
    assert want == {"valid_neg": True, "valid_general": True, "swapped_neg": False,
                    "swapped_general": False}
    for r in ranks:
        assert r == want


@pytest.mark.slow
def test_pairing_check_rlc_grouped_mesh_matches_jax_on_its_mesh(limb_backend):
    """`pairing_check_rlc_grouped_mesh` on 2 gloo ranks against JAX's on its
    mesh: n = 32 over D = 8 messages, valid and with item 11's pubkey
    coordinates swapped."""
    import jax

    from consensus_specs_tpu.crypto.bls_jax import bench_grouped_pairing_args
    from consensus_specs_tpu.parallel import collectives as JC

    zs, jz = _jax_zbits(32)
    (gqx, gqy, gpx, gpy, gq2x, gq2y), seg = bench_grouped_pairing_args(32, 8)
    cases, jax_args = {}, {}
    for tag, (ax, ay) in (("valid", (gpx, gpy)), ("swapped", _swapped(gpx, gpy, 11))):
        jax_args[tag] = (ax, ay)
        q1 = torch.stack([convert.f2_from_jax(gqx), convert.f2_from_jax(gqy)], 1)
        q2, p1 = _jax_pairing_words(gq2x, gq2y, ax, ay)
        cases[tag] = (q1, p1, q2, zbits_from_ints(zs), torch.from_numpy(np.asarray(seg)))

    def jax_verdicts():
        mesh = _jax_mesh()
        return {tag: bool(np.asarray(JC.pairing_check_rlc_grouped_mesh(
            mesh, gqx, gqy, ax, ay, gq2x, gq2y, jax.numpy.asarray(jz), seg)))
            for tag, (ax, ay) in jax_args.items()}

    ranks, want = run_ranks(mesh_workers.mesh_check_ranks, 2, "gloo", "cpu", "grouped", cases,
                            meanwhile=jax_verdicts)
    assert want == {"valid": True, "swapped": False}
    for r in ranks:
        assert r == want
