"""Mesh collectives for curve-group values (counterpart of
parallel/collectives.py, row 16 of the port's kernel table).

G1 addition is a group law and the Fp12 product a field product, so no
additive all-reduce computes them: each rank reduces its block with the
single-device kernels, ONE all_gather moves the w partials (a few hundred
bytes a rank), and every rank finishes the tail replicated. Every rank
passes the full input arrays and takes its own contiguous block, as JAX's
`device_put` onto P(DATA_AXIS) does; the result is on every rank.

Device work, each rank, on the limb kernels under either field backend
(the inputs are 12-word Montgomery limbs):
- `g1_mesh_sum`: K10 over the block's 512-point segments, then K10 over
  those partials, the gather, K10 over the w partials;
- `pairing_check_rlc_mesh`: K9 (the z ladders), K10 (the block's
  sum_i [z_i]·sig_i), K11 (the block's Miller loops), K25 (their product,
  no exponentiation); the Fp12 partials and the G2 partial points ride one
  gather; then K10 and K11 once for e(-G1, sum z_i·sig_i) and K12's tail;
  the general form (p2 not -G1) gathers K25's partials and runs K12's tail
  over them;
- `pairing_check_rlc_grouped_mesh`: K9 on the block's items, one gather of
  the N randomized Jacobian G1 points (with the G2 partial), K10 over this
  rank's groups [r·D/w, (r+1)·D/w) only, K11 over them and the one G2
  pair, K25, a gather of the Fp12 partials (with each rank's empty-group
  verdict, ANDed), K12's tail.
The transport is the mesh's backend (parallel/mesh.MeshComm).
"""
from __future__ import annotations

import torch

from ..crypto import bls12_381 as oracle
from ..ops import bls12 as B
from ..ops import fp
from ..utils.device import resolve_device
from .mesh import MeshComm, block_bounds

NWORDS = fp.NWORDS
SEGMENT = 512  # points a K10 block sums in g1_mesh_sum's first pass
_F12 = 12 * NWORDS


def _one(device) -> torch.Tensor:
    return torch.from_numpy(fp.ints_to_mont_words([1])[0]).to(device)


def jacobian_from_affine(aff: torch.Tensor) -> torch.Tensor:
    """Affine words -> Jacobian with Z = 1, and (0, 0), K10's image of
    infinity (no curve point: 0 != 0 + b), -> Z = 0. G1 (k, 2, 12) ->
    (k, 3, 12); G2 (k, 2, 2, 12) -> (k, 3, 2, 12)."""
    one = _one(aff.device)
    z = torch.stack([one, torch.zeros_like(one)]) if aff.dim() == 4 else one
    z = z.expand(aff.shape[0], *z.shape).clone()
    z[(aff.reshape(aff.shape[0], -1) == 0).all(1)] = 0
    return torch.cat([aff, z[:, None]], 1).contiguous()


def _sum(jac: torch.Tensor) -> torch.Tensor:
    """The affine sum of Jacobian points (K10 over one segment)."""
    whole = torch.tensor([0, jac.shape[0]], dtype=torch.int64, device=jac.device)
    return B.point_sums(jac, whole)[0]


def g1_mesh_sum(pts: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of N Jacobian G1 points (N, 3, 12), N divisible by the mesh's
    ranks, as affine words (2, 12) on every rank ((0, 0) for infinity).
    JAX returns the Jacobian sum: compare in affine."""
    comm = MeshComm(mesh)
    pts = B._check("g1_mesh_sum", pts, (3, NWORDS))
    lo, hi = block_bounds(pts.shape[0], comm, "points")
    local = pts[lo:hi]
    if local.shape[0] > SEGMENT:  # every SM works: a K10 block a segment
        offsets = torch.arange(0, local.shape[0] + SEGMENT, SEGMENT, device=pts.device)
        local = jacobian_from_affine(B.point_sums(local, offsets.clamp_(max=local.shape[0])))
    return _sum(jacobian_from_affine(comm.all_gather(_sum(local))))


def g1_small_multiples(n: int, device="cuda"):
    """(Jacobian words (n, 3, 12) of [1]G .. [n]G with Z = 1, their affine
    int pairs): the collectives' shared fixture, from the port's oracle."""
    F1 = oracle.FP_FIELD
    affs, acc = [], oracle.G1_GEN
    for _ in range(n):
        affs.append(oracle.pt_to_affine(F1, acc))
        acc = oracle.pt_add(F1, acc, oracle.G1_GEN)
    aff = B.g1_to_words(affs).to(resolve_device(device))
    return jacobian_from_affine(aff), affs


def pairing_check_rlc_mesh(mesh, q1, p1, q2, p2, zbits, p2_is_neg_g1: bool = False):
    """The randomized batch check sharded over the mesh's ranks:

        prod_i e([z_i]·P1_i, Q1_i) · e([z_i]·P2_i, Q2_i) final-exponentiated == 1

    Q1, Q2 (N, 2, 2, 12), P1, P2 (N, 2, 12) affine, zbits (N, 2) int32
    nonzero scalar words; N divisible by the ranks. With `p2_is_neg_g1` the
    second pairings collapse by bilinearity into e(-G1, sum_i [z_i]·Q2_i)
    (P2 is not read). A 0-d bool on every rank, equal to the single-device
    `ops.bls12.pairing_check_rlc` on the same inputs."""
    comm = MeshComm(mesh)
    lo, hi = block_bounds(zbits.shape[0], comm, "items")
    q1l, p1l, q2l, zl = (t[lo:hi].contiguous() for t in (q1, p1, q2, zbits))
    if p2_is_neg_g1:
        a1, zsig = B.rlc_ladders(p1l, q2l, zl, affine_g1=True)
        f_part = B.f12_product(B.miller_loop(q1l, a1))
        got = comm.all_gather(torch.cat([f_part.reshape(-1), _sum(zsig).reshape(-1)]))
        aq = _sum(jacobian_from_affine(got[:, _F12:].reshape(-1, 2, 2, NWORDS)))
        m2 = B.miller_loop(aq[None], B.neg_g1_words(aq.device)[None])
        return B.rlc_tail(got[:, :_F12].reshape(-1, 12, NWORDS), m2[0])
    p2l = p2[lo:hi].contiguous()
    a = B.rlc_ladders(torch.cat([p1l, p2l]), None, torch.cat([zl, zl]))[0]
    fs = comm.all_gather(B.f12_product(B.miller_loop(torch.cat([q1l, q2l]), a)))
    return B.final_exp_tail(fs[:-1], fs[-1])[1]


def pairing_check_rlc_grouped_mesh(mesh, q1, p1, q2, zbits, seg_ids):
    """The grouped randomized check sharded over the mesh's ranks: Q1 holds
    the D distinct H(m) (D, 2, 2, 12), seg_ids (N,) maps the items to them,
    P2 is -G1; N and D divisible by the ranks. Each rank ladders its items,
    one gather moves the N randomized points, and each rank sums and
    Miller-loops only its groups. A group with no member fails the batch
    (ROADMAP C2): each rank checks its groups, the verdicts AND across the
    ranks. A 0-d bool on every rank, equal to the single-device
    `ops.bls12.pairing_check_rlc(..., seg_ids)`."""
    comm = MeshComm(mesh)
    n, d = zbits.shape[0], q1.shape[0]
    lo, hi = block_bounds(n, comm, "items")
    g0, g1 = block_bounds(d, comm, "groups")
    z1, zsig = B.rlc_ladders(p1[lo:hi].contiguous(), q2[lo:hi].contiguous(),
                             zbits[lo:hi].contiguous(), affine_g1=False)
    got = comm.all_gather(torch.cat([z1.reshape(-1), _sum(zsig).reshape(-1)]))
    width = (hi - lo) * 3 * NWORDS
    z1_all = got[:, :width].reshape(n, 3, NWORDS)
    aq = _sum(jacobian_from_affine(got[:, width:].reshape(-1, 2, 2, NWORDS)))
    order, offsets = B.segment_offsets(seg_ids, d)
    mine = offsets[g0:g1 + 1]
    start, stop = int(mine[0]), int(mine[-1])
    a1 = B.point_sums(z1_all[order[start:stop]], mine - start)
    members = (mine[1:] > mine[:-1]).all()
    m = B.miller_loop(torch.cat([q1[g0:g1], aq[None]]),
                      torch.cat([a1, B.neg_g1_words(a1.device)[None]]))
    got = comm.all_gather(torch.cat([B.f12_product(m[:-1]).reshape(-1),
                                     members.to(torch.int32).reshape(1)]))
    ok = B.rlc_tail(got[:, :_F12].reshape(-1, 12, NWORDS), m[-1])
    return ok & got[:, _F12].bool().all()
