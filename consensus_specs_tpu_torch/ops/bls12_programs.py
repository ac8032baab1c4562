"""The group programs of K9 and K11: straight-line programs of Fp products
and sums, scheduled for a group of units, emitted as tables into
csrc/bls_programs.cuh and played here over the plain fields.

A Miller loop's iteration or a curve double or add is a few dozen Fp
products, most of them independent of each other once their operands'
sums are formed. On the card a group of units (the lanes of a warp under
the limb field, the warps of a block under RNS) runs one such step: every
value lives in the group's slots in shared memory, and the step is a list
of rounds, each either products (a unit a job: two operands, each a sum of
up to a few slots with signs, then one `fp_mul`) or linear combinations (a
unit a job: the sum of a few slots times small integer coefficients). A
unit takes the jobs rank, rank + G, ... of a round, and the group syncs
between rounds. csrc/bls_group.cuh interprets the tables.

Exactness. Over either field a sum, a difference or a small multiple is
exact modular arithmetic on canonical values: the limb words are the
canonical residue mod p, and every RNS residue is the canonical residue of
the same integer combination mod its channel's prime (ops/fp_rns.py's add,
sub and neg are channel-wise mod m). So any way of forming a linear
combination gives the same words and residues; what a product's result
depends on is only its two operands as elements of Z/p (limb) or Z/M
(RNS, M the product of the 64 primes), and a product is commutative. The
programs here are traced from the one-unit formulas (csrc/tower.cuh,
csrc/pairing.cu, csrc/curve.cuh; ops/bls12.py's plain versions compute the
same): every value is a linear form with integer coefficients over the
program's inputs and products, every product keeps the one-unit formula's
operands as such forms, and every output is the one-unit formula's form.
So the group's words and residues are the one-unit code's, bit for bit,
and equal products (the same two forms) are computed once.

The programs:
- K11 (csrc/pairing.cu): `miller_dbl` (the doubling step of T with its
  line, f squared, f times the line: 114 distinct Fp products) and
  `miller_add` (the mixed addition with its line, f times the line: 83),
  over the state f (12 Fp), T (6), Q (4), P (2);
- K9 (csrc/rlc.cu): `jac_dbl` and `jac_add` (the complete add's product
  part: the case selects stay in the kernel, as curve.cuh's jac_add has
  them) over Fp2 (G2) for both fields and over Fp (G1) for RNS; the limb
  G1 ladder runs on csrc/g1_lanes.cuh's four-lane groups;
- K10's G2 collapse (csrc/rlc.cu) adds with K9's G2 `jac_add` and makes its
  sum affine with `aff_norm` (the norm Z0^2 + Z1^2 that f2_inv inverts)
  and `aff_out` (from the norm's inverse, one unit's `fp_inv` between the
  two: Z^-1, Z^-2, Z^-3 and (X·Z^-2, Y·Z^-3), curve.cuh's jac_to_affine).

Scheduling is list scheduling by the longest path to the step's end:
product rounds of at most G jobs alternate with linear rounds, a product
operand of more than `KF` signed terms is formed by a linear job first,
and a linear job of more than `KL` terms is split. Slots are allocated by
liveness; outputs land in their home slots (in place of the inputs they
replace, once those are read).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MUL, LIN = 0, 1
MAX_TERMS = 6   # signed terms of a product operand in a job record
MAX_LIN = 7     # terms of a linear job in a job record
MAX_COEFF = 127

# the group sizes of the programs by field (units a group): K11 a warp of
# lanes (limb) or 8 warps (RNS), K9's G2 16 lanes (limb) or 8 warps (RNS),
# K9's G1 4 warps (RNS)
GROUPS = {"miller_limb": 32, "miller_rns": 8, "g2_limb": 16, "g2_rns": 8, "g1_rns": 4}
# the longest signed sum a product operand forms itself, by field: a sum
# costs the limb field a twelve-word add with its reduction (a tenth of a
# product), RNS a few instructions
KF = {"limb": 2, "rns": 4}
assert KF["limb"] <= 3  # csrc/bls_group.cuh leaves a limb operand's sum unreduced
KL = 7


class Sym:
    """A linear form over a program's atoms (inputs and products): a tuple
    of (atom id, integer coefficient), sorted, no zero coefficient."""

    __slots__ = ("b", "form")

    def __init__(self, b, form):
        self.b, self.form = b, form

    def _comb(self, other, s):
        d = dict(self.form)
        for a, c in other.form:
            d[a] = d.get(a, 0) + s * c
        return Sym(self.b, tuple(sorted((a, c) for a, c in d.items() if c)))

    def __add__(self, o):
        return self._comb(o, 1)

    def __sub__(self, o):
        return self._comb(o, -1)

    def __neg__(self):
        return Sym(self.b, tuple((a, -c) for a, c in self.form))

    def __mul__(self, o):
        return self.b.mul(self, o)


@dataclass
class Atom:
    id: int
    kind: str          # "in", "mul" or "lin"
    name: str = ""     # an input's home slot
    x: tuple = ()      # mul: operand x as (atom, +-1) terms; lin: (atom, coeff) terms
    y: tuple = ()      # mul: operand y


class Trace:
    """Traces one program: `inp` names an input slot, `*` makes a product
    (one per distinct pair of operand forms), `out` names where a value must
    end."""

    def __init__(self, kf: int):
        self.kf = kf
        self.atoms: list[Atom] = []
        self.memo: dict = {}
        self.outputs: list = []  # (home, atom id)
        self.zero_id = self._new("in", name="zero")

    def _new(self, kind, **kw) -> int:
        a = Atom(len(self.atoms), kind, **kw)
        self.atoms.append(a)
        return a.id

    def zero(self) -> Sym:
        return Sym(self, ())

    def inp(self, name: str) -> Sym:
        return Sym(self, ((self._new("in", name=name), 1),))

    def _terms(self, form) -> tuple:
        """A form as signed unit terms, positives first (the zero slot first
        when there is none)."""
        pos = [(a, 1) for a, c in form if c > 0 for _ in range(c)]
        neg = [(a, -1) for a, c in form if c < 0 for _ in range(-c)]
        return tuple((pos or [(self.zero_id, 1)]) + neg)

    def _operand(self, form) -> tuple:
        t = self._terms(form)
        return t if len(t) <= self.kf else ((self._mat(form), 1),)

    def _mat(self, form) -> int:
        """The atom holding the value of `form`: an existing one, or a linear
        job (split into partial sums over `KL` terms)."""
        if len(form) == 1 and form[0][1] == 1:
            return form[0][0]
        if not form:
            return self.zero_id
        key = ("lin", form)
        if key not in self.memo:
            terms = []
            for a, c in form:  # coefficients beyond an int8 go as several terms
                while abs(c) > MAX_COEFF:
                    s = MAX_COEFF if c > 0 else -MAX_COEFF
                    terms.append((a, s))
                    c -= s
                terms.append((a, c))
            while len(terms) > KL:
                terms = [(self._mat(tuple(sorted(terms[i:i + KL]))), 1)
                         for i in range(0, len(terms), KL)]
            self.memo[key] = self._new("lin", x=tuple(terms))
        return self.memo[key]

    def mul(self, a: Sym, b: Sym) -> Sym:
        fa, fb = a.form, b.form
        if not fa or not fb:  # x·0: the same product whatever x (its wide product is 0)
            fa = fb = ()
        key = ("mul",) + tuple(sorted((fa, fb)))
        if key not in self.memo:
            self.memo[key] = self._new("mul", x=self._operand(fa), y=self._operand(fb))
        return Sym(self, ((self.memo[key], 1),))

    def mat(self, s: Sym) -> Sym:
        return Sym(self, ((self._mat(s.form), 1),))

    def out(self, home: str, s: Sym) -> None:
        self.outputs.append((home, self._mat(s.form)))


# --- the one-unit formulas over Sym (csrc/tower.cuh, csrc/pairing.cu,
# csrc/curve.cuh; ops/bls12.py) ------------------------------------------------


def f2_add(x, y):
    return (x[0] + y[0], x[1] + y[1])


def f2_sub(x, y):
    return (x[0] - y[0], x[1] - y[1])


def f2_neg(x):
    return (-x[0], -x[1])


def f2_mul(x, y):
    """Karatsuba: ac - bd, (a + b)(c + d) - ac - bd."""
    ac, bd = x[0] * y[0], x[1] * y[1]
    t = (x[0] + x[1]) * (y[0] + y[1])
    return (ac - bd, t - ac - bd)


def f2_sqr(x):
    """(a + b)(a - b), (a + a)·b."""
    return ((x[0] + x[1]) * (x[0] - x[1]), (x[0] + x[0]) * x[1])


def f2_mul_xi(x):
    return (x[0] - x[1], x[0] + x[1])


def f2_mul_fp(x, s):
    return (x[0] * s, x[1] * s)


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_mul_by_v(x):
    return (f2_mul_xi(x[2]), x[0], x[1])


def f6_mul(x, y):
    t0, t1, t2 = f2_mul(x[0], y[0]), f2_mul(x[1], y[1]), f2_mul(x[2], y[2])
    s = f2_mul(f2_add(x[1], x[2]), f2_add(y[1], y[2]))
    c0 = f2_add(t0, f2_mul_xi(f2_sub(s, f2_add(t1, t2))))
    s = f2_mul(f2_add(x[0], x[1]), f2_add(y[0], y[1]))
    c1 = f2_add(f2_sub(s, f2_add(t0, t1)), f2_mul_xi(t2))
    s = f2_mul(f2_add(x[0], x[2]), f2_add(y[0], y[2]))
    c2 = f2_add(f2_sub(s, f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def _mat_f6(b, x):
    return tuple((b.mat(c[0]), b.mat(c[1])) for c in x)


def f12_sqr(b, x):
    """(a + b w)^2 = (a + b)(a + v b) - ab - v ab + 2ab w, each Fp6 product
    kept in slots."""
    a, bb = x
    t = _mat_f6(b, f6_mul(a, bb))
    s = _mat_f6(b, f6_mul(f6_add(a, bb), f6_add(a, f6_mul_by_v(bb))))
    return (f6_sub(s, f6_add(t, f6_mul_by_v(t))), f6_add(t, t))


def f12_mul_sparse035(b, f, l0, l3, l5):
    """f·(l0 + l3 w^3 + l5 w^5): a·l0 by coefficient, b·(0, l3, l5),
    (a + b)(l0, l3, l5); 45 Fp products."""
    a, bb = f
    zero = (b.zero(), b.zero())
    t0 = tuple(f2_mul(c, l0) for c in a)
    t1 = _mat_f6(b, f6_mul(bb, (zero, l3, l5)))
    t2 = _mat_f6(b, f6_mul(f6_add(a, bb), (l0, l3, l5)))
    return (f6_add(t0, f6_mul_by_v(t1)), f6_sub(t2, f6_add(t0, t1)))


def dbl_step(T, xp, yp):
    """csrc/pairing.cu's one-unit dbl_step (ops/bls12.py `_dbl_step`)."""
    X, Y, Z = T
    A, B, Zsq = f2_sqr(X), f2_sqr(Y), f2_sqr(Z)
    E = f2_add(f2_add(A, A), A)
    D = f2_mul(X, B)
    YZ = f2_mul(Y, Z)
    Zcu = f2_mul(Z, Zsq)
    EX = f2_mul(E, X)
    EZsq = f2_mul(E, Zsq)
    D = f2_add(D, D)
    D = f2_add(D, D)
    Fq, C = f2_sqr(E), f2_sqr(B)
    X3 = f2_sub(Fq, f2_add(D, D))
    C8 = f2_add(C, C)
    C8 = f2_add(C8, C8)
    C8 = f2_add(C8, C8)
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), C8)
    t = f2_mul(Y, Zcu)
    t = f2_mul_xi(f2_add(t, t))
    l0 = f2_mul_fp(t, yp)
    l5 = f2_neg(f2_mul_fp(EZsq, xp))
    l3 = f2_sub(EX, f2_add(B, B))
    return (X3, Y3, f2_add(YZ, YZ)), (l0, l3, l5)


def add_step(T, xq, yq, xp, yp):
    """csrc/pairing.cu's one-unit add_step (ops/bls12.py `_add_step`)."""
    X, Y, Z = T
    Zsq = f2_sqr(Z)
    U = f2_mul(xq, Zsq)
    Zcu = f2_mul(Z, Zsq)
    S = f2_mul(yq, Zcu)
    H, R = f2_sub(U, X), f2_sub(S, Y)
    Hsq, Rsq = f2_sqr(H), f2_sqr(R)
    Hcu = f2_mul(H, Hsq)
    V = f2_mul(X, Hsq)
    HZ = f2_mul(H, Z)
    X3 = f2_sub(f2_sub(Rsq, Hcu), f2_add(V, V))
    Y3 = f2_sub(f2_mul(R, f2_sub(V, X3)), f2_mul(Y, Hcu))
    l3 = f2_sub(f2_mul(R, xq), f2_mul(HZ, yq))
    l0 = f2_mul_fp(f2_mul_xi(HZ), yp)
    l5 = f2_neg(f2_mul_fp(R, xp))
    return (X3, Y3, HZ), (l0, l3, l5)


class _Fp1:
    """Curve formulas' field ops over Fp (a Sym)."""

    @staticmethod
    def add(x, y):
        return x + y

    @staticmethod
    def sub(x, y):
        return x - y

    @staticmethod
    def mul(x, y):
        return x * y

    @staticmethod
    def sqr(x):
        return x * x


class _Fp2:
    add, sub, mul, sqr = staticmethod(f2_add), staticmethod(f2_sub), staticmethod(f2_mul), \
        staticmethod(f2_sqr)


def jac_double(F, p):
    """csrc/curve.cuh's jac_double: A = X^2, B = Y^2, C = B·B, D = 4XB,
    E = 3A; X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ."""
    X, Y, Z = p
    A, B = F.sqr(X), F.sqr(Y)
    D = F.mul(X, B)
    Z3 = F.mul(Y, Z)
    C = F.mul(B, B)
    D = F.add(D, D)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.sqr(E), F.add(D, D))
    C = F.add(C, C)
    C = F.add(C, C)
    C = F.add(C, C)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C)
    return X3, Y3, F.add(Z3, Z3)


def jac_add_core(F, p1, p2):
    """csrc/curve.cuh's jac_add without its case selects: (X3, Y3, Z1Z2·H)
    and H, R, which the kernel tests."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1sq, Z2sq = F.sqr(Z1), F.sqr(Z2)
    U1, U2 = F.mul(X1, Z2sq), F.mul(X2, Z1sq)
    Z2cu, Z1cu = F.mul(Z2, Z2sq), F.mul(Z1, Z1sq)
    S1, S2 = F.mul(Y1, Z2cu), F.mul(Y2, Z1cu)
    H, R = F.sub(U2, U1), F.sub(S2, S1)
    Hsq, Rsq = F.sqr(H), F.sqr(R)
    Hcu, V = F.mul(H, Hsq), F.mul(U1, Hsq)
    Z1Z2 = F.mul(Z1, Z2)
    X3 = F.sub(F.sub(Rsq, Hcu), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(S1, Hcu))
    return (X3, Y3, F.mul(Z1Z2, H)), H, R


# --- the programs' slot layouts and traces ----------------------------------------


def _fp2_names(prefix, n):
    return [f"{prefix}{i}" for i in range(n)]


MILLER_LAYOUT = ["zero"] + _fp2_names("f", 12) + _fp2_names("T", 6) + _fp2_names("Q", 4) \
    + _fp2_names("P", 2)


def _fp2s(b, prefix, n):
    v = [b.inp(f"{prefix}{i}") for i in range(2 * n)]
    return [(v[2 * i], v[2 * i + 1]) for i in range(n)]


def _f12_in(b):
    """f from slots f0..f11: coefficient k of w^k at f(2k), f(2k+1); the
    Fp6 pair (a, b) = (coefficients 0, 2, 4; 1, 3, 5)."""
    c = _fp2s(b, "f", 6)
    return (c[0], c[2], c[4]), (c[1], c[3], c[5])


def _f12_out(b, f):
    a, bb = f
    for k in range(6):
        c = a[k // 2] if k % 2 == 0 else bb[k // 2]
        b.out(f"f{2 * k}", c[0])
        b.out(f"f{2 * k + 1}", c[1])


def _T_in(b):
    return tuple(_fp2s(b, "T", 3))


def _T_out(b, T):
    for i, c in enumerate(T):
        b.out(f"T{2 * i}", c[0])
        b.out(f"T{2 * i + 1}", c[1])


def trace_miller_dbl(kf: int) -> Trace:
    """One doubling iteration: (T, l) = dbl_step(T); f = f^2·l."""
    b = Trace(kf)
    f, T = _f12_in(b), _T_in(b)
    xp, yp = b.inp("P0"), b.inp("P1")
    T3, (l0, l3, l5) = dbl_step(T, xp, yp)
    fsq = f12_sqr(b, f)
    fsq = tuple(tuple((b.mat(c[0]), b.mat(c[1])) for c in h) for h in fsq)
    _f12_out(b, f12_mul_sparse035(b, fsq, l0, l3, l5))
    _T_out(b, T3)
    return b


def trace_miller_add(kf: int) -> Trace:
    """One addition: (T, l) = add_step(T, Q); f = f·l."""
    b = Trace(kf)
    f, T = _f12_in(b), _T_in(b)
    xq, yq = _fp2s(b, "Q", 2)
    xp, yp = b.inp("P0"), b.inp("P1")
    T3, (l0, l3, l5) = add_step(T, xq, yq, xp, yp)
    _f12_out(b, f12_mul_sparse035(b, f, l0, l3, l5))
    _T_out(b, T3)
    return b


def curve_layout(g2: bool) -> list:
    """K9's slots a ladder: the accumulator A, the operand B of an add, the
    add's result C, H and R (the add's case tests), the table's points
    [1]P, [2]P, [3]P (entry 0 is infinity, no slots)."""
    w = 2 if g2 else 1
    names = ["zero"]
    for p in ("A", "B", "C"):
        names += _fp2_names(p, 3 * w)
    names += _fp2_names("H", w) + _fp2_names("R", w)
    for t in (1, 2, 3):
        names += _fp2_names(f"t{t}_", 3 * w)
    return names


def _pt_in(b, prefix, g2):
    if g2:
        return tuple(_fp2s(b, prefix, 3))
    return tuple(b.inp(f"{prefix}{i}") for i in range(3))


def _pt_out(b, prefix, p, g2):
    vals = [c for coord in p for c in (coord if g2 else (coord,))]
    for i, v in enumerate(vals):
        b.out(f"{prefix}{i}", v)


def trace_jac_dbl(g2: bool, kf: int) -> Trace:
    """A = 2A in place."""
    b = Trace(kf)
    _pt_out(b, "A", jac_double(_Fp2 if g2 else _Fp1, _pt_in(b, "A", g2)), g2)
    return b


def trace_aff_norm(kf: int) -> Trace:
    """H0 = Z0^2 + Z1^2, the norm of A's Z (csrc/tower.cuh f2_inv)."""
    b = Trace(kf)
    z0, z1 = b.inp("A4"), b.inp("A5")
    b.out("H0", z0 * z0 + z1 * z1)
    return b


def trace_aff_out(kf: int) -> Trace:
    """C = (X·Z^-2, Y·Z^-3) of A, given R0 = the norm's inverse: f2_inv's
    (Z0·n, -(Z1·n)), then curve.cuh's jac_to_affine."""
    b = Trace(kf)
    X, Y, Z = _pt_in(b, "A", True)
    n = b.inp("R0")
    zinv = (Z[0] * n, -(Z[1] * n))
    zinv2 = f2_sqr(zinv)
    _pt_out(b, "C", (f2_mul(X, zinv2), f2_mul(Y, f2_mul(zinv, zinv2))), True)
    return b


def trace_jac_add(g2: bool, kf: int) -> Trace:
    """C = A + B by the add formula; H and R for the case tests."""
    b = Trace(kf)
    F = _Fp2 if g2 else _Fp1
    c, h, r = jac_add_core(F, _pt_in(b, "A", g2), _pt_in(b, "B", g2))
    _pt_out(b, "C", c, g2)
    _pt_out(b, "H", (h,), g2)
    _pt_out(b, "R", (r,), g2)
    return b


# --- scheduling and slot allocation ----------------------------------------------


@dataclass
class Round:
    kind: int
    nterms: int
    jobs: list  # MUL: (dst, x terms, y terms); LIN: (dst, terms)


@dataclass
class Program:
    name: str
    group: int
    rounds: list
    slots: int          # slots the program touches (fixed and temporary)
    products: int


def _live_atoms(b: Trace) -> list:
    need = set()
    stack = [a for _, a in b.outputs]
    while stack:
        a = stack.pop()
        if a in need:
            continue
        need.add(a)
        at = b.atoms[a]
        stack += [t for t, _ in at.x] + [t for t, _ in at.y]
    return sorted(need)


def _deps(at: Atom) -> set:
    return {t for t, _ in at.x} | {t for t, _ in at.y}


def build_program(b: Trace, name: str, layout: list, group: int) -> Program:
    """List-schedule the traced program for a group of `group` units, place
    its values in slots (the layout's names first, then temporaries) and
    return its rounds."""
    atoms = b.atoms
    live = _live_atoms(b)
    jobs = [a for a in live if atoms[a].kind != "in"]
    users: dict = {a: [] for a in live}
    for a in jobs:
        for d in _deps(atoms[a]):
            users[d].append(a)
    height = {}
    for a in sorted(jobs, reverse=True):  # atoms are made after their operands
        w = 1.0 if atoms[a].kind == "mul" else 0.1
        height[a] = w + max((height[u] for u in users[a]), default=0.0)
    pending = set(jobs)
    round_of: dict = {}
    sched = []  # (kind, atoms)
    last = None
    while pending:
        ready = [a for a in pending if all(atoms[d].kind == "in" or d in round_of
                                           for d in _deps(atoms[a]))]
        lin = sorted(a for a in ready if atoms[a].kind == "lin")
        mul = sorted((a for a in ready if atoms[a].kind == "mul"), key=lambda a: (-height[a], a))
        if lin and (last != LIN or not mul):
            pick, last = lin, LIN
        elif mul:
            pick, last = mul[:group], MUL
        else:
            raise AssertionError(f"{name}: nothing ready")
        for a in pick:
            round_of[a] = len(sched)
            pending.discard(a)
        sched.append((last, pick))
    end = len(sched)

    # outputs: in the home slot when the input there is read by then, else a
    # copy in a last round
    slot_of = {}
    fixed = {n: i for i, n in enumerate(layout)}
    for a in live:
        if atoms[a].kind == "in":
            slot_of[a] = fixed[atoms[a].name]
    last_use = {a: -1 for a in live}
    for a in jobs:
        for d in _deps(atoms[a]):
            last_use[d] = max(last_use[d], round_of[a])
    home_input = {atoms[a].name: a for a in live if atoms[a].kind == "in"}
    # an input left as another home's output would be read by a last-round
    # copy after its own home may have been written
    assert not any(atoms[a].kind == "in" and atoms[a].name != home for home, a in b.outputs)
    copies = []
    homed = set()
    for home, a in b.outputs:
        old = home_input.get(home)
        free_from = last_use[old] if old is not None else -1
        if atoms[a].kind != "in" and a not in homed and round_of[a] > free_from:
            slot_of[a] = fixed[home]
            homed.add(a)
        elif not (atoms[a].kind == "in" and atoms[a].name == home):
            copies.append((fixed[home], a))
            last_use[a] = end

    # temporaries by liveness
    temp = sorted((a for a in jobs if a not in slot_of), key=lambda a: round_of[a])
    free_at: list = []  # per temporary slot: the round after which it is free
    for a in temp:
        r = round_of[a]
        for i, f in enumerate(free_at):
            if f < r:
                free_at[i] = max(last_use[a], r)
                slot_of[a] = len(layout) + i
                break
        else:
            free_at.append(max(last_use[a], r))
            slot_of[a] = len(layout) + len(free_at) - 1
    nslots = len(layout) + len(free_at)

    rounds = []
    for kind, pick in sched:
        if kind == MUL:
            rj = [(slot_of[a], tuple((slot_of[t], s) for t, s in atoms[a].x),
                   tuple((slot_of[t], s) for t, s in atoms[a].y)) for a in pick]
            nt = max(max(len(x), len(y)) for _, x, y in rj)
        else:
            rj = [(slot_of[a], tuple((slot_of[t], c) for t, c in atoms[a].x)) for a in pick]
            nt = max(len(t) for _, t in rj)
        rounds.append(Round(kind, nt, rj))
    if copies:
        rounds.append(Round(LIN, 1, [(dst, ((slot_of[a], 1),)) for dst, a in copies]))
    assert nslots <= 256, f"{name}: {nslots} slots"
    assert all(r.nterms <= (MAX_TERMS if r.kind == MUL else MAX_LIN) for r in rounds)
    return Program(name, group, rounds, nslots,
                   sum(len(r.jobs) for r in rounds if r.kind == MUL))


def family_programs(family: str, field: str) -> dict:
    """{"dbl": Program, "add": Program} of a family ("miller", "g2", "g1")
    over a field, for its group size in `GROUPS`."""
    g = GROUPS[f"{family}_{field}"]
    kf = KF[field]
    if family == "miller":
        return {"dbl": build_program(trace_miller_dbl(kf), "miller_dbl", MILLER_LAYOUT, g),
                "add": build_program(trace_miller_add(kf), "miller_add", MILLER_LAYOUT, g)}
    g2 = family == "g2"
    layout = curve_layout(g2)
    progs = {"dbl": build_program(trace_jac_dbl(g2, kf), "jac_dbl", layout, g),
             "add": build_program(trace_jac_add(g2, kf), "jac_add", layout, g)}
    if g2:
        progs["aff_norm"] = build_program(trace_aff_norm(kf), "aff_norm", layout, g)
        progs["aff_out"] = build_program(trace_aff_out(kf), "aff_out", layout, g)
    return progs



# --- the player: the programs over the plain fields ------------------------------


def _gather(slots, terms, nterms):
    """(nterms, jobs) slot indices and negative flags of the jobs' operand
    terms, padded with the zero slot."""
    idx = [[t[k][0] if k < len(t) else 0 for t in terms] for k in range(nterms)]
    neg = [[k < len(t) and t[k][1] < 0 for t in terms] for k in range(nterms)]
    return (torch.tensor(idx, device=slots.device), torch.tensor(neg, device=slots.device))


def _bcast(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _signed_sum(F, slots, terms, nterms):
    idx, neg = _gather(slots, terms, nterms)
    acc = slots[idx[0]]
    for k in range(1, nterms):
        v = slots[idx[k]]
        acc = torch.where(_bcast(neg[k], acc), F.sub(acc, v), F.add(acc, v))
    return acc


def _lincomb(F, slots, terms, nterms):
    """sum of c·v by doubling and adding in the plain field (any exact way
    gives the canonical words and residues)."""
    idx, _ = _gather(slots, terms, nterms)
    coef = torch.tensor([[t[k][1] if k < len(t) else 0 for t in terms] for k in range(nterms)],
                        device=slots.device)
    acc = torch.zeros_like(slots[idx[0]])
    for k in range(nterms):
        base, mag, part = slots[idx[k]], coef[k].abs(), torch.zeros_like(acc)
        for bit in range(7):
            on = _bcast(((mag >> bit) & 1) == 1, part)
            part = torch.where(on, F.add(part, base), part)
            base = F.add(base, base)
        acc = torch.where(_bcast(coef[k] < 0, acc), F.sub(acc, part), F.add(acc, part))
    return acc


def play(prog: Program, slots: torch.Tensor, F) -> None:
    """Run `prog` on `slots` (S, ..., width) in place over the plain field F
    (ops/bls12.py's `_LimbField` on limbs or `_RnsField` on residues), a
    round at a time as the group runs it."""
    for r in prog.rounds:
        dst = torch.tensor([j[0] for j in r.jobs], device=slots.device)
        if r.kind == MUL:
            vals = F.mul(_signed_sum(F, slots, [j[1] for j in r.jobs], r.nterms),
                         _signed_sum(F, slots, [j[2] for j in r.jobs], r.nterms))
        else:
            vals = _lincomb(F, slots, [j[1] for j in r.jobs], r.nterms)
        slots[dst] = vals


# --- the header -----------------------------------------------------------------

# (macro prefix, family, field, curve): the programs csrc/bls_programs.cuh holds
FAMILIES = (("MILLER", "miller", "limb"), ("MILLER", "miller", "rns"),
            ("G2", "g2", "limb"), ("G2", "g2", "rns"), ("G1", "g1", "rns"))


def _job_words(r: Round, job) -> list:
    b = [0] * 16
    if r.kind == MUL:
        dst, x, y = job
        signs = 0
        for k, (s, sg) in enumerate(x):
            b[k] = s
            signs |= (sg < 0) << k
        for k, (s, sg) in enumerate(y):
            b[6 + k] = s
            signs |= (sg < 0) << (6 + k)
        b[12], b[13], b[14] = dst, signs & 255, signs >> 8
    else:
        dst, terms = job
        for k, (s, c) in enumerate(terms):
            b[k], b[7 + k] = s, c & 255
        b[14] = dst
    return [b[4 * i] | b[4 * i + 1] << 8 | b[4 * i + 2] << 16 | b[4 * i + 3] << 24
            for i in range(4)]


def _layout_defines(prefix: str, layout: list, coords: dict) -> list:
    return [f"#define {prefix}_{name} {layout.index(first)}" for name, first in coords.items()]


def cuda_programs_header() -> str:
    """The text of csrc/bls_programs.cuh (a test holds the committed file
    equal to it)."""
    from .fp import P

    rounds, jobs, lines = [], [], []
    for prefix, family, field in FAMILIES:
        progs = family_programs(family, field)
        tag = f"{prefix}_{field.upper()}"
        lines.append(f"#define {tag}_G {GROUPS[f'{family}_{field}']}")
        lines.append(f"#define {tag}_SLOTS {max(p.slots for p in progs.values())}")
        for kind, prog in progs.items():
            lines.append(f"#define PROG_{prefix}_{kind.upper()}_{field.upper()} {len(rounds)}, "
                         f"{len(prog.rounds)}  // {prog.products} products")
            for r in prog.rounds:
                rounds.append((r.kind | r.nterms << 8 | len(r.jobs) << 16, len(jobs)))
                jobs += [_job_words(r, j) for j in r.jobs]
    corr = (1 - (1 << 384)) % P
    corr_words = ", ".join(f"0x{(corr >> (32 * j)) & 0xffffffff:08x}u" for j in range(12))
    layout = _layout_defines("MILLER", MILLER_LAYOUT, {"F": "f0", "T": "T0", "Q": "Q0",
                                                       "P": "P0"})
    layout.append(f"#define MILLER_FIXED {len(MILLER_LAYOUT)}")
    for g2, tag in ((True, "CURVE2"), (False, "CURVE1")):
        lay = curve_layout(g2)
        layout += _layout_defines(tag, lay, {"A": "A0", "B": "B0", "C": "C0", "H": "H0",
                                             "R": "R0", "T": "t1_0"})
        layout.append(f"#define {tag}_FIXED {len(lay)}")
    round_rows = ",\n    ".join(f"{{0x{a:08x}u, {b}u}}" for a, b in rounds)
    job_rows = ",\n    ".join("{" + ", ".join(f"0x{w:08x}u" for w in j) + "}" for j in jobs)
    return f"""// Generated by consensus_specs_tpu_torch.ops.bls12_programs.cuda_programs_header();
// a test holds this file equal to its output. The group programs of K9, K10
// and K11 (csrc/bls_group.cuh runs them): a program is a span of rounds, a
// round {{kind | terms << 8 | jobs << 16, first job}}, a job four words:
// product (kind 0): bytes 0-5 the slots of operand x's signed terms, 6-11
//   operand y's, 12 the result's slot, 13-14 the signs (bit k: x's term k
//   is subtracted, bit 6 + k: y's);
// linear (kind 1): bytes 0-6 the slots of its terms, 7-13 their int8
//   coefficients, 14 the result's slot.
// Slot 0 holds zero; terms past a job's own pad with it.
#pragma once
#include <cstdint>

#define SLP_MUL 0
#define SLP_LIN 1

// slot layouts (first slot of each value; Fp2 values take two slots, a point
// three values)
{chr(10).join(layout)}

// group sizes (units), slots a group, and the programs (first round, rounds)
{chr(10).join(lines)}

// the limb field's linear jobs: (1 - 2^384) mod p, which a term with a
// negative coefficient adds once per unit of it (it adds |c|·(2^384 - 1 - v)),
// and 1 / ((p >> 352) + 2), which estimates a sum's quotient by p from its
// top two words (one short at most)
__device__ __constant__ uint32_t FP_LIN_CORR[12] = {{{corr_words}}};
#define FP_LIN_QINV {1.0 / ((P >> 352) + 2)!r}

__device__ const uint2 SLP_ROUNDS[{len(rounds)}] = {{
    {round_rows}}};
__device__ const uint4 SLP_JOBS[{len(jobs)}] = {{
    {job_rows}}};
"""


# --- the kernels' steps mirrored over the plain fields -----------------------------


def _field_of(words):
    from . import bls12

    F = bls12.word_field(words.shape[-1])
    return F, ("rns" if F is bls12._RnsField else "limb")


def miller_step_mirror(step: str, f, T, q, p):
    """One run of K11's program `step` ("dbl" or "add") as its group runs
    it, over the plain field of the words' width: f (B, 12, w), T (B, 3, 2,
    w) Jacobian, Q (B, 2, 2, w), P (B, 2, w) -> (f, T) after the step."""
    F, field = _field_of(q)
    prog = family_programs("miller", field)[step]
    fl, Tl, ql, pl = (F.to_plain(t) for t in (f, T, q, p))
    n, w = q.shape[0], ql.shape[-1]
    at = MILLER_LAYOUT.index
    s = torch.zeros((prog.slots, n, w), dtype=ql.dtype)
    s[at("f0"):at("f0") + 12] = fl.transpose(0, 1)
    s[at("T0"):at("T0") + 6] = Tl.reshape(n, 6, w).transpose(0, 1)
    s[at("Q0"):at("Q0") + 4] = ql.reshape(n, 4, w).transpose(0, 1)
    s[at("P0"):at("P0") + 2] = pl.transpose(0, 1)
    play(prog, s, F)
    return (F.from_plain(s[at("f0"):at("f0") + 12].transpose(0, 1)),
            F.from_plain(s[at("T0"):at("T0") + 6].transpose(0, 1)).reshape(T.shape))


def miller_loop_mirror(q, p):
    """K11 as its groups run it (csrc/pairing.cu), over the plain field of
    the words' width: Q (B, 2, 2, w), P (B, 2, w) -> (B, 12, w)."""
    from .bls12 import X_BITS

    F, field = _field_of(q)
    progs = family_programs("miller", field)
    ql, pl = F.to_plain(q), F.to_plain(p)
    n, w = q.shape[0], ql.shape[-1]
    at = MILLER_LAYOUT.index
    s = torch.zeros((max(pr.slots for pr in progs.values()), n, w), dtype=ql.dtype)
    s[at("f0")] = s[at("T4")] = F.one(ql)
    for k in range(4):
        s[at(f"Q{k}")] = s[at(f"T{k}")] = ql.reshape(n, 4, w)[:, k]
    s[at("P0")], s[at("P1")] = pl[:, 0], pl[:, 1]
    for bit in X_BITS:
        play(progs["dbl"], s, F)
        if bit:
            play(progs["add"], s, F)
    f = s[at("f0"):at("f0") + 12].transpose(0, 1).clone()
    odd = torch.tensor([(r >> 1) & 1 for r in range(12)], dtype=torch.bool)
    f[:, odd] = F.neg(f[:, odd])
    return F.from_plain(f)


class _Ladder:
    """csrc/rlc.cu's group ladder (grp_scalar_mul, grp_add_table) on one
    item's slots, over a plain field."""

    def __init__(self, F, field, g2):
        self.F, self.nc = F, 2 if g2 else 1
        self.progs = family_programs("g2" if g2 else "g1", field)
        lay = curve_layout(g2)
        self.A, self.B, self.C, self.H, self.T = (lay.index(n) for n in ("A0", "B0", "C0", "H0",
                                                                        "t1_0"))
        self.np = 3 * self.nc
        self.slots = max(pr.slots for pr in self.progs.values())

    def copy(self, s, dst, src, n):
        s[dst:dst + n] = 0 if src < 0 else s[src:src + n].clone()

    def zero(self, s, s0, n):
        return bool(self.F.is_zero(s[s0:s0 + n]).all())

    def add_table(self, s, d, z2):
        z1 = self.zero(s, self.A + 2 * self.nc, self.nc)
        if d == 0:
            if z1:
                self.copy(s, self.A, -1, self.np)
            return
        t = self.T + (d - 1) * self.np
        if z1:
            self.copy(s, self.A, t, self.np)
            return
        if z2:
            return
        self.copy(s, self.B, t, self.np)
        play(self.progs["add"], s, self.F)
        if not self.zero(s, self.H, self.nc):
            self.copy(s, self.A, self.C, self.np)
        elif self.zero(s, self.H + self.nc, self.nc):
            play(self.progs["dbl"], s, self.F)
        else:
            self.copy(s, self.A, self.C, 2 * self.nc)
            self.copy(s, self.A + 2 * self.nc, -1, self.nc)

    def scalar_mul(self, s, z: int):
        np_, T = self.np, self.T
        self.copy(s, self.A, T, np_)
        play(self.progs["dbl"], s, self.F)
        self.copy(s, T + np_, self.A, np_)
        self.add_table(s, 1, False)
        self.copy(s, T + 2 * np_, self.A, np_)
        zt = [True, False] + [self.zero(s, T + k * np_ + 2 * self.nc, self.nc) for k in (1, 2)]
        top = (z >> 62) & 3
        self.copy(s, self.A, T + (top - 1) * np_ if top else -1, np_)
        for w in range(30, -1, -1):
            d = (z >> (2 * w)) & 3
            play(self.progs["dbl"], s, self.F)
            play(self.progs["dbl"], s, self.F)
            self.add_table(s, d, zt[d])


def _ladder_of(words, g2):
    F, field = _field_of(words)
    return _Ladder(F, field, g2)


def ladder_mirror(pts, zbits, g2: bool):
    """K9's group ladders (csrc/rlc.cu) over the plain field of the words'
    width: affine pts (N, 2, w) or (N, 2, 2, w), zbits (N, 2) int32 ->
    Jacobian (N, 3, w) or (N, 3, 2, w). The limb G1 ladder runs on
    csrc/g1_lanes.cuh instead (no program)."""
    lad = _ladder_of(pts, g2)
    F = lad.F
    pl = F.to_plain(pts).reshape(pts.shape[0], -1, F.to_plain(pts).shape[-1])
    out = []
    for i in range(pts.shape[0]):
        s = torch.zeros((lad.slots, 1, pl.shape[-1]), dtype=pl.dtype)
        s[lad.T:lad.T + 2 * lad.nc, 0] = pl[i]
        s[lad.T + 2 * lad.nc] = F.one(pl)
        z = (int(zbits[i, 1]) & 0xFFFFFFFF) << 32 | (int(zbits[i, 0]) & 0xFFFFFFFF)
        lad.scalar_mul(s, z)
        out.append(s[lad.A:lad.A + lad.np, 0])
    res = F.from_plain(torch.stack(out))
    return res.reshape(pts.shape[0], 3, *pts.shape[2:])


def jac_add_mirror(p1, p2, g2: bool):
    """curve.cuh's complete add as K9's group runs it (the table's entry
    holding p2), per item: Jacobian (N, 3, ...) words in and out."""
    lad = _ladder_of(p1, g2)
    F = lad.F
    a, b = (F.to_plain(t).reshape(t.shape[0], lad.np, -1) for t in (p1, p2))
    out = []
    for i in range(p1.shape[0]):
        s = torch.zeros((lad.slots, 1, a.shape[-1]), dtype=a.dtype)
        s[lad.A:lad.A + lad.np, 0], s[lad.T:lad.T + lad.np, 0] = a[i], b[i]
        lad.add_table(s, 1, lad.zero(s, lad.T + 2 * lad.nc, lad.nc))
        out.append(s[lad.A:lad.A + lad.np, 0])
    return F.from_plain(torch.stack(out)).reshape(p1.shape)


def g2_affine_mirror(pts):
    """K10's G2 affine step as its group runs it (csrc/rlc.cu: `aff_norm`,
    one unit's inverse of the norm, `aff_out`) over the plain field of the
    words' width: Jacobian (N, 3, 2, w) words -> affine (N, 2, 2, w)."""
    F, field = _field_of(pts)
    progs = family_programs("g2", field)
    lay = curve_layout(True)
    a, h, r, c = (lay.index(n) for n in ("A0", "H0", "R0", "C0"))
    pl = F.to_plain(pts).reshape(pts.shape[0], 6, -1)
    s = torch.zeros((max(pr.slots for pr in progs.values()), pts.shape[0], pl.shape[-1]),
                    dtype=pl.dtype)
    s[a:a + 6] = pl.transpose(0, 1)
    play(progs["aff_norm"], s, F)
    s[r] = F.inv(s[h])
    play(progs["aff_out"], s, F)
    return F.from_plain(s[c:c + 4].transpose(0, 1)).reshape(pts.shape[0], 2, 2, -1)


def jac_double_mirror(pts, g2: bool):
    """curve.cuh's jac_double as K9's group runs it: Jacobian words."""
    lad = _ladder_of(pts, g2)
    F = lad.F
    a = F.to_plain(pts).reshape(pts.shape[0], lad.np, -1)
    s = torch.zeros((lad.slots, pts.shape[0], a.shape[-1]), dtype=a.dtype)
    s[lad.A:lad.A + lad.np] = a.transpose(0, 1)
    play(lad.progs["dbl"], s, F)
    return F.from_plain(s[lad.A:lad.A + lad.np].transpose(0, 1)).reshape(pts.shape)
