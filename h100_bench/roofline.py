"""The yardstick of the kernels' roofline shares: the card's published
peaks and a frozen copy of the hand counts of operations and bytes that
``chip_smoke.py`` kept when this benchmark was written (``Ops``,
``split``, ``PAIR_3D``, ``line_pairs``, ``entries``, ``ops_project``,
``ops_k1``, ``ops_k2``, ``ops_face``, ``ops_visc``, ``ops_k4``,
``bound``), with each kernel's bytes written out from its shapes.

A count is a function of the shapes and of the reference's operators
(``entries`` of the plain reference's own Ef, LIFT and composed viscous
operators), never of the program, so no change of a kernel moves it.
The bound is the larger of the bytes leg (each input byte read once and
each output byte written once, over HBM_BYTES_PER_S) and the operations
leg (an FMA two operations, any other kind one, each two-point pair
once, operator products over the entries the operator needs, over
FP32_OPS_PER_S).
"""

from __future__ import annotations

import collections
import functools

import numpy as np

# the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
# operations/s outside the tensor cores in float32 and float64
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

KINDS = ("fma", "mul", "add", "div", "log", "exp", "sqrt", "rsqrt", "pow")


class Ops(dict):
    """Operation counts by kind (KINDS); + adds, * scales by an integer."""

    def __init__(self, **counts):
        unknown = set(counts) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown operation kinds {sorted(unknown)}")
        super().__init__({k: counts.get(k, 0) for k in KINDS})

    def __add__(self, other):
        return Ops(**{k: self[k] + other[k] for k in KINDS})

    def __mul__(self, n):
        return Ops(**{k: self[k] * n for k in KINDS})

    __rmul__ = __mul__

    def flops(self):
        """The data-sheet count: an FMA two operations, any other one."""
        return sum(self.values()) + self["fma"]


def split(total, fma=0, mul=0, **special):
    """A hand total by kind: the special functions and FMAs given, then
    the multiplies given as far as the total allows, add the rest."""
    rest = total - 2 * fma - sum(special.values())
    if rest < 0:
        raise ValueError(f"the kinds exceed the hand total {total}")
    mul = min(mul, rest)
    return Ops(fma=fma, mul=mul, add=rest - mul, **special)


# Pair costs: the 3D EC pair with one metric direction (diag) 74, five of
# them divisions (the two logarithmic means' v, rho's mean, beta's
# reciprocal mean, the pressure average); the general 3-term contraction
# adds the two other directional fluxes (12) and two more metric terms
# per field (20): 106; a curved metric adds the pairwise average of the
# three terms (6): 112.
PAIR_3D = {"diag": split(74, fma=11, mul=29, div=5),
           "general": split(106, fma=23, mul=37, div=5),
           "curved": split(112, fma=23, mul=40, div=5)}

Bound = collections.namedtuple("Bound", "ms by n_bytes ops dtype")


def bound(n_bytes, ops, dtype="float32"):
    """The data-sheet floor in ms: the larger of bytes over the HBM peak
    and operations (FMA two, every other kind one) over the dtype's
    peak."""
    if dtype not in ("float32", "float64"):
        raise ValueError(f"bound: dtype {dtype}")
    peak = FP64_OPS_PER_S if dtype == "float64" else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops.flops() / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return Bound(max(t_bytes, t_ops), by, n_bytes, ops, dtype)


def line_pairs(n1):
    """Pairs of the line loop per element: the triangular vol-vol pairs of
    each line and its two vol-face couplings, over 3 directions."""
    return 3 * n1 * n1 * (n1 * (n1 - 1) // 2 + 2 * n1)


def entries(op):
    """Entries of an operator that its product needs: those above its
    roundoff (1e-12 of its largest)."""
    a = np.abs(np.asarray(op))
    return int((a > 1e-12 * a.max()).sum())


def ops_project(n1, ef_entries):
    """The entropy projection: v(U) at the volume nodes (ten divisions,
    three logs), Ef v, and U(v_f) with the flux variables and logs at the
    face points (two pows, an exp, eight divisions, two logs)."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return (split(27, fma=3, mul=9, div=10, log=3) * nq
            + Ops(fma=ef_entries * 5)
            + split(40, fma=4, mul=12, div=8, log=2, exp=1, pow=2) * nfq)


def ops_k1(n1, ef_entries, lift_entries, form="diag"):
    """K1: the projection, the pairs at the form's cost, the face rows'
    1/wf, LIFT over each point's lines and 2 (1/wq) acc + 2 LIFT."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return (ops_project(n1, ef_entries) + PAIR_3D[form] * line_pairs(n1)
            + Ops(mul=5) * nfq + Ops(fma=lift_entries * 5)
            + split(15, fma=5, mul=6) * nq)


def ops_k2(n1, lift_entries, diag=True, split_form=False):
    """At every face node the EC pair (five divisions), both sides'
    conservative states, both wave speeds (three divisions and a square
    root each) and LF; the general form adds the two other directional
    fluxes, two more normal terms per field and the 3-component normal
    velocity of both sides.  The split form adds the combine: 2 (1/wf)
    face rows at each face node, and at each volume node 2 (1/wq) times
    the three parts' sum where ph_qf was read."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    face = (split(120, fma=22, mul=52, div=14, sqrt=2) if diag
            else split(160, fma=38, mul=60, div=13, sqrt=2))
    if split_form:
        face = face + Ops(fma=5, mul=1)
    node = split(26, fma=5, mul=6) if split_form else split(15, mul=5)
    return face * nfq + Ops(fma=lift_entries * 5) + node * nq


def ops_face(dim, rebuild_local):
    """One face node of the CNS surface stage: the traces rebuilt (the
    neighbour's conservative (one division) and entropy ones, with
    rebuild_local the local ones too), the BC ghosts and ghost logs, the
    EC pair (five divisions) and its dim directions contracted with the
    normal, LF (two wave speeds: two divisions and a square root each),
    the entropy BC, the jump and the penalty rows (two divisions)."""
    nf = dim + 2
    cons = split(3 * dim + 4, fma=dim, mul=dim + 4, div=1)
    evars = split(3 * dim + 7, fma=dim + 1, mul=dim + 3)
    rebuild = (cons + evars) * (2 if rebuild_local else 1)
    ghosts = split(7 * dim + 2, fma=2 * dim - 1, log=2)
    pair = split(34 + 4 * dim + dim * (2 * dim + 2 + 2 * nf),
                 fma=7 + 2 * dim + (dim - 1) * nf, mul=2, div=5)
    lf = split(4 * dim + 19 + 3 * nf, fma=2 * (dim - 1) + nf, div=4,
               sqrt=2)
    return (rebuild + ghosts + pair + lf + Ops(add=nf)
            + split(4 * dim + 6, div=2) + Ops(add=nf))


def ops_visc(dim, nq, nfq, front, vqlift, ef, drpq):
    """One element of the viscous mid-section, each contraction formed
    once: the front product; the surface gradient term; per quadrature
    node the gradients, K(v) (190 operations in 3D; two divisions) and
    the production; the contracted traction; the divergence."""
    nf = dim + 2
    sigma = {1: 20, 2: 83, 3: 190}[dim]
    front = Ops(fma=entries(front) * nf)
    surface = (Ops(fma=dim * entries(vqlift) * nf)
               + Ops(mul=nfq * nf * (1 + dim)))
    node = (Ops(fma=nf * dim * (dim - 1), mul=2 * nf * dim, add=nf * dim)
            + split(sigma, div=2) + split(3 * dim * nf, fma=dim * nf))
    traction = Ops(fma=dim * nf * entries(ef) + nfq * dim * nf)
    div = (Ops(fma=dim * (dim - 1) * nf * nq, mul=dim * nf * nq)
           + Ops(fma=entries(drpq) * nf))
    return front + surface + node * nq + traction + div


def ops_k4(dim, np_, nq, nfq, front, vqlift, ef, drpq, lift):
    """K4 in the tail-folded form the cavity paths run."""
    fold = (Ops(fma=2 * (dim + 2) * entries(lift))
            + Ops(add=6 * (dim + 2) * np_))
    return (ops_face(dim, True) * nfq
            + ops_visc(dim, nq, nfq, front, vqlift, ef, drpq) + fold)


@functools.lru_cache(maxsize=16)
def hex_operators(n):
    """The plain reference's hex operators of degree n (float64 NumPy):
    Ef, LIFT and the composed viscous operators of the collocated front
    (the gradient rows [Vq D_r Pq], Vq LIFT, D_r Pq)."""
    from h100_bench.reference.core.ref_elem import ref_hex

    ref = ref_hex(n)
    nq = ref.nq
    drpq = [d @ ref.pq for d in ref.d]
    return dict(nq=nq, np_=ref.np_, nfq=ref.nfq, ef=ref.vhp[nq:],
                lift=ref.lift, front=np.concatenate([ref.vq @ d
                                                     for d in drpq]),
                vqlift=ref.vq @ ref.lift, drpq=np.stack(drpq))


# Bytes, per element, of each kernel as the paths run it (rows of
# [.., K] arrays; the operators once).  ITEM is the state's itemsize.
ITEM = 4


def k1_bound(n, k):
    """K1 (diag) on one stage: q, geo [9, 1, K], Ef, LIFT in; ph_qf
    [5, Nq, K] and the traces [7, Nfq, K] out."""
    op = hex_operators(n)
    nq, nfq = op["nq"], op["nfq"]
    rows = 5 * nq + 9 + 5 * nq + 7 * nfq
    n_bytes = (rows * k + op["ef"].size + op["lift"].size) * ITEM
    ops = ops_k1(n + 1, entries(op["ef"]), entries(op["lift"])) * k
    return bound(n_bytes, ops)


def k2_bound(n, k, split_form=False):
    """K2 (diag, the grid form): the traces (the neighbours' are the same
    array), the compact normal [1, Nfq, K], 1/J [1, K], LIFT and ph_qf
    in; dq [5, Nq, K] out.  After the split front it reads the three
    direction parts [5, Nq + 2 Nfp, K] and 1/wq, 1/wf in place of ph_qf
    and sums them (the split form)."""
    op = hex_operators(n)
    nq, nfq = op["nq"], op["nfq"]
    nfp = nfq // 6
    rows = 7 * nfq + nfq + 1 + 5 * nq
    rows += 3 * 5 * (nq + 2 * nfp) if split_form else 5 * nq
    extra = op["lift"].size + (nq + nfp if split_form else 0)
    return bound((rows * k + extra) * ITEM,
                 ops_k2(n + 1, entries(op["lift"]), split_form=split_form)
                 * k)


def fd_dir_bound(n, k):
    """One direction of the split fd (diag): its volume points and its
    two faces' points of qh and qlog (7 rows), one metric row in;
    [5, Nq + 2 Nfp, K] out; the direction's pairs (a third of
    line_pairs)."""
    n1 = n + 1
    nq, nfp = n1 ** 3, n1 * n1
    rows = 7 * (nq + 2 * nfp) + 1 + 5 * (nq + 2 * nfp)
    return bound(rows * k * ITEM, PAIR_3D["diag"] * (line_pairs(n1) // 3 * k))


# the wall-state rows K4 reads on the cavity: the three reference
# normals, the boundary mask, the adiabatic mask and each region's mask
# (lid, walls); the wall velocities and temperature are scalars
CAVITY_POOL_ROWS = 7


def k4_bound(n, k, pool_rows=CAVITY_POOL_ROWS):
    """K4 at dim 3 (collocated front, tail folded) on one stage: v(U)
    [5, Nq, K], qm [5, Nfq, K], its logs [2, Nfq, K], the neighbour
    traces [7, Nfq, K], nxj [3, Nfq, K], sj and 1/sj, the wall rows,
    geo [9, 1, K], 1/J [1, K], wJq [Nq, K], ph_qf [5, Np, K] and the
    operators in; dq [5, Np, K], the traction [5, Nfq, K] and the
    production [K] out.  chip_smoke's count also wrote v(U) [5, Nq, K],
    which the dim-3 kernel without the projection hands back as it came
    in: it is left out here."""
    op = hex_operators(n)
    nq, np_, nfq = op["nq"], op["np_"], op["nfq"]
    rows = (5 * nq + 5 * nfq + 2 * nfq + 7 * nfq + 3 * nfq + 2 * nfq
            + pool_rows * nfq + 9 + 1 + nq + 5 * np_
            + 5 * np_ + 5 * nfq + 1)
    opers = sum(op[key].size for key in ("front", "vqlift", "ef", "drpq",
                                         "lift"))
    ops = ops_k4(3, np_, nq, nfq, op["front"], op["vqlift"], op["ef"],
                 op["drpq"], op["lift"]) * k
    return bound((rows * k + opers) * ITEM, ops)
