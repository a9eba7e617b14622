"""The yardstick of K3's and K4's roofline shares on the modal triangle
(the 2D cavity's dim-2 forms), beside ``roofline.py``'s hex counts and
on its peaks, ``Ops``, ``split``, ``entries``, ``ops_k4`` and ``bound``:
a frozen copy of the hand counts of ``probes/counts.py`` (``PAIR_MODAL``,
``needed_pairs``, ``ops_k3``), with each kernel's bytes written out from
its shapes.

A count is a function of the shapes and of the plain reference's own tri
operators (``reference.core.ref_tri``), never of the program, so no
change of a kernel moves it.
"""

from __future__ import annotations

import functools

import numpy as np

from h100_bench import roofline
from h100_bench.roofline import ITEM, Ops, entries, split

# the 2D EC pair with both directions, the metric contraction and both
# rows' accumulation: 85 operations, five of them divisions
PAIR_TRI = split(85, fma=29, mul=22, div=5)

# the wall-state rows K4 reads on the 2D cavity: the two reference
# normals, the boundary mask, the adiabatic mask and each region's mask
# (lid, walls); the wall velocities and temperature are scalars
CAVITY_POOL_ROWS_2D = 6


@functools.lru_cache(maxsize=8)
def tri_operators(n):
    """The plain reference's tri operators of degree n (float64 NumPy):
    K3's Vq, Vh Pq, Ph and the skew operators; K4's composed operators
    (front [Vq Pq; Vq D_r Pq], Vq LIFT, Ef = Vf Pq, D_r Pq) and LIFT."""
    from h100_bench.reference.core.ref_tri import ref_tri

    ref = ref_tri(n)
    drpq = [d @ ref.pq for d in ref.d]
    return dict(np_=ref.np_, nq=ref.nq, nfq=ref.nfq, nh=ref.nh, vq=ref.vq,
                vhp=ref.vhp, ph=ref.ph, q_skew=np.stack(ref.q_skew),
                front=np.concatenate([ref.vq @ ref.pq]
                                     + [ref.vq @ dp for dp in drpq]),
                vqlift=ref.vq @ ref.lift, ef=ref.vhp[ref.nq:],
                drpq=np.stack(drpq), lift=ref.lift)


def needed_pairs(q_skew, nq):
    """The pairs i < j of K3's sum that the data needs: those with an
    operator entry of any direction above roundoff (1e-12 of the largest),
    the zero face-face block left out (every pair on the tri)."""
    a = np.abs(q_skew)
    nz = (a > 1e-12 * a.max()).any(0)
    nz[nq:, nq:] = False
    return int(np.triu(nz, 1).sum())


def ops_k3(op):
    """K3 per element at dim 2: the three operator products over their
    entries (Vq, Vh Pq, Ph), v(U) (five divisions, two logs) at each
    quadrature point, U(v) (six divisions, two pows, an exp, two logs)
    with the flux variables and logs at each hybridized point, the pairs
    at the 2D pair cost, and the doubling of QF."""
    dim, nf = 2, 4
    return (Ops(fma=nf * (entries(op["vq"]) + entries(op["vhp"])
                          + entries(op["ph"])))
            + split(10 + 5 * dim, fma=dim, mul=5 + dim, div=3 + dim,
                    log=2) * op["nq"]
            + split(30 + 5 * dim, fma=2 * dim - 2, mul=11, div=4 + dim,
                    log=2, exp=1, pow=2) * op["nh"]
            + PAIR_TRI * needed_pairs(op["q_skew"], op["nq"])
            + Ops(mul=nf) * op["np_"])


def k3_bound(n, k):
    """K3 at dim 2 (affine) on one stage: q [4, Np, K], geo [4, 1, K] and
    the operators (Q_r [2, Nh, Nh], Vq, Vh Pq, Ph) in; ph_qf [4, Np, K],
    the traces [6, Nfq, K] and v(U) [4, Nq, K] out."""
    op = tri_operators(n)
    np_, nq, nfq = op["np_"], op["nq"], op["nfq"]
    rows = 4 * np_ + 4 + 4 * np_ + 6 * nfq + 4 * nq
    opers = sum(op[key].size for key in ("q_skew", "vq", "vhp", "ph"))
    return roofline.bound((rows * k + opers) * ITEM, ops_k3(op) * k)


def k4_bound(n, k, pool_rows=CAVITY_POOL_ROWS_2D):
    """K4 at dim 2 with the projection and the tail folded, on one stage:
    v(U) [4, Nq, K], qm [4, Nfq, K], its logs [2, Nfq, K], the neighbour
    traces [6, Nfq, K], nxj [2, Nfq, K], sj and 1/sj, the wall rows, geo
    [4, 1, K], 1/J [1, K], wJq [Nq, K], ph_qf [4, Np, K] and the operators
    (front, Vq LIFT, Ef, D_r Pq, LIFT) in; dq [4, Np, K], the traction
    [4, Nfq, K], the production [1, K] and the projected v [4, Nq, K]
    out."""
    op = tri_operators(n)
    np_, nq, nfq = op["np_"], op["nq"], op["nfq"]
    rows = (4 * nq + 4 * nfq + 2 * nfq + 6 * nfq + 2 * nfq + 2 * nfq
            + pool_rows * nfq + 4 + 1 + nq + 4 * np_
            + 4 * np_ + 4 * nfq + 1 + 4 * nq)
    opers = sum(op[key].size for key in ("front", "vqlift", "ef", "drpq",
                                         "lift"))
    ops = roofline.ops_k4(2, np_, nq, nfq, op["front"], op["vqlift"],
                          op["ef"], op["drpq"], op["lift"]) * k
    return roofline.bound((rows * k + opers) * ITEM, ops)
