"""Reference-element operator construction (host-side NumPy float64).

The PyTorch port's copy of ``esdg_cns_tpu/core/ref_elem.py``: the same
NumPy code, line for line, over the port's own copies of ``basis`` and
``mesh``, so both packages build bit-identical operators.

The framework nucleus, capability parity with reference ``src/SetupDG.jl``
(RefElemData :38-75; init_reference_interval :117, _tri :151, _quad :205,
_hex :323) plus the script-level hybridized SBP construction that every
entropy-stable example script repeats (e.g. reference
``examples/dg2D_euler_tri.jl:45-77``), promoted here to a first-class
framework component.

Design notes:
  * Everything here is one-time host-side setup; outputs are small dense
    float64 matrices that ``core.discretization`` casts to the compute
    dtype and moves to the device.
  * ``node_type='gauss'`` for quad/hex collocates the solution nodes with
    the tensor-product Gauss quadrature: then Vq = I, Pq = I and the mass
    matrix is exactly diagonal, which removes two GEMMs from the RHS (the
    formulation used by the reference hex example, dg3D_euler_hex.jl:95-98)
    while remaining a special case of the one general operator set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..basis import hex as bhex
from ..basis import quad as bquad
from ..basis.jacobi import (
    gauss_lobatto_quad,
    gauss_quad,
    grad_vandermonde_1d,
    vandermonde_1d,
)
from ..mesh.generators import (
    HEX_FACE_VERTICES,
)


@dataclasses.dataclass(frozen=True)
class RefElem:
    """All reference-element operators for one element type/degree.

    Shapes: Np = solution nodes, Nq = volume quadrature points,
    Nfq = total surface quadrature points (Nfaces * Nfp),
    Nh = Nq + Nfq (hybridized points).
    """

    elem_type: str                      # 'line' | 'tri' | 'quad' | 'hex'
    n: int                              # polynomial degree
    dim: int
    nfaces: int
    face_vertices: tuple

    r: tuple                            # dim arrays [Np] solution nodes
    rq: tuple                           # dim arrays [Nq]
    wq: np.ndarray                      # [Nq]
    rf: tuple                           # dim arrays [Nfq]
    wf: np.ndarray                      # [Nfq]
    nrst_j: tuple                       # dim arrays [Nfq] reference normals
    rp: tuple                           # plotting nodes

    vdm: np.ndarray                     # modal -> nodal at r
    v1: np.ndarray                      # [Np, Nverts] vertex interpolation
    d: tuple                            # dim arrays [Np, Np] nodal D matrices
    vq: np.ndarray                      # [Nq, Np]
    vf: np.ndarray                      # [Nfq, Np]
    m: np.ndarray                       # [Np, Np] mass
    pq: np.ndarray                      # [Np, Nq] quadrature L2 projection
    lift: np.ndarray                    # [Np, Nfq]
    vp: np.ndarray                      # plotting interpolation

    # hybridized SBP operators
    q_skew: tuple                       # dim arrays [Nh, Nh], skew part
    vh: np.ndarray                      # [Nh, Np] = [Vq; Vf]
    ph: np.ndarray                      # [Np, Nh] = M^{-1} Vh'
    vhp: np.ndarray                     # [Nh, Nq] = Vh Pq (entropy proj)
    ef: np.ndarray                      # [Nfq, Nq] = Vf Pq

    @property
    def np_(self) -> int:
        return self.vdm.shape[0]

    @property
    def nq(self) -> int:
        return len(self.wq)

    @property
    def nfq(self) -> int:
        return len(self.wf)

    @property
    def nfp(self) -> int:
        return self.nfq // self.nfaces

    @property
    def nh(self) -> int:
        return self.nq + self.nfq

    @property
    def collocated(self) -> bool:
        return self.nq == self.np_ and np.allclose(self.vq, np.eye(self.nq))


def _hybridized_sbp(m, d_mats, pq, vq, vf, wf, nrst_j):
    """Build skew-symmetric hybridized SBP operators.

    Qi = Pq' M Di Pq ; Ef = Vf Pq ; Bi = diag(wf * n_i) ;
    Qih = 1/2 [[Qi - Qi', Ef' Bi], [-Bi Ef, Bi]] ; return skew(Qih).

    Reference pattern: dg2D_euler_tri.jl:45-63, dg3D_euler_hex.jl:34-55.
    """
    ef = vf @ pq
    q_skew = []
    for di, nj in zip(d_mats, nrst_j):
        qi = pq.T @ m @ di @ pq
        bi = np.diag(wf * nj)
        top = np.hstack([qi - qi.T, ef.T @ bi])
        bot = np.hstack([-bi @ ef, bi])
        qih = 0.5 * np.vstack([top, bot])
        q_skew.append(0.5 * (qih - qih.T))
    return tuple(q_skew), ef


def _finalize(elem_type, n, dim, nfaces, face_vertices, r, rq, wq, rf, wf,
              nrst_j, rp, vdm, v1, d_mats, vq, vf, vp):
    m = vq.T @ np.diag(wq) @ vq
    minv = np.linalg.inv(m)
    pq = minv @ vq.T @ np.diag(wq)
    lift = minv @ vf.T @ np.diag(wf)
    q_skew, ef = _hybridized_sbp(m, d_mats, pq, vq, vf, wf, nrst_j)
    vh = np.vstack([vq, vf])
    ph = minv @ vh.T
    vhp = vh @ pq
    return RefElem(
        elem_type=elem_type, n=n, dim=dim, nfaces=nfaces,
        face_vertices=face_vertices, r=r, rq=rq, wq=wq, rf=rf, wf=wf,
        nrst_j=nrst_j, rp=rp, vdm=vdm, v1=v1, d=tuple(d_mats), vq=vq, vf=vf,
        m=m, pq=pq, lift=lift, vp=vp, q_skew=q_skew, vh=vh, ph=ph, vhp=vhp,
        ef=ef,
    )


def _quad_1d_nodes(n: int, node_type: str):
    if node_type == "gauss":
        return gauss_quad(0, 0, n)
    if node_type == "lobatto":
        return gauss_lobatto_quad(0, 0, n)
    raise ValueError(f"unknown node_type {node_type!r}")


def ref_hex(n: int, node_type: str = "gauss",
            quad_type: str = None) -> RefElem:
    """Hexahedron with tensor Legendre basis (default: Gauss collocation;
    node_type=quad_type='lobatto' gives the DG-SEM variant).

    Parity: src/SetupDG.jl:323 (init_reference_hex)."""
    r1d, _ = _quad_1d_nodes(n, node_type)
    quad_type = "gauss" if quad_type is None else quad_type
    rq1d, wq1d = _quad_1d_nodes(n, quad_type)

    r, s, t = bhex._tensor3(r1d, r1d, r1d)
    vdm = bhex.vandermonde_3d(n, r, s, t)
    inv_vdm = np.linalg.inv(vdm)
    vr, vs, vt = bhex.grad_vandermonde_3d(n, r, s, t)
    dr, ds, dt = vr @ inv_vdm, vs @ inv_vdm, vt @ inv_vdm

    pm = np.array([-1.0, 1.0])
    r1v, s1v, t1v = bhex._tensor3(pm, pm, pm)
    v1 = bhex.vandermonde_3d(1, r, s, t) @ np.linalg.inv(
        bhex.vandermonde_3d(1, r1v, s1v, t1v)
    )

    # face quadrature: tensor Gauss on each of the 6 faces
    fq_a, fq_b = bquad._tensor2(rq1d, rq1d)
    fw_a, fw_b = bquad._tensor2(wq1d, wq1d)
    wface = fw_a * fw_b
    nfp = len(wface)
    e, z = np.ones(nfp), np.zeros(nfp)
    # faces: r=-1, r=+1, s=-1, s=+1, t=-1, t=+1
    rf = np.concatenate([-e, e, fq_a, fq_a, fq_a, fq_a])
    sf = np.concatenate([fq_a, fq_a, -e, e, fq_b, fq_b])
    tf = np.concatenate([fq_b, fq_b, fq_b, fq_b, -e, e])
    wf = np.tile(wface, 6)
    nrj = np.concatenate([-e, e, z, z, z, z])
    nsj = np.concatenate([z, z, -e, e, z, z])
    ntj = np.concatenate([z, z, z, z, -e, e])

    rq, sq, tq = bhex._tensor3(rq1d, rq1d, rq1d)
    wr, ws, wt = bhex._tensor3(wq1d, wq1d, wq1d)
    wq = wr * ws * wt
    vq = bhex.vandermonde_3d(n, rq, sq, tq) @ inv_vdm
    vf = bhex.vandermonde_3d(n, rf, sf, tf) @ inv_vdm

    rp, sp, tp = bhex.equi_nodes_3d(6)
    vp = bhex.vandermonde_3d(n, rp, sp, tp) @ inv_vdm

    return _finalize(
        "hex", n, 3, 6, HEX_FACE_VERTICES, (r, s, t), (rq, sq, tq), wq,
        (rf, sf, tf), wf, (nrj, nsj, ntj), (rp, sp, tp), vdm, v1,
        (dr, ds, dt), vq, vf, vp,
    )
