"""The reference triangle: the benchmark's frozen copy of
``esdg_cns_tpu_torch/core/ref_elem.ref_tri``, in a module of its own
beside ``ref_elem`` (which keeps the hex alone), over the same
``_finalize`` and the reference's own ``basis/tri``.
"""

from __future__ import annotations

import numpy as np

from ..basis import tri as btri
from ..basis.jacobi import gauss_quad
from ..mesh.generators import TRI_FACE_VERTICES
from .ref_elem import RefElem, _finalize


def ref_tri(n: int) -> RefElem:
    """Triangle: warp-&-blend nodes, degree-2N volume quadrature, Gauss
    face quadrature.  Parity: src/SetupDG.jl:151 (init_reference_tri)."""
    r, s = btri.nodes_2d(n)
    vdm = btri.vandermonde_2d(n, r, s)
    inv_vdm = np.linalg.inv(vdm)
    vr, vs = btri.grad_vandermonde_2d(n, r, s)
    dr, ds = vr @ inv_vdm, vs @ inv_vdm

    r1, s1 = btri.nodes_2d(1)
    v1 = btri.vandermonde_2d(1, r, s) @ np.linalg.inv(btri.vandermonde_2d(1, r1, s1))

    # face nodes: degree-N Gauss per edge; edges (s=-1), (hypotenuse), (r=-1)
    r1d, w1d = gauss_quad(0, 0, n)
    nfp = len(r1d)
    e, z = np.ones(nfp), np.zeros(nfp)
    rf = np.concatenate([r1d, -r1d, -e])
    sf = np.concatenate([-e, r1d, -r1d])
    wf = np.tile(w1d, 3)
    nrj = np.concatenate([z, e, -e])
    nsj = np.concatenate([-e, e, z])

    rq, sq, wq = btri.quad_nodes_2d(2 * n)
    vq = btri.vandermonde_2d(n, rq, sq) @ inv_vdm
    vf = btri.vandermonde_2d(n, rf, sf) @ inv_vdm

    rp, sp = btri.equi_nodes_2d(10)
    vp = btri.vandermonde_2d(n, rp, sp) @ inv_vdm

    return _finalize(
        "tri", n, 2, 3, TRI_FACE_VERTICES, (r, s), (rq, sq), wq, (rf, sf),
        wf, (nrj, nsj), (rp, sp), vdm, v1, (dr, ds), vq, vf, vp,
    )
