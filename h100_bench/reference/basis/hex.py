"""Tensor-product Legendre basis on the reference hexahedron [-1,1]^3.

Capability parity with reference ``src/Basis3DHex.jl`` (vandermonde_3D :25,
grad_vandermonde_3D :47, nodes_3D :77, equi_nodes_3D :92, quad_nodes_3D :105).
"""

from __future__ import annotations

import numpy as np

from .jacobi import (
    gauss_lobatto_quad,
    gauss_quad,
    grad_vandermonde_1d,
    vandermonde_1d,
)


def num_points(n: int) -> int:
    return (n + 1) ** 3


def _tensor3(u, v, w):
    """meshgrid-flattened tensor points (first coordinate varies fastest)."""
    uu, vv, ww = np.meshgrid(u, v, w, indexing="ij")
    # Flatten with the first coord fastest: transpose to (w, v, u) then ravel.
    return (
        uu.transpose(2, 1, 0).ravel(),
        vv.transpose(2, 1, 0).ravel(),
        ww.transpose(2, 1, 0).ravel(),
    )


def vandermonde_3d(n: int, r, s, t) -> np.ndarray:
    vr = vandermonde_1d(n, r)
    vs = vandermonde_1d(n, s)
    vt = vandermonde_1d(n, t)
    return np.einsum("pi,pj,pk->pkji", vr, vs, vt).reshape(len(np.ravel(r)), -1)


def grad_vandermonde_3d(n: int, r, s, t):
    vr, dvr = vandermonde_1d(n, r), grad_vandermonde_1d(n, r)
    vs, dvs = vandermonde_1d(n, s), grad_vandermonde_1d(n, s)
    vt, dvt = vandermonde_1d(n, t), grad_vandermonde_1d(n, t)
    npts = len(np.ravel(r))
    v3dr = np.einsum("pi,pj,pk->pkji", dvr, vs, vt).reshape(npts, -1)
    v3ds = np.einsum("pi,pj,pk->pkji", vr, dvs, vt).reshape(npts, -1)
    v3dt = np.einsum("pi,pj,pk->pkji", vr, vs, dvt).reshape(npts, -1)
    return v3dr, v3ds, v3dt


def nodes_3d(n: int):
    r1d, _ = gauss_lobatto_quad(0, 0, n)
    return _tensor3(r1d, r1d, r1d)


def equi_nodes_3d(n: int):
    r1d = np.linspace(-1.0, 1.0, n + 1)
    return _tensor3(r1d, r1d, r1d)


def quad_nodes_3d(n: int):
    """Tensor Gauss rule with (n+1)^3 points (exact to degree 2n+1)."""
    r1d, w1d = gauss_quad(0, 0, n)
    r, s, t = _tensor3(r1d, r1d, r1d)
    wr, ws, wt = _tensor3(w1d, w1d, w1d)
    return r, s, t, wr * ws * wt
