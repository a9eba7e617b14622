"""Tensor-product Legendre basis on the reference quadrilateral [-1,1]^2.

Capability parity with reference ``src/Basis2DQuad.jl`` (vandermonde_2D :25,
grad_vandermonde_2D :48, nodes_2D :77, equi_nodes_2D :93, quad_nodes_2D :110).
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
    return (n + 1) ** 2


def _tensor2(u: np.ndarray, v: np.ndarray):
    """meshgrid-flattened tensor points: first coord varies fastest."""
    uu, vv = np.meshgrid(u, v, indexing="xy")
    return uu.ravel(), vv.ravel()


def vandermonde_2d(n: int, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    vr = vandermonde_1d(n, r)
    vs = vandermonde_1d(n, s)
    # mode (i, j) -> P_i(r) P_j(s); column order: j outer, i inner
    return np.einsum("pi,pj->pji", vr, vs).reshape(len(np.ravel(r)), -1)


def grad_vandermonde_2d(n: int, r: np.ndarray, s: np.ndarray):
    vr, dvr = vandermonde_1d(n, r), grad_vandermonde_1d(n, r)
    vs, dvs = vandermonde_1d(n, s), grad_vandermonde_1d(n, s)
    npts = len(np.ravel(r))
    v2dr = np.einsum("pi,pj->pji", dvr, vs).reshape(npts, -1)
    v2ds = np.einsum("pi,pj->pji", vr, dvs).reshape(npts, -1)
    return v2dr, v2ds


def nodes_2d(n: int):
    r1d, _ = gauss_lobatto_quad(0, 0, n)
    return _tensor2(r1d, r1d)


def equi_nodes_2d(n: int):
    r1d = np.linspace(-1.0, 1.0, n + 1)
    return _tensor2(r1d, r1d)


def quad_nodes_2d(n: int):
    """Tensor Gauss rule with (n+1)^2 points (exact to degree 2n+1)."""
    r1d, w1d = gauss_quad(0, 0, n)
    r, s = _tensor2(r1d, r1d)
    wr, ws = _tensor2(w1d, w1d)
    return r, s, wr * ws
