"""Orthonormal PKDO basis, warp-&-blend nodes, and symmetric quadrature on
the reference triangle {(r,s): r,s >= -1, r+s <= 0}.

Capability parity with reference ``src/Basis2DTri.jl`` (simplex_2D :25,
grad_simplex_2D :41, rstoab :78, xytors :150, vandermonde_2D :99,
nodes_2D :197, quad_nodes_tri :274) — vectorized NumPy re-implementation
of the classical Hesthaven-Warburton construction.

The benchmark's frozen copy of ``esdg_cns_tpu_torch/basis/tri.py``, line
for line but for this paragraph: of the port's symmetric quadrature tables
(``quadrature_data/quad_nodes_tri_N*.txt``, three columns r s w) it keeps
the degree-6 one alone, the volume rule of ``ref_tri(3)``; above degree 27
a collapsed-coordinate Gauss-Jacobi product rule is generated.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .jacobi import (
    gauss_lobatto_quad,
    gauss_quad,
    grad_jacobi_p,
    jacobi_p,
    vandermonde_1d,
)

_QUAD_DATA_DIR = Path(__file__).parent / "quadrature_data"

# Warp-&-blend alpha constants optimized per degree (Warburton 2006).
_ALPHA_OPT = [
    0.0, 0.0, 1.4152, 0.1001, 0.2751, 0.98, 1.0999, 1.2832,
    1.3648, 1.4773, 1.4959, 1.5743, 1.577, 1.6223, 1.6258,
]


def num_points(n: int) -> int:
    return (n + 1) * (n + 2) // 2


def rs_to_ab(r: np.ndarray, s: np.ndarray):
    """Collapsed coordinates: a = 2(1+r)/(1-s) - 1, b = s (a = -1 at s=1)."""
    r = np.asarray(r, dtype=np.float64).ravel()
    s = np.asarray(s, dtype=np.float64).ravel()
    a = np.where(s != 1.0, 2.0 * (1.0 + r) / np.where(s != 1.0, 1.0 - s, 1.0) - 1.0, -1.0)
    return a, s.copy()


def simplex_2d(a: np.ndarray, b: np.ndarray, i: int, j: int) -> np.ndarray:
    """Orthonormal PKDO mode phi_ij on the triangle, in collapsed coords."""
    h1 = jacobi_p(a, 0, 0, i)
    h2 = jacobi_p(b, 2 * i + 1, 0, j)
    return np.sqrt(2.0) * h1 * h2 * (1.0 - b) ** i


def grad_simplex_2d(a: np.ndarray, b: np.ndarray, i: int, j: int):
    """(d/dr, d/ds) of the PKDO mode (i, j) in collapsed coordinates."""
    fa = jacobi_p(a, 0, 0, i)
    gb = jacobi_p(b, 2 * i + 1, 0, j)
    dfa = grad_jacobi_p(a, 0, 0, i)
    dgb = grad_jacobi_p(b, 2 * i + 1, 0, j)

    dr = dfa * gb
    if i > 0:
        dr = dr * (0.5 * (1.0 - b)) ** (i - 1)

    ds = dfa * (gb * (0.5 * (1.0 + a)))
    if i > 0:
        ds = ds * (0.5 * (1.0 - b)) ** (i - 1)
    tmp = dgb * (0.5 * (1.0 - b)) ** i
    if i > 0:
        tmp = tmp - 0.5 * i * gb * (0.5 * (1.0 - b)) ** (i - 1)
    ds = ds + fa * tmp

    scale = 2.0 ** (i + 0.5)
    return scale * dr, scale * ds


def _mode_indices(n: int):
    return [(i, j) for i in range(n + 1) for j in range(n - i + 1)]


def vandermonde_2d(n: int, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    a, b = rs_to_ab(r, s)
    return np.stack([simplex_2d(a, b, i, j) for i, j in _mode_indices(n)], axis=1)


def grad_vandermonde_2d(n: int, r: np.ndarray, s: np.ndarray):
    a, b = rs_to_ab(r, s)
    cols = [grad_simplex_2d(a, b, i, j) for i, j in _mode_indices(n)]
    vr = np.stack([c[0] for c in cols], axis=1)
    vs = np.stack([c[1] for c in cols], axis=1)
    return vr, vs


def xy_to_rs(x: np.ndarray, y: np.ndarray):
    """Equilateral-triangle coordinates -> reference (r, s)."""
    l1 = (np.sqrt(3.0) * y + 1.0) / 3.0
    l2 = (-3.0 * x - np.sqrt(3.0) * y + 2.0) / 6.0
    l3 = (3.0 * x - np.sqrt(3.0) * y + 2.0) / 6.0
    return -l2 + l3 - l1, -l2 - l3 + l1


def warp_factor(n: int, rout: np.ndarray) -> np.ndarray:
    """1D edge warp: pull equispaced nodes toward LGL nodes."""
    lgl_r, _ = gauss_lobatto_quad(0, 0, n)
    req = np.linspace(-1.0, 1.0, n + 1)
    veq = vandermonde_1d(n, req)
    rout = np.asarray(rout, dtype=np.float64).ravel()
    pmat = np.stack([jacobi_p(rout, 0, 0, i) for i in range(n + 1)], axis=0)
    lmat = np.linalg.solve(veq.T, pmat)
    warp = lmat.T @ (lgl_r - req)
    interior = np.abs(rout) < 1.0 - 1.0e-10
    sf = 1.0 - (np.where(interior, rout, 0.0)) ** 2
    return warp / sf + warp * (interior.astype(np.float64) - 1.0)


def nodes_2d(n: int):
    """Warp-&-blend interpolation nodes on the reference triangle."""
    alpha = _ALPHA_OPT[n - 1] if 1 <= n < 16 else 5.0 / 3.0
    if n == 0:
        return np.array([-1.0 / 3.0]), np.array([-1.0 / 3.0])

    l1_list, l3_list = [], []
    for ni in range(n + 1):
        for mi in range(n + 1 - ni):
            l1_list.append(ni / n)
            l3_list.append(mi / n)
    l1 = np.asarray(l1_list)
    l3 = np.asarray(l3_list)
    l2 = 1.0 - l1 - l3

    x = -l2 + l3
    y = (-l2 - l3 + 2.0 * l1) / np.sqrt(3.0)

    blend1 = 4.0 * l2 * l3
    blend2 = 4.0 * l1 * l3
    blend3 = 4.0 * l1 * l2
    w1 = blend1 * warp_factor(n, l3 - l2) * (1.0 + (alpha * l1) ** 2)
    w2 = blend2 * warp_factor(n, l1 - l3) * (1.0 + (alpha * l2) ** 2)
    w3 = blend3 * warp_factor(n, l2 - l1) * (1.0 + (alpha * l3) ** 2)

    x = x + 1.0 * w1 + np.cos(2 * np.pi / 3) * w2 + np.cos(4 * np.pi / 3) * w3
    y = y + 0.0 * w1 + np.sin(2 * np.pi / 3) * w2 + np.sin(4 * np.pi / 3) * w3
    return xy_to_rs(x, y)


def equi_nodes_2d(n: int):
    r1d = np.linspace(-1.0, 1.0, n + 1)
    r, s = [], []
    for i in range(n + 1):
        for j in range(n - i + 1):
            r.append(r1d[i])
            s.append(r1d[j])
    return np.asarray(r), np.asarray(s)


def quad_nodes_tri(n: int):
    """Symmetric quadrature rule exact for degree-``n`` polynomials.

    Degrees 1..27 come from vendored tables; higher degrees fall back to a
    collapsed-coordinate Gauss x Gauss-Jacobi(1,0) product rule.
    """
    n = max(n, 1)
    if n < 28:
        rsw = np.loadtxt(_QUAD_DATA_DIR / f"quad_nodes_tri_N{n}.txt")
        rsw = np.atleast_2d(rsw)
        return rsw[:, 0].copy(), rsw[:, 1].copy(), rsw[:, 2].copy()

    m = (n + 1 + 1) // 2  # ceil((n+1)/2)
    ca, wa = gauss_quad(0, 0, m - 1)
    cb, wb = gauss_quad(1, 0, m - 1)
    a = np.tile(ca[None, :], (m, 1))
    b = np.tile(cb[:, None], (1, m))
    r = 0.5 * (1.0 + a) * (1.0 - b) - 1.0
    s = b
    w = 0.5 * np.outer(wb, wa)
    return r.ravel(), s.ravel(), w.ravel()


def quad_nodes_2d(n: int):
    return quad_nodes_tri(n)
