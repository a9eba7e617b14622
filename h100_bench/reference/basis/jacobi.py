"""Jacobi polynomials and Gauss-type quadrature (host-side NumPy, float64).

Provides the L2-orthonormal Jacobi polynomial evaluations and quadrature
rules every reference element is built from.  All of this runs once at
setup time on the host; only the resulting small operator matrices ever
reach the device.

Capability parity with reference ``src/Basis1D.jl`` (jacobiP :105,
grad_jacobiP :89, gauss_quad :59, gauss_lobatto_quad :24,
vandermonde_1D :148, grad_vandermonde_1D :164), re-implemented with
vectorized NumPy + SciPy-free Golub-Welsch.
"""

from __future__ import annotations

import math

import numpy as np


def jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Evaluate the degree-``n`` Jacobi polynomial P_n^{(alpha,beta)},
    normalized to unit L2 norm on [-1, 1] w.r.t. the Jacobi weight.

    Three-term recurrence on the orthonormal family.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64)).ravel()
    a, b = float(alpha), float(beta)

    gamma0 = (
        2.0 ** (a + b + 1)
        / (a + b + 1)
        * math.gamma(a + 1)
        * math.gamma(b + 1)
        / math.gamma(a + b + 1)
    )
    p_prev = np.full_like(x, 1.0 / math.sqrt(gamma0))
    if n == 0:
        return p_prev
    gamma1 = (a + 1) * (b + 1) / (a + b + 3) * gamma0
    p_curr = ((a + b + 2) * x / 2 + (a - b) / 2) / math.sqrt(gamma1)
    if n == 1:
        return p_curr

    a_old = 2.0 / (2 + a + b) * math.sqrt((a + 1) * (b + 1) / (a + b + 3))
    for i in range(1, n):
        h1 = 2 * i + a + b
        a_new = (
            2.0
            / (h1 + 2)
            * math.sqrt(
                (i + 1)
                * (i + 1 + a + b)
                * (i + 1 + a)
                * (i + 1 + b)
                / (h1 + 1)
                / (h1 + 3)
            )
        )
        b_new = -(a * a - b * b) / h1 / (h1 + 2)
        p_next = (-a_old * p_prev + (x - b_new) * p_curr) / a_new
        p_prev, p_curr = p_curr, p_next
        a_old = a_new
    return p_curr


def grad_jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """d/dx of the orthonormal Jacobi polynomial of degree ``n``."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64)).ravel()
    if n == 0:
        return np.zeros_like(x)
    return math.sqrt(n * (n + alpha + beta + 1)) * jacobi_p(
        x, alpha + 1, beta + 1, n - 1
    )


def gauss_quad(alpha: float, beta: float, n: int):
    """(n+1)-point Gauss-Jacobi quadrature nodes/weights on [-1, 1].

    Golub-Welsch: eigen-decomposition of the symmetric Jacobi matrix.
    Exact for polynomials of degree <= 2n+1 (w.r.t. the Jacobi weight).
    """
    a, b = float(alpha), float(beta)
    if n == 0:
        # weight = mu0, the total Jacobi-weight mass (2.0 only at a=b=0)
        mu0 = (2.0 ** (a + b + 1) / (a + b + 1)
               * math.gamma(a + 1) * math.gamma(b + 1)
               / math.gamma(a + b + 1))
        return (
            np.array([-(a - b) / (a + b + 2)]),
            np.array([mu0]),
        )

    h1 = 2 * np.arange(n + 1, dtype=np.float64) + a + b
    denom = np.where(h1 == 0.0, 1.0, (h1 + 2) * h1)  # h1[0]=0 iff a+b=0
    diag = -(a * a - b * b) / denom
    if a + b < 10 * np.finfo(np.float64).eps:
        diag[0] = 0.0
    k = np.arange(1, n + 1, dtype=np.float64)
    off = (
        2.0
        / (h1[:n] + 2)
        * np.sqrt(
            k * (k + a + b) * (k + a) * (k + b) / (h1[:n] + 1) / (h1[:n] + 3)
        )
    )
    jmat = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    x, vecs = np.linalg.eigh(jmat)
    mu0 = (
        2.0 ** (a + b + 1)
        / (a + b + 1)
        * math.gamma(a + 1)
        * math.gamma(b + 1)
        / math.gamma(a + b + 1)
    )
    w = vecs[0, :] ** 2 * mu0
    return x, w


def gauss_lobatto_quad(alpha: float, beta: float, n: int):
    """(n+1)-point Gauss-Lobatto quadrature for the (0,0) weight.

    Interior nodes are Gauss points of the (alpha+1, beta+1) weight;
    weights come from the inverse Gram matrix row sums (exactness through
    degree 2n-1).
    """
    if alpha != 0 or beta != 0:
        raise ValueError("gauss_lobatto_quad requires alpha = beta = 0")
    if n == 0:
        return np.array([0.0]), np.array([2.0])
    if n == 1:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])

    xint, _ = gauss_quad(alpha + 1, beta + 1, n - 2)
    x = np.concatenate([[-1.0], xint, [1.0]])
    v = vandermonde_1d(n, x)
    w = np.sum(np.linalg.inv(v @ v.T), axis=1)
    return x, w


def vandermonde_1d(n: int, r: np.ndarray) -> np.ndarray:
    """V[i, j] = P_j(r_i) for the orthonormal Legendre family, j = 0..n."""
    r = np.atleast_1d(np.asarray(r, dtype=np.float64)).ravel()
    return np.stack([jacobi_p(r, 0, 0, j) for j in range(n + 1)], axis=1)


def grad_vandermonde_1d(n: int, r: np.ndarray) -> np.ndarray:
    """Vr[i, j] = P'_j(r_i)."""
    r = np.atleast_1d(np.asarray(r, dtype=np.float64)).ravel()
    return np.stack([grad_jacobi_p(r, 0, 0, j) for j in range(n + 1)], axis=1)
