"""Host-side polynomial bases and quadrature (NumPy float64).

The port's own copy of ``esdg_cns_tpu/basis/``: the same NumPy code, so
the port imports nothing of the JAX package.  ``tests/test_torch_standalone.py``
holds the two copies to the same arrays and the quadrature tables byte-equal.
"""

from .jacobi import (
    gauss_lobatto_quad,
    gauss_quad,
    grad_jacobi_p,
    grad_vandermonde_1d,
    jacobi_p,
    vandermonde_1d,
)

__all__ = [
    "gauss_lobatto_quad",
    "gauss_quad",
    "grad_jacobi_p",
    "grad_vandermonde_1d",
    "jacobi_p",
    "vandermonde_1d",
]
