"""RHS constructors: the plain twins (euler, cns) and the fused paths
(euler_fused over K1/K2, cns_fused over K3/K4)."""

from .cns import make_cns_rhs, make_viscous_rhs
from .cns_fused import make_cns_rhs_affine
from .euler import entropy_projection, l2_error, make_euler_rhs
from .euler_fused import make_euler_rhs_fused

__all__ = [
    "entropy_projection",
    "l2_error",
    "make_cns_rhs",
    "make_cns_rhs_affine",
    "make_euler_rhs",
    "make_euler_rhs_fused",
    "make_viscous_rhs",
]
