"""RHS constructors: the plain twin (euler) and the fused main path (euler_fused)."""

from .euler import entropy_projection, make_euler_rhs
from .euler_fused import make_euler_rhs_fused

__all__ = ["entropy_projection", "make_euler_rhs", "make_euler_rhs_fused"]
