"""Time integrators."""

from .adaptive import dopri45
from .explicit import lsrk45, ssprk33

__all__ = ["dopri45", "lsrk45", "ssprk33"]
