"""Reference elements and the device-resident discretization."""

from .discretization import Discretization, build_discretization
from .ref_elem import RefElem, make_ref_elem, ref_hex, ref_line, ref_quad, ref_tri

__all__ = [
    "Discretization",
    "RefElem",
    "build_discretization",
    "make_ref_elem",
    "ref_hex",
    "ref_line",
    "ref_quad",
    "ref_tri",
]
