"""Host-side mesh generation, topology and geometry (NumPy).

The port's own copy of ``esdg_cns_tpu/mesh/``: the same NumPy code, so
the port imports nothing of the JAX package.  ``tests/test_torch_standalone.py``
holds the two copies to the same arrays.
"""

from .connectivity import build_node_maps, connect_mesh, make_periodic
from .generators import (
    HEX_FACE_VERTICES,
    LINE_FACE_VERTICES,
    QUAD_FACE_VERTICES,
    TRI_FACE_VERTICES,
    uniform_hex_mesh,
    uniform_line_mesh,
    uniform_quad_mesh,
    uniform_tri_mesh,
)
from .geometry import geometric_factors_2d, geometric_factors_3d

__all__ = [
    "HEX_FACE_VERTICES",
    "LINE_FACE_VERTICES",
    "uniform_line_mesh",
    "QUAD_FACE_VERTICES",
    "TRI_FACE_VERTICES",
    "build_node_maps",
    "connect_mesh",
    "geometric_factors_2d",
    "geometric_factors_3d",
    "make_periodic",
    "uniform_hex_mesh",
    "uniform_quad_mesh",
    "uniform_tri_mesh",
]
