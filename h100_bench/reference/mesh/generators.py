"""Uniform mesh generators for [-1,1]^d (host-side NumPy, 0-based indices).

Capability parity with reference ``src/UniformTriMesh.jl`` (:25),
``src/UniformQuadMesh.jl`` (:25), ``src/UniformHexMesh.jl`` (:25).

Vertex-ordering convention (must stay consistent with the reference
element's low-order nodes, see ``core/ref_elem.py``):
  * tri  vertices: v0=(-1,-1), v1=(1,-1), v2=(-1,1)
  * quad vertices in tensor order: (-1,-1), (1,-1), (-1,1), (1,1)
  * hex  vertices in tensor order (x fastest, then y, then z)

Elements are generated in x-fastest order so that contiguous element
ranges form slabs along the *last* coordinate — convenient for the
element-axis device partition (see ``parallel/partition.py``).
"""

from __future__ import annotations

import numpy as np

LINE_FACE_VERTICES = ((0,), (1,))
TRI_FACE_VERTICES = ((0, 1), (1, 2), (2, 0))
QUAD_FACE_VERTICES = ((0, 1), (1, 3), (2, 3), (0, 2))  # bottom,right,top,left
HEX_FACE_VERTICES = (
    (0, 2, 4, 6),  # r = -1
    (1, 3, 5, 7),  # r = +1
    (0, 1, 4, 5),  # s = -1
    (2, 3, 6, 7),  # s = +1
    (0, 1, 2, 3),  # t = -1
    (4, 5, 6, 7),  # t = +1
)


def uniform_line_mesh(k: int, xl: float = -1.0, xr: float = 1.0):
    """k intervals tiling [xl, xr]. Returns (VX, EToV [K,2])."""
    vx = np.linspace(xl, xr, k + 1)
    etov = np.stack([np.arange(k), np.arange(1, k + 1)], axis=1)
    return vx, etov.astype(np.int64)


def uniform_tri_mesh(kx: int, ky: int | None = None):
    """2*kx*ky right triangles tiling [-1,1]^2.

    Returns (VX, VY, EToV) with EToV of shape [K, 3].
    """
    ky = kx if ky is None else ky
    x1d = np.linspace(-1.0, 1.0, kx + 1)
    y1d = np.linspace(-1.0, 1.0, ky + 1)
    vx, vy = np.meshgrid(x1d, y1d, indexing="xy")
    vx, vy = vx.ravel(), vy.ravel()

    def vid(ex, ey):
        return ex + ey * (kx + 1)

    etov = []
    for ey in range(ky):
        for ex in range(kx):
            i1, i2 = vid(ex, ey), vid(ex + 1, ey)
            i3, i4 = vid(ex + 1, ey + 1), vid(ex, ey + 1)
            etov.append([i1, i2, i3])
            etov.append([i3, i4, i1])
    return vx, vy, np.asarray(etov, dtype=np.int64)


def uniform_quad_mesh(kx: int, ky: int | None = None):
    """kx*ky quads tiling [-1,1]^2. Returns (VX, VY, EToV [K,4])."""
    ky = kx if ky is None else ky
    x1d = np.linspace(-1.0, 1.0, kx + 1)
    y1d = np.linspace(-1.0, 1.0, ky + 1)
    vx, vy = np.meshgrid(x1d, y1d, indexing="xy")
    vx, vy = vx.ravel(), vy.ravel()

    def vid(ex, ey):
        return ex + ey * (kx + 1)

    etov = []
    for ey in range(ky):
        for ex in range(kx):
            etov.append(
                [vid(ex, ey), vid(ex + 1, ey), vid(ex, ey + 1), vid(ex + 1, ey + 1)]
            )
    return vx, vy, np.asarray(etov, dtype=np.int64)


def uniform_hex_mesh(kx: int, ky: int | None = None, kz: int | None = None):
    """kx*ky*kz hexes tiling [-1,1]^3. Returns (VX, VY, VZ, EToV [K,8])."""
    ky = kx if ky is None else ky
    kz = kx if kz is None else kz
    x1d = np.linspace(-1.0, 1.0, kx + 1)
    y1d = np.linspace(-1.0, 1.0, ky + 1)
    z1d = np.linspace(-1.0, 1.0, kz + 1)
    nxp, nyp = kx + 1, ky + 1
    # vertex id = i + nxp*j + nxp*nyp*k  (x fastest)
    vz, vy, vx = np.meshgrid(z1d, y1d, x1d, indexing="ij")
    vx, vy, vz = vx.ravel(), vy.ravel(), vz.ravel()

    def vid(i, j, k):
        return i + nxp * j + nxp * nyp * k

    etov = []
    for ez in range(kz):
        for ey in range(ky):
            for ex in range(kx):
                etov.append(
                    [
                        vid(ex, ey, ez),
                        vid(ex + 1, ey, ez),
                        vid(ex, ey + 1, ez),
                        vid(ex + 1, ey + 1, ez),
                        vid(ex, ey, ez + 1),
                        vid(ex + 1, ey, ez + 1),
                        vid(ex, ey + 1, ez + 1),
                        vid(ex + 1, ey + 1, ez + 1),
                    ]
                )
    return vx, vy, vz, np.asarray(etov, dtype=np.int64)
