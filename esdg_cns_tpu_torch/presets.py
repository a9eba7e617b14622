"""Canonical problem setups.

Port of ``esdg_cns_tpu.presets.euler_hex_3d``, the main-path
configuration.  The initial state is drawn with numpy
``default_rng(seed)`` exactly as the JAX preset draws it, so both
packages start from identical bits.
"""

from __future__ import annotations

import numpy as np
import torch

from esdg_cns_tpu.mesh.generators import uniform_hex_mesh

from .core import build_discretization, ref_hex
from .physics import primitive_to_conservative


def euler_hex_3d(n: int = 3, k1d: int = 8, *, curved: bool = False,
                 seed: int = 0, dtype: torch.dtype, device):
    """3D periodic Euler on a Gauss-collocated hex mesh with the EC
    random-field initial condition (reference dg3D_euler_hex.jl:20-112).

    Returns (disc, q0) with q0 [5, Np, K] on ``device`` in ``dtype``.
    """
    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    warp = None
    if curved:
        def warp(x, y, z):
            d = 0.1 * (x - 1) * (x + 1) * (y - 1) * (y + 1) * (z - 1) * (z + 1)
            return x + d, y + d, z + d
    disc = build_discretization(
        ref_hex(n), (vx, vy, vz), etov, periodic_axes=(0, 1, 2),
        curved_map=warp, dtype=dtype, device=device,
        grid_shape=(k1d, k1d, k1d),
    )
    rng = np.random.default_rng(seed)
    sh = (disc.np_, disc.num_elements)
    rho = 2.0 + 0.1 * rng.random(sh)
    vel = np.stack([np.zeros(sh), np.ones(sh), np.zeros(sh)])
    p = 1.0 + 0.1 * rng.random(sh)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q0 = primitive_to_conservative(f(rho), f(vel), f(p))
    return disc, q0
