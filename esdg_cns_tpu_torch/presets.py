"""Canonical problem setups.

Port of ``esdg_cns_tpu.presets``: ``euler_hex_3d`` (the periodic Euler
main path, affine or curved), ``lid_driven_cavity`` (the 2D CNS cavity
on tris) and ``lid_driven_cavity_3d`` (the 3D CNS cavity on hexes);
``square_warp`` curves a mesh of [-1, 1]^2 the way ``euler_hex_3d``
curves the cube.  States, masks and parameters are built with the same
NumPy and IEEE operations as the JAX presets, so both packages start from
identical bits in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import build_discretization, ref_hex, ref_tri
from .mesh.generators import uniform_hex_mesh, uniform_tri_mesh
from .physics import primitive_to_conservative
from .solvers.boundary import Region, make_wall_bc, region_from_indicator


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


def square_warp(x, y, alpha: float = 0.1):
    """``euler_hex_3d``'s warp in 2D, a ``curved_map`` for
    ``core.build_discretization``: (x, y) + d with
    d = alpha (x-1)(x+1)(y-1)(y+1).  d vanishes on the boundary of
    [-1, 1]^2, so the square and its faces stay where they are while every
    interior element is curved (metric at every hybridized point).
    NumPy in, NumPy out."""
    d = alpha * (x - 1) * (x + 1) * (y - 1) * (y + 1)
    return x + d, y + d


def lid_driven_cavity(n: int = 3, k1d: int = 16, *,
                      bctype: str = "isothermal", ma: float = 0.3,
                      re: float = 1000.0, lid_profile=None,
                      gamma: float = 1.4, dtype: torch.dtype, device):
    """2D CNS lid-driven cavity on [-1,1]^2 with tri elements (reference
    dg2D_CNS_cavity_optimized.jl: BCTYPE 1/2/3, Ma=0.3, Re=1000): the lid
    y = 1 moves at u = 1 (or ``lid_profile(x)``, a NumPy function of the
    face x-coordinates), the other walls are at rest; all walls of kind
    ``bctype``.

    Returns (disc, q0, bc, params) with q0 [4, Np, K] the fluid at rest
    (rho = 1, p = 1/(Ma^2 gamma)) and params {mu, pr, re, gamma, ma}.
    """
    vx, vy, etov = uniform_tri_mesh(k1d)
    disc = build_discretization(ref_tri(n), (vx, vy), etov, dtype=dtype,
                                device=device)

    tol = 1e-10
    theta = (1.0 / (ma * ma * gamma * (gamma - 1.0))
             if bctype == "isothermal" else None)
    lid = region_from_indicator(
        disc, lambda x, y: np.abs(y - 1) < tol, bctype,
        u_wall=(1.0, 0.0), theta=theta,
    )
    if lid_profile is not None:
        prof = lid_profile(disc.xf[0].cpu().numpy())
        lid = Region(mask=lid.mask, kind=bctype,
                     u_wall=(torch.as_tensor(prof, dtype=dtype,
                                             device=device), 0.0),
                     theta=lid.theta)
    walls = region_from_indicator(
        disc, lambda x, y: np.abs(y - 1) >= tol, bctype,
        u_wall=(0.0, 0.0), theta=theta,
    )
    bc = make_wall_bc(disc, [lid, walls])

    sh = (disc.np_, disc.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q0 = primitive_to_conservative(
        f(np.ones(sh)), f(np.zeros((2, *sh))),
        f(np.full(sh, 1.0 / (ma * ma * gamma))), gamma,
    )
    params = dict(mu=1.0 / re, pr=0.71, re=re, gamma=gamma, ma=ma)
    return disc, q0, bc, params


def lid_driven_cavity_3d(n: int = 2, k1d: int = 8, *,
                         bctype: str = "isothermal", ma: float = 0.3,
                         re: float = 100.0, gamma: float = 1.4,
                         dtype: torch.dtype, device):
    """3D CNS lid-driven cavity on [-1,1]^3 with Gauss-collocated hex
    elements (no periodic axis, so the exchange is the map_p gather): the
    lid z = 1 moves at u = (1, 0, 0), every other face is a wall at rest;
    all walls of kind ``bctype``.

    Returns (disc, q0, bc, params) with q0 [5, Np, K] the fluid at rest
    (rho = 1, p = 1/(Ma^2 gamma)) and params {mu, pr, re, gamma, ma}.
    """
    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    disc = build_discretization(ref_hex(n), (vx, vy, vz), etov, dtype=dtype,
                                device=device)

    tol = 1e-10
    theta = (1.0 / (ma * ma * gamma * (gamma - 1.0))
             if bctype == "isothermal" else None)
    lid = region_from_indicator(
        disc, lambda x, y, z: np.abs(z - 1) < tol, bctype,
        u_wall=(1.0, 0.0, 0.0), theta=theta,
    )
    walls = region_from_indicator(
        disc, lambda x, y, z: np.abs(z - 1) >= tol, bctype,
        u_wall=(0.0, 0.0, 0.0), theta=theta,
    )
    bc = make_wall_bc(disc, [lid, walls])

    sh = (disc.np_, disc.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q0 = primitive_to_conservative(
        f(np.ones(sh)), f(np.zeros((3, *sh))),
        f(np.full(sh, 1.0 / (ma * ma * gamma))), gamma,
    )
    params = dict(mu=1.0 / re, pr=0.71, re=re, gamma=gamma, ma=ma)
    return disc, q0, bc, params
