"""Canonical problem setups.

Port of ``esdg_cns_tpu.presets``: ``euler_hex_3d`` (the periodic Euler
main path, affine or curved), ``lid_driven_cavity`` (the 2D CNS cavity
on tris), ``lid_driven_cavity_3d`` (the 3D CNS cavity on hexes) and the
Becker viscous shock tubes ``becker_shocktube_1d`` / ``_2d`` / ``_3d``
(lines, tris, hexes; Dirichlet far-field states from the exact wave);
``square_warp`` curves a mesh of [-1, 1]^2 the way ``euler_hex_3d``
curves the cube.  States, masks and parameters are built with the same
NumPy and IEEE operations as the JAX presets, so both packages start from
identical bits in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import build_discretization, ref_hex, ref_line, ref_tri
from .mesh.generators import (uniform_hex_mesh, uniform_line_mesh,
                              uniform_tri_mesh)
from .physics import (conservative_to_primitive_beta,
                      primitive_to_conservative, v_ufun)
from .physics.exact import BeckerShock
from .solvers.boundary import Region, make_wall_bc, region_from_indicator


def _becker_dirichlet_bc(disc, shock, embed):
    """Dirichlet far-field BC from the exact Becker wave on every boundary
    face point: flux variables for the inviscid ghost states, entropy
    variables for the BR1 gradient stage, both evaluated at the call's
    time on the device.  ``embed(u1d) -> [Nf, Nfq, K]`` lifts the 1D exact
    conservative state (at the face x-coordinates) to the problem's field
    count."""
    xf = disc.xf[0]
    last = {}

    def exact(t):
        # an RHS asks for both ghost states at one time: bisect once
        if last.get("t") != t:
            last["t"], last["u"] = t, embed(shock.conservative_torch(xf, t))
        return last["u"]

    def dirichlet_flux_vars(t):
        return conservative_to_primitive_beta(exact(t), shock.gamma)

    def dirichlet_entropy_vars(t):
        return v_ufun(exact(t), shock.gamma)

    return make_wall_bc(disc, [Region(
        mask=disc.bmask, kind="dirichlet",
        state=dirichlet_flux_vars, entropy_state=dirichlet_entropy_vars,
    )])


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


def becker_shocktube_1d(n: int = 4, k: int = 128, xl: float = -2.0,
                        xr: float = 2.0, shock: BeckerShock = None, *,
                        dtype: torch.dtype, device):
    """1D CNS viscous shock tube on [xl, xr] with Dirichlet far-field BCs
    from the exact Becker solution (reference
    dg1D_CNS_modalESDG.jl:83-348).

    Returns (disc, q0, bc, shock) with q0 [3, Np, K] the exact wave at
    t = 0.
    """
    shock = BeckerShock() if shock is None else shock
    vx, etov = uniform_line_mesh(k, xl, xr)
    disc = build_discretization(ref_line(n), (vx,), etov, dtype=dtype,
                                device=device)
    q0 = torch.as_tensor(shock.conservative(disc.x[0].cpu().numpy(), 0.0),
                         dtype=dtype, device=device)
    bc = _becker_dirichlet_bc(disc, shock, embed=lambda u: u)
    return disc, q0, bc, shock


def becker_shocktube_2d(n: int = 2, k1d: int = 16, xl: float = -2.0,
                        xr: float = 2.0, shock: BeckerShock = None, *,
                        dtype: torch.dtype, device):
    """2D CNS viscous shock tube on tris: the 1D Becker wave (mu = 0.01)
    extended in y over [xl, xr] x [-0.5, 0.5], k1d x k1d/4 cells, periodic
    in y, Dirichlet inflow/outflow in x (reference
    dg2D_CNS_modalESDG.jl:22-27,161-217).

    Returns (disc, q0, bc, shock) with q0 [4, Np, K].
    """
    shock = BeckerShock(mu=0.01) if shock is None else shock
    vx, vy, etov = uniform_tri_mesh(k1d, max(k1d // 4, 1))
    vx = xl + (xr - xl) * (1 + vx) / 2
    vy = 0.5 * vy
    disc = build_discretization(ref_tri(n), (vx, vy), etov,
                                periodic_axes=(1,), dtype=dtype,
                                device=device)

    u1d = shock.conservative(disc.x[0].cpu().numpy().ravel(), 0.0)
    sh = (disc.np_, disc.num_elements)
    q0 = torch.as_tensor(
        np.stack([u1d[0].reshape(sh), u1d[1].reshape(sh), np.zeros(sh),
                  u1d[2].reshape(sh)]), dtype=dtype, device=device)

    def embed(u):  # [3, ...] -> [4, ...]: zero y-momentum
        z = torch.zeros_like(u[0])
        return torch.stack([u[0], u[1], z, u[2]])

    bc = _becker_dirichlet_bc(disc, shock, embed)
    return disc, q0, bc, shock


def becker_shocktube_3d(n: int = 2, k1d: int = 8, xl: float = -2.0,
                        xr: float = 2.0, shock: BeckerShock = None, *,
                        dtype: torch.dtype, device):
    """3D CNS viscous shock tube: the 1D Becker wave (mu = 0.01) extended
    in y and z on a Gauss-collocated hex mesh of [xl, xr] x [-0.5, 0.5]^2,
    k1d x k1d/4 x k1d/4 cells, periodic in y and z, Dirichlet
    inflow/outflow in x (the TPU package's capability beyond the
    reference, built as ``becker_shocktube_2d``).

    Returns (disc, q0, bc, shock) with q0 [5, Np, K].
    """
    shock = BeckerShock(mu=0.01) if shock is None else shock
    ky = max(k1d // 4, 1)
    vx, vy, vz, etov = uniform_hex_mesh(k1d, ky, ky)
    vx = xl + (xr - xl) * (1 + vx) / 2
    vy, vz = 0.5 * vy, 0.5 * vz
    disc = build_discretization(ref_hex(n), (vx, vy, vz), etov,
                                periodic_axes=(1, 2), dtype=dtype,
                                device=device)

    u1d = shock.conservative(disc.x[0].cpu().numpy().ravel(), 0.0)
    sh = (disc.np_, disc.num_elements)
    z = np.zeros(sh)
    q0 = torch.as_tensor(
        np.stack([u1d[0].reshape(sh), u1d[1].reshape(sh), z, z,
                  u1d[2].reshape(sh)]), dtype=dtype, device=device)

    def embed(u):  # [3, ...] -> [5, ...]: zero y/z-momentum
        zz = torch.zeros_like(u[0])
        return torch.stack([u[0], u[1], zz, zz, u[2]])

    bc = _becker_dirichlet_bc(disc, shock, embed)
    return disc, q0, bc, shock


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
