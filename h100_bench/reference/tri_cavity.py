"""The 2D lid-driven cavity on modal triangles, the reference's problem
set-up beside ``cavity_problem`` (``h100_bench.reference``): the
set-up of ``presets.lid_driven_cavity`` without its start state (the
benchmark makes that), on the reference's own ``ref_tri`` and the dense
CNS RHS (``solvers.cns_dense``).  Plain PyTorch in any dtype.
"""

from __future__ import annotations

import numpy as np

from .core.discretization import build_discretization
from .core.ref_tri import ref_tri
from .mesh.generators import uniform_tri_mesh
from .solvers.boundary import make_wall_bc, region_from_indicator
from .solvers.cns_dense import make_cns_rhs_dense


def tri_cavity_problem(n, k1d, *, ma, re, pr, gamma, dtype, device):
    """The cavity [-1, 1]^2 on 2 k1d^2 triangles of degree n: isothermal
    no-slip walls, the lid y = 1 moving at u = (1, 0); (disc, rhs) with
    both dissipations on and mu = 1/re; rhs(q, t) -> dq."""
    vx, vy, etov = uniform_tri_mesh(k1d)
    disc = build_discretization(ref_tri(n), (vx, vy), etov, dtype=dtype,
                                device=device)
    tol = 1e-10
    theta = 1.0 / (ma * ma * gamma * (gamma - 1.0))
    lid = region_from_indicator(
        disc, lambda x, y: np.abs(y - 1) < tol, "isothermal",
        u_wall=(1.0, 0.0), theta=theta)
    walls = region_from_indicator(
        disc, lambda x, y: np.abs(y - 1) >= tol, "isothermal",
        u_wall=(0.0, 0.0), theta=theta)
    bc = make_wall_bc(disc, [lid, walls])
    rhs = make_cns_rhs_dense(disc, mu=1.0 / re, pr=pr, gamma=gamma, bc=bc,
                             inviscid_dissipation=True,
                             viscous_dissipation=True, re=re)
    return disc, rhs
