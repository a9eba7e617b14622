"""The benchmark's plain reference: the two configurations in plain
PyTorch, any dtype, no kernels.

A frozen copy of the port's plain twin, taken from ``esdg_cns_tpu_torch``
when the benchmark was written, so that no later change of the program
moves the yardstick: ``basis/`` (``jacobi``, ``hex``, ``quad``),
``mesh/``, ``core/``, ``physics/`` (``euler``, ``viscous``),
``ops/tensor_product_fd``, ``solvers/`` (``euler``, ``cns``, ``_shared``,
``dg_ops``, ``boundary``) and ``utils/compensated``.  It imports neither
``jax``, nor ``esdg_cns_tpu``, nor anything of ``esdg_cns_tpu_torch``
(``h100_bench/tests/test_h100_reference.py`` holds it to that and to the
twin's numbers).

Departures from the copied sources, each made here and nowhere else:
  * ``core/ref_elem``: the hex element only (``ref_line``, ``ref_tri``,
    ``ref_quad`` and ``make_ref_elem`` are gone, with ``basis/tri``);
  * ``ops/tensor_product_fd``: ``flux_differencing_lines_fused`` (a CUDA
    kernel) is gone;
  * ``solvers/_shared.resolve_flux_diff``: the line-sparse sum alone
    (the 'xla', 'pallas' and 'lines_pallas' routes are gone);
  * ``solvers/dg_ops._apply``: ``matmul_rounding("tf32")`` rounds the
    operands of every operator product to TF32, the benchmark's
    lower-precision control;
  * this module: the problem set-ups of ``presets.euler_hex_3d`` and
    ``presets.lid_driven_cavity_3d`` without their start states (the
    benchmark makes those), and LSRK45's step.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.discretization import build_discretization
from .core.ref_elem import ref_hex
from .mesh.generators import uniform_hex_mesh
from .solvers.boundary import make_wall_bc, region_from_indicator
from .solvers.cns import make_cns_rhs
from .solvers.dg_ops import matmul_rounding, to_tf32
from .solvers.euler import make_euler_rhs

__all__ = ["LSRK45_A", "LSRK45_B", "LSRK45_C", "cavity_problem",
           "euler_problem", "lsrk45_step", "matmul_rounding", "tf32_control",
           "to_tf32"]

# Carpenter & Kennedy (1994) RK45(5,4) low-storage coefficients
LSRK45_A = np.array([
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
])
LSRK45_B = np.array([
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
])
LSRK45_C = np.array([
    0.0,
    1432997174477.0 / 9575080441755.0,
    2526269341429.0 / 6820363962896.0,
    2006345519317.0 / 3224310063776.0,
    2802321613138.0 / 2924317926251.0,
])


def euler_problem(n, k1d, *, gamma, dtype, device):
    """The periodic Euler hex problem on [-1, 1]^3: (disc, rhs), the RHS
    with Lax-Friedrichs dissipation and the line-sparse flux
    differencing; rhs(q, t) -> dq."""
    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    disc = build_discretization(
        ref_hex(n), (vx, vy, vz), etov, periodic_axes=(0, 1, 2),
        dtype=dtype, device=device, grid_shape=(k1d, k1d, k1d))
    rhs = make_euler_rhs(disc, gamma=gamma, dissipation=True,
                         flux_diff_impl="lines", compute_rhstest=False)
    return disc, lambda q, t: rhs(q, t)[0]


def cavity_problem(n, k1d, *, ma, re, pr, gamma, dtype, device):
    """The 3D lid-driven cavity on [-1, 1]^3: isothermal no-slip walls,
    the lid z = 1 moving at u = (1, 0, 0); (disc, rhs) with both
    dissipations on; rhs(q, t) -> dq."""
    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    disc = build_discretization(ref_hex(n), (vx, vy, vz), etov, dtype=dtype,
                                device=device)
    tol = 1e-10
    theta = 1.0 / (ma * ma * gamma * (gamma - 1.0))
    lid = region_from_indicator(
        disc, lambda x, y, z: np.abs(z - 1) < tol, "isothermal",
        u_wall=(1.0, 0.0, 0.0), theta=theta)
    walls = region_from_indicator(
        disc, lambda x, y, z: np.abs(z - 1) >= tol, "isothermal",
        u_wall=(0.0, 0.0, 0.0), theta=theta)
    bc = make_wall_bc(disc, [lid, walls])
    rhs = make_cns_rhs(disc, mu=1.0 / re, pr=pr, gamma=gamma, bc=bc,
                       inviscid_dissipation=True, viscous_dissipation=True,
                       re=re, flux_diff_impl="lines", compute_rhstest=False)
    return disc, lambda q, t: rhs(q, t)[0]


def lsrk45_step(rhs, q, dt, t):
    """One LSRK45 step of dq/dt = rhs(q, t) from (q, t), in q's dtype;
    dt is taken as given (the caller rounds it as the program does)."""
    res = torch.zeros_like(q)
    for s in range(5):
        dq = rhs(q, t + float(LSRK45_C[s]) * dt)
        res = float(LSRK45_A[s]) * res + dt * dq
        q = q + float(LSRK45_B[s]) * res
    return q


def tf32_control(rhs):
    """``rhs`` with the operands of every operator product rounded to
    TF32: the control one precision below float32 with TF32 off."""
    def control(q, t):
        with matmul_rounding("tf32"):
            return rhs(q, t)
    return control
