"""The curved periodic Euler hex configuration: the program's set-up, the
start state and the reference's problem (``configs/euler_hex_curved.json``).

The mesh of ``euler_hex`` with every node moved by the warp x + d, y + d,
z + d, d = a (x^2 - 1)(y^2 - 1)(z^2 - 1): the metric varies inside each
element, so the port runs K1's curved form (the metric at every
hybridized point, averaged pairwise) and K2's general grid form."""

from __future__ import annotations

import torch

# the EC random field from the seed, drawn as the affine twin draws it
from h100_bench.configs.euler_hex import start_state  # noqa: F401
from h100_bench.harness import Program
from h100_bench.reference import tf32_control
from h100_bench.reference.core.discretization import build_discretization
from h100_bench.reference.core.ref_elem import ref_hex
from h100_bench.reference.mesh.generators import uniform_hex_mesh
from h100_bench.reference.solvers.euler import make_euler_rhs


def warp(cfg):
    """The configuration's curved map (x, y, z) -> (x + d, y + d, z + d);
    d vanishes on the faces of [-1, 1]^3, so periodic faces still match."""
    a = cfg["warp"]

    def curved_map(x, y, z):
        d = a * (x - 1) * (x + 1) * (y - 1) * (y + 1) * (z - 1) * (z + 1)
        return x + d, y + d, z + d

    return curved_map


def port_problem(cfg, wl, dtype, device):
    """(disc, rhs) of the port's main path on the warped mesh, as
    ``presets.euler_hex_3d(curved=True)`` builds the discretization: the
    fused RHS with dissipation, 'auto' resolving to K1 ('joint') on the
    curved metric."""
    from esdg_cns_tpu_torch.core import build_discretization as port_disc
    from esdg_cns_tpu_torch.core import ref_hex as port_ref_hex
    from esdg_cns_tpu_torch.mesh.generators import (
        uniform_hex_mesh as port_mesh)
    from esdg_cns_tpu_torch.solvers.euler_fused import make_euler_rhs_fused

    n, k1d = wl["n"], wl["k1d"]
    vx, vy, vz, etov = port_mesh(k1d)
    disc = port_disc(
        port_ref_hex(n), (vx, vy, vz), etov, periodic_axes=(0, 1, 2),
        curved_map=warp(cfg), dtype=dtype, device=device,
        grid_shape=(k1d, k1d, k1d))
    rhs = make_euler_rhs_fused(disc, gamma=cfg["gamma"], dissipation=True,
                               volume_mode=wl["volume_mode"],
                               force_fused=wl["force_fused"])
    return disc, rhs


def program(cfg, wl, device):
    """The port's main path in float32 as a ``harness.Program``."""
    disc, rhs = port_problem(cfg, wl, torch.float32, device)
    return Program(rhs, 5 * disc.np_ * disc.num_elements,
                   {"n": wl["n"], "num_elements": disc.num_elements})


def reference_problem(cfg, wl, dtype, device):
    """(disc, rhs) of the plain reference on the warped mesh: the
    line-sparse flux differencing with the pairwise-averaged metric and
    Lax-Friedrichs dissipation; rhs(q, t) -> dq."""
    n, k1d = wl["n"], wl["k1d"]
    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    disc = build_discretization(
        ref_hex(n), (vx, vy, vz), etov, periodic_axes=(0, 1, 2),
        curved_map=warp(cfg), dtype=dtype, device=device,
        grid_shape=(k1d, k1d, k1d))
    rhs = make_euler_rhs(disc, gamma=cfg["gamma"], dissipation=True,
                         flux_diff_impl="lines", compute_rhstest=False)
    return disc, lambda q, t: rhs(q, t)[0]


def reference_rhs(cfg, wl, dtype, device):
    """The plain reference's RHS, rhs(q, t) -> dq, in ``dtype``."""
    return reference_problem(cfg, wl, dtype, device)[1]


def control_rhs(cfg, wl, device):
    """The comparison's control: the reference in float32 with TF32
    operand rounding in every operator product; rhs(q, t) -> dq."""
    return tf32_control(reference_rhs(cfg, wl, torch.float32, device))
