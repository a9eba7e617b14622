"""The periodic Euler hex configuration: the program's set-up, the start
state and the reference's problem (``configs/euler_hex.json``)."""

from __future__ import annotations

import torch

from h100_bench import reference
from h100_bench.harness import Program


def start_state(cfg, wl, seed, device):
    """The EC random field, [5, Np, K] float32 on ``device``: rho = 2 +
    0.1 U, u = (0, 1, 0), p = 1 + 0.1 U, U drawn on the card from the seed
    in one call."""
    n, k1d, gamma = wl["n"], wl["k1d"], cfg["gamma"]
    shape = ((n + 1) ** 3, k1d ** 3)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((2, *shape), generator=gen, device=device,
                   dtype=torch.float64)
    rho, p = 2.0 + 0.1 * u[0], 1.0 + 0.1 * u[1]
    zero = torch.zeros_like(rho)
    q = torch.stack([rho, zero, rho, zero,
                     p / (gamma - 1.0) + 0.5 * rho])
    return q.to(torch.float32)


def program(cfg, wl, device):
    """The port's main path as a ``harness.Program``.  The discretization as
    ``presets.euler_hex_3d`` builds it, the fused RHS with dissipation
    (at N >= 6 ``force_fused`` keeps it on the kernels, where without it
    the function returns the plain lines path)."""
    from esdg_cns_tpu_torch.core import build_discretization, ref_hex
    from esdg_cns_tpu_torch.mesh.generators import uniform_hex_mesh
    from esdg_cns_tpu_torch.solvers.euler_fused import make_euler_rhs_fused

    n, k1d = wl["n"], wl["k1d"]
    vx, vy, vz, etov = uniform_hex_mesh(k1d)
    disc = build_discretization(
        ref_hex(n), (vx, vy, vz), etov, periodic_axes=(0, 1, 2),
        dtype=torch.float32, device=device, grid_shape=(k1d, k1d, k1d))
    rhs = make_euler_rhs_fused(disc, gamma=cfg["gamma"], dissipation=True,
                               volume_mode=wl["volume_mode"],
                               force_fused=wl["force_fused"])
    return Program(rhs, 5 * disc.np_ * disc.num_elements,
                   {"n": wl["n"], "num_elements": disc.num_elements})


def reference_rhs(cfg, wl, dtype, device):
    """The plain reference's RHS, rhs(q, t) -> dq, in ``dtype``."""
    _, rhs = reference.euler_problem(wl["n"], wl["k1d"], gamma=cfg["gamma"],
                                     dtype=dtype, device=device)
    return rhs


def control_rhs(cfg, wl, device):
    """The comparison's control: the reference one precision below the
    configuration's float32 with TF32 off, float32 with TF32 operand
    rounding in every operator product; rhs(q, t) -> dq."""
    return reference.tf32_control(reference_rhs(cfg, wl, torch.float32,
                                                device))
