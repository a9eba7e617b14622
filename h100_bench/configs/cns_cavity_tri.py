"""The 2D lid-driven cavity on modal triangles: the program's set-up, the
start state and the reference's problem (``configs/cns_cavity_tri.json``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from h100_bench.harness import Program
from h100_bench.reference import tf32_control
from h100_bench.reference.core.ref_tri import ref_tri
from h100_bench.reference.mesh.generators import uniform_tri_mesh
from h100_bench.reference.tri_cavity import tri_cavity_problem


def node_coordinates(n, k1d):
    """(x, y), each [Np, K] float64 NumPy: the nodes of the uniform tri
    mesh of [-1, 1]^2, in the element and node order of the
    discretization (x = V1 VX[EToV]^T)."""
    ref = ref_tri(n)
    vx, vy, etov = uniform_tri_mesh(k1d)
    return [ref.v1 @ np.asarray(v)[etov].T for v in (vx, vy)]


def start_state(cfg, wl, seed, device):
    """The rest state plus a smooth seeded velocity field that vanishes
    on the walls, [4, Np, K] float32 on ``device``:
    u_i = A b(x) sum_m a_im sin(pi (k_im . x) + phi_im), scaled to
    max_i max |u_i| = A, with b = (1 - x^2)(1 - y^2); the coefficients are
    drawn on the card from the seed in one call."""
    ma, gamma = cfg["ma"], cfg["gamma"]
    amp, modes = cfg["velocity_amplitude"], cfg["velocity_modes"]
    f64 = torch.float64
    x = [torch.as_tensor(c, dtype=f64, device=device)
         for c in node_coordinates(wl["n"], wl["k1d"])]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand((2, modes, 4), generator=gen, device=device, dtype=f64)
    wave = 1.0 + (draw[..., :2] >= 0.5).to(f64)          # k in {1, 2}^2
    coef = 2.0 * draw[..., 2] - 1.0                       # a in [-1, 1]
    phase = 2.0 * math.pi * draw[..., 3]                  # phi in [0, 2 pi)
    bump = (1 - x[0] ** 2) * (1 - x[1] ** 2)
    vel = []
    for i in range(2):
        u = torch.zeros_like(bump)
        for m in range(modes):
            arg = sum(wave[i, m, d] * x[d] for d in range(2))
            u = u + coef[i, m] * torch.sin(math.pi * arg + phase[i, m])
        vel.append(bump * u)
    vel = torch.stack(vel)
    vel = vel * (amp / vel.abs().max())
    rho = torch.ones_like(bump)
    p = torch.full_like(bump, 1.0 / (ma * ma * gamma))
    q = torch.cat([rho[None], rho * vel,
                   (p / (gamma - 1.0) + 0.5 * rho * (vel * vel).sum(0))[None]])
    return q.to(torch.float32)


def program(cfg, wl, device):
    """The port's 2D cavity as a ``harness.Program``:
    ``presets.lid_driven_cavity`` with isothermal walls, then the affine
    RHS with the modal front (K3, ``volume_impl='fused'``) and both
    dissipations, its surface and viscous stages left to 'auto' (K4 with
    the projection and the LIFTs folded in)."""
    from esdg_cns_tpu_torch.presets import lid_driven_cavity
    from esdg_cns_tpu_torch.solvers.cns_fused import make_cns_rhs_affine

    disc, _, bc, p = lid_driven_cavity(
        wl["n"], wl["k1d"], bctype="isothermal", ma=cfg["ma"], re=cfg["re"],
        gamma=cfg["gamma"], dtype=torch.float32, device=device)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=cfg["pr"], re=p["re"], gamma=cfg["gamma"],
        bc=bc, inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl=wl["volume_impl"], compute_rhstest=False)
    return Program(rhs, 4 * disc.np_ * disc.num_elements,
                   {"n": wl["n"], "num_elements": disc.num_elements})


def reference_rhs(cfg, wl, dtype, device):
    """The plain reference's RHS, rhs(q, t) -> dq, in ``dtype``."""
    _, rhs = tri_cavity_problem(
        wl["n"], wl["k1d"], ma=cfg["ma"], re=cfg["re"], pr=cfg["pr"],
        gamma=cfg["gamma"], dtype=dtype, device=device)
    return rhs


def control_rhs(cfg, wl, device):
    """The comparison's control: the reference one precision below the
    configuration's float32 with TF32 off, float32 with TF32 operand
    rounding in every operator product; rhs(q, t) -> dq."""
    return tf32_control(reference_rhs(cfg, wl, torch.float32, device))
