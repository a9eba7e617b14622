"""Seeded cavity states and boundary-condition cases for holding the
cavity kernels, K3 (``ops.modal_volume``) and K4 (``ops.surface_viscous``),
against their plain versions.

``chip_smoke.py`` and ``tests/test_torch_gpu.py`` build their inputs here,
so the chip check and the GPU tests hold the kernels against the same
cases.  Every state is a moving fluid (``moving_state``): the cavity
preset starts at rest, where every velocity-dependent term of K3 and K4
multiplies zeros and a kernel wrong in those terms would still agree.
"""

from __future__ import annotations

import numpy as np
import torch

from . import GAMMA
from .ops.cns_surface_bc import prepare_surface_bc
from .ops.modal_volume import euler_modal_volume_plain
from .physics import pfun, primitive_to_conservative
from .presets import lid_driven_cavity
from .solvers._shared import adiabatic_mask
from .solvers.boundary import Region, make_wall_bc
from .solvers.cns_fused import composed_operators

CAVITY_BCS = ("isothermal", "adiabatic", "slip", "lid_profile", "dirichlet",
              "nobc", "mixed")
"""'lid_profile' drives the lid with an array profile; 'dirichlet' adds a
last region on the x = 1 wall whose ghost states are seeded arrays;
'mixed' has all four kinds with array wall speeds and temperatures."""

VELOCITY = 0.3
"""Standard deviation of ``moving_state``'s seeded velocity (the lid
moves at 1): local Mach numbers stay near the cavity's 0.3."""


def moving_state(q0, rng, *, velocity=VELOCITY, gamma=GAMMA):
    """q0 [4, Np, K] made a moving fluid: its density and pressure times
    (1 + 0.01 n) and its velocity plus ``velocity`` n, with n seeded
    standard normal from the numpy Generator ``rng``.  Density and
    pressure stay positive whatever the draw."""
    f = lambda a: torch.as_tensor(a, dtype=q0.dtype, device=q0.device)
    n = f(rng.standard_normal((4, *q0.shape[1:])))
    rho = q0[0] * (1.0 + 0.01 * n[0])
    vel = q0[1:3] / q0[0] + velocity * n[1:3]
    p = pfun(q0, gamma) * (1.0 + 0.01 * n[3])
    return primitive_to_conservative(rho, vel, p, gamma)


def cavity_case(case, n, k1d, dtype, device, seed=3):
    """(disc, q, bc, params): the cavity discretization, a moving state,
    the BC of ``case`` (one of ``CAVITY_BCS``; None for 'nobc') and the
    viscous parameters."""
    bctype = case if case in ("adiabatic", "slip") else "isothermal"
    prof = ((lambda x: (1.0 + np.cos(np.pi * x)) / 2.0)
            if case == "lid_profile" else None)
    disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d, bctype=bctype,
                                        lid_profile=prof, dtype=dtype,
                                        device=device)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q = moving_state(q0, rng)
    sh = (disc.nfq, disc.num_elements)

    def ghost_states():
        qbc = f(np.stack([1 + 0.1 * rng.random(sh), rng.standard_normal(sh),
                          rng.standard_normal(sh), 1 + 0.1 * rng.random(sh)]))
        vbc = rng.standard_normal((4, *sh))
        vbc[-1] = -(0.5 + rng.random(sh))
        return qbc, f(vbc)

    if case == "nobc":
        bc = None
    elif case == "mixed":
        # the side walls share their corner nodes with lid and bottom, so
        # the region order decides them
        xf, yf = disc.xf
        on = lambda m: disc.bmask & m
        qbc, vbc = ghost_states()
        bc = make_wall_bc(disc, [
            Region(mask=on((yf - 1).abs() < 1e-10), kind="isothermal",
                   u_wall=(f(1 + 0.1 * rng.standard_normal(sh)),
                           f(0.1 * rng.standard_normal(sh))),
                   theta=f(20 + rng.random(sh))),
            Region(mask=on((yf + 1).abs() < 1e-10), kind="adiabatic",
                   u_wall=(f(0.2 * rng.standard_normal(sh)), 0.0)),
            Region(mask=on((xf + 1).abs() < 1e-10), kind="slip"),
            Region(mask=on((xf - 1).abs() < 1e-10), kind="dirichlet",
                   state=lambda t: qbc, entropy_state=lambda t: vbc)])
    elif case == "dirichlet":
        right = disc.bmask & ((disc.xf[0] - 1.0).abs() < 1e-10)
        qbc, vbc = ghost_states()
        bc = make_wall_bc(disc, list(bc.regions) + [Region(
            mask=right, kind="dirichlet", state=lambda t: qbc,
            entropy_state=lambda t: vbc)])
    return disc, q, bc, p


def k4_inputs(disc, q, bc, p, t=0.0):
    """K4's (positional arguments, fold_tail's extra arguments, keywords),
    from the plain K3 outputs of q and one exchange."""
    nq = disc.nq
    ph_qf, tr, vu_q = euler_modal_volume_plain(
        q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA, nq=nq)
    pool, recipe, evals = prepare_surface_bc(bc, adiabatic_mask(disc, bc), 2)
    if evals:
        pool = torch.cat([pool] + [e(t) for e in evals])
    front, vqlift, drpq = composed_operators(disc)
    args = (vu_q, tr[:4], tr[4:6], disc.gather_traces(tr),
            torch.stack(disc.nxj), disc.sj, disc.inv_sj, pool, disc.geo,
            disc.inv_jac[:1], disc.wjq, front, vqlift,
            disc.vhp[nq:].contiguous(), drpq)
    kw = dict(gamma=GAMMA, mu=p["mu"], lam=None, pr=p["pr"], re=p["re"],
              nq=nq, dissipation=True, with_penalty=True, recipe=recipe)
    return args, (ph_qf, disc.lift), kw
