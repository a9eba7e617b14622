"""Seeded cavity states and boundary-condition cases for holding the
CNS kernels against their plain versions: the volume fronts K3
(``ops.modal_volume``, lines, tris and hexes) and K1
(``ops.fused_volume``, collocated hexes), the merged surface + viscous
stage K4, the tail after it (``ops.cns_tail``) and the split stages K8
(``ops.cns_surface``) and K7 (``ops.surface_viscous.cns_viscous``), in
every form
``make_cns_rhs_affine`` reaches: the cavities (``cavity_case``) and the
Becker shock tubes on lines and hexes (``becker_case``), with the modal
front (proj) or, on collocated hexes, K1's.

``chip_smoke.py`` and ``tests/test_torch_gpu.py`` build their inputs here,
so the chip check and the GPU tests hold the kernels against the same
cases, in 2D (the tri cavity) and in 3D (the hex cavity).  Every state is
a moving fluid (``moving_state``): the cavity presets start at rest,
where every velocity-dependent term of the kernels multiplies zeros and
a kernel wrong in those terms would still agree.

``warped_tri_case`` and ``fd_inputs`` build the inputs of the
flux-differencing kernels (K3 and K5 on a curved tri mesh, K5 and row 10
on hexes) the same way for both.
"""

from __future__ import annotations

import numpy as np
import torch

from . import GAMMA
from .ops.cns_surface import cns_surface_plain
from .ops.cns_surface_bc import prepare_surface_bc
from .ops.fused_volume import detect_axis_aligned, euler_volume_plain
from .ops.modal_volume import euler_modal_volume_plain
from .ops.surface_viscous import cns_surface_viscous_plain
from .physics import pfun, primitive_to_conservative, v_ufun
from .core import build_discretization, ref_tri
from .mesh.generators import uniform_tri_mesh
from .presets import (becker_shocktube_1d, becker_shocktube_3d,
                      lid_driven_cavity, lid_driven_cavity_3d, square_warp)
from .solvers.euler import entropy_projection, flux_variables
from .solvers._shared import (adiabatic_mask, entropy_vars_from_flux,
                              flux_to_conservative, neighbor_traction)
from .solvers.boundary import Region, make_wall_bc
from .solvers.cns_fused import composed_operators

CAVITY_BCS = ("isothermal", "adiabatic", "slip", "lid_profile", "dirichlet",
              "nobc", "mixed")
"""'lid_profile' drives the lid with an array profile; 'dirichlet' adds a
last region on the x = 1 wall whose ghost states are seeded arrays;
'mixed' has all four kinds with array wall speeds and temperatures, on
walls that share their edge nodes, so the region order decides those."""

VELOCITY = 0.3
"""Standard deviation of ``moving_state``'s seeded velocity (the lid
moves at 1): local Mach numbers stay near the cavity's 0.3."""


def moving_state(q0, rng, *, velocity=VELOCITY, gamma=GAMMA):
    """q0 [dim+2, Np, K] made a moving fluid: its density and pressure
    times (1 + 0.01 n) and every velocity component plus ``velocity`` n,
    with n seeded standard normal from the numpy Generator ``rng``.
    Density and pressure stay positive whatever the draw."""
    nf = q0.shape[0]
    f = lambda a: torch.as_tensor(a, dtype=q0.dtype, device=q0.device)
    n = f(rng.standard_normal((nf, *q0.shape[1:])))
    rho = q0[0] * (1.0 + 0.01 * n[0])
    vel = q0[1:nf - 1] / q0[0] + velocity * n[1:nf - 1]
    p = pfun(q0, gamma) * (1.0 + 0.01 * n[nf - 1])
    return primitive_to_conservative(rho, vel, p, gamma)


def warped_tri_case(n, k1d, dtype, device, seed=3):
    """(disc, q): the cavity's tri mesh of [-1, 1]^2 (2 k1d^2 elements,
    no BC) curved by ``presets.square_warp`` (geo [4, Nh, K]), and the
    cavity's rest state made a moving fluid."""
    vx, vy, etov = uniform_tri_mesh(k1d)
    disc = build_discretization(ref_tri(n), (vx, vy), etov,
                                curved_map=square_warp, dtype=dtype,
                                device=device)
    sh = (disc.np_, disc.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q0 = primitive_to_conservative(f(np.ones(sh)), f(np.zeros((2, *sh))),
                                   f(np.full(sh, 1.0 / (0.3 * 0.3 * GAMMA))))
    return disc, moving_state(q0, np.random.default_rng(seed))


def fd_inputs(disc, q, gamma=GAMMA):
    """(qh [Nf, Nh, K], qlog [2, Nh, K]) of the state q: the entropy-
    projected flux variables and their logs, as the plain RHS hands them
    to the volume flux differencing."""
    return flux_variables(entropy_projection(disc, q, gamma)[1], gamma)


def cavity_case(case, n, k1d, dtype, device, seed=3, dim=2):
    """(disc, q, bc, params): the cavity discretization (tris for dim=2,
    collocated hexes for dim=3), a moving state, the BC of ``case`` (one
    of ``CAVITY_BCS``; None for 'nobc') and the viscous parameters."""
    bctype = case if case in ("adiabatic", "slip") else "isothermal"
    if dim == 2:
        prof = ((lambda x: (1.0 + np.cos(np.pi * x)) / 2.0)
                if case == "lid_profile" else None)
        disc, q0, bc, p = lid_driven_cavity(n=n, k1d=k1d, bctype=bctype,
                                            lid_profile=prof, dtype=dtype,
                                            device=device)
    else:
        disc, q0, bc, p = lid_driven_cavity_3d(n=n, k1d=k1d, bctype=bctype,
                                               dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    q = moving_state(q0, rng)
    sh = (disc.nfq, disc.num_elements)
    nf = dim + 2
    xf = disc.xf
    on = lambda m: disc.bmask & m
    wall = lambda axis, side: on((xf[axis] - side).abs() < 1e-10)

    def ghost_states():
        qbc = np.concatenate([1 + 0.1 * rng.random((1, *sh)),
                              rng.standard_normal((dim, *sh)),
                              1 + 0.1 * rng.random((1, *sh))])
        vbc = rng.standard_normal((nf, *sh))
        vbc[-1] = -(0.5 + rng.random(sh))
        return f(qbc), f(vbc)

    if case == "nobc":
        bc = None
    elif case == "lid_profile" and dim == 3:
        lid = bc.regions[0]
        x, y = (c.cpu().numpy() for c in xf[:2])
        prof = (1.0 + np.cos(np.pi * x)) * (1.0 + np.cos(np.pi * y)) / 4.0
        bc = make_wall_bc(disc, [Region(
            mask=lid.mask, kind=lid.kind, u_wall=(f(prof), 0.0, 0.0),
            theta=lid.theta)] + list(bc.regions[1:]))
    elif case == "mixed":
        # the lid (the top wall) and the bottom wall, then the x = -1 (and
        # in 3D the y = -1) walls slip and the x = 1 (and y = 1) walls
        # Dirichlet: the later regions take the shared edge nodes
        top, bottom = wall(dim - 1, 1.0), wall(dim - 1, -1.0)
        low, high = wall(0, -1.0), wall(0, 1.0)
        if dim == 3:
            low, high = low | wall(1, -1.0), high | wall(1, 1.0)
        qbc, vbc = ghost_states()
        lid_u = [f(1 + 0.1 * rng.standard_normal(sh))] + [
            f(0.1 * rng.standard_normal(sh)) for _ in range(dim - 1)]
        bc = make_wall_bc(disc, [
            Region(mask=top, kind="isothermal", u_wall=tuple(lid_u),
                   theta=f(20 + rng.random(sh))),
            Region(mask=bottom, kind="adiabatic",
                   u_wall=(f(0.2 * rng.standard_normal(sh)),)
                   + (0.0,) * (dim - 1)),
            Region(mask=low, kind="slip"),
            Region(mask=high, kind="dirichlet",
                   state=lambda t: qbc, entropy_state=lambda t: vbc)])
    elif case == "dirichlet":
        qbc, vbc = ghost_states()
        bc = make_wall_bc(disc, list(bc.regions) + [Region(
            mask=wall(0, 1.0), kind="dirichlet", state=lambda t: qbc,
            entropy_state=lambda t: vbc)])
    return disc, q, bc, p


def becker_case(dim, n, k, dtype, device, seed=3, wall=False):
    """(disc, q, bc, params): the Becker shock tube on lines (dim=1, k
    elements, mu=0.1) or hexes (dim=3, k1d=k, mu=0.01) with its
    exact-wave Dirichlet ghosts, the wave made a moving fluid in every
    direction (``moving_state``, velocity 0.1 about its own).  wall=True
    replaces the ghosts by walls: the x = xl end isothermal with seeded
    array wall speeds and temperatures, the x = xr end adiabatic."""
    if dim == 1:
        disc, q0, bc, shock = becker_shocktube_1d(n=n, k=k, dtype=dtype,
                                                  device=device)
    else:
        disc, q0, bc, shock = becker_shocktube_3d(n=n, k1d=k, dtype=dtype,
                                                  device=device)
    rng = np.random.default_rng(seed)
    q = moving_state(q0, rng, velocity=0.1)
    if wall:
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        sh = (disc.nfq, disc.num_elements)
        xf = disc.xf[0]
        left, right = disc.bmask & (xf < 0), disc.bmask & (xf > 0)
        bc = make_wall_bc(disc, [
            Region(mask=left, kind="isothermal",
                   u_wall=tuple(f(0.1 * rng.standard_normal(sh))
                                for _ in range(dim)),
                   theta=f(2 + rng.random(sh))),
            Region(mask=right, kind="adiabatic", u_wall=(0.0,) * dim)])
    return disc, q, bc, {"mu": shock.mu, "pr": shock.pr,
                         "re": 1.0 / shock.mu}


def _front_end(disc, q, proj):
    """(ph_qf, traces, vu_q) of the plain volume front: K3's (the modal
    front, proj) on any mesh, else K1's (and v(U) at the collocated
    nodes) on hexes."""
    if proj:
        return euler_modal_volume_plain(q, disc.geo, disc.q_skew, disc.vq,
                                        disc.vhp, disc.ph, GAMMA, nq=disc.nq)
    ph_qf, tr = euler_volume_plain(q, disc.geo, disc.vhp[disc.nq:],
                                   disc.lift, GAMMA, line_ops=disc.line_ops,
                                   diag=detect_axis_aligned(disc))
    return ph_qf, tr, v_ufun(q, GAMMA)


def _pool(disc, bc, t):
    pool, recipe, evals = prepare_surface_bc(bc, adiabatic_mask(disc, bc),
                                             disc.dim)
    if evals:
        pool = torch.cat([pool] + [e(t) for e in evals])
    return pool, recipe


def _proj(disc, proj):
    """The front the cases take by default: K1's on hexes (the cavity),
    the modal one elsewhere."""
    return disc.dim != 3 if proj is None else proj


def k4_inputs(disc, q, bc, p, t=0.0, proj=None):
    """K4's (positional arguments, fold_tail's extra arguments, keywords),
    from the plain volume front of q and one exchange; proj None takes
    ``_proj``'s default."""
    nq, nf = disc.nq, disc.dim + 2
    proj = _proj(disc, proj)
    ph_qf, tr, vu_q = _front_end(disc, q, proj)
    pool, recipe = _pool(disc, bc, t)
    front, vqlift, drpq = composed_operators(disc, proj=proj)
    args = (vu_q, tr[:nf], tr[nf:nf + 2], disc.gather_traces(tr),
            torch.stack(disc.nxj), disc.sj, disc.inv_sj, pool, disc.geo,
            disc.inv_jac[:1], disc.wjq, front, vqlift,
            disc.vhp[nq:].contiguous(), drpq)
    kw = dict(gamma=GAMMA, mu=p["mu"], lam=None, pr=p["pr"], re=p["re"],
              nq=nq, dissipation=True, with_penalty=True, recipe=recipe,
              proj=proj)
    return args, (ph_qf, disc.lift), kw


def tail_inputs(disc, q, bc, p, t=0.0):
    """The tail's inputs after the plain K4's fold_tail form on
    ``k4_inputs``, (dq_part, t_f, lift, inv_j), contiguous as the kernel
    takes them, and the plain neighbour traction t_pn (the exchange and
    ``WallBC.stress_normal``)."""
    args, tail, kw = k4_inputs(disc, q, bc, p, t)
    dq_part, t_f = (a.contiguous() for a in cns_surface_viscous_plain(
        *args, *tail, fold_tail=True, **kw)[:2])
    t_pn = neighbor_traction(disc, bc, t_f, disc.gather_traces(t_f), t)
    return (dq_part, t_f, disc.lift, disc.inv_jac[:1]), t_pn


def k8_inputs(disc, q, bc, p, t=0.0, proj=None):
    """K8's (positional arguments, keywords), from the plain volume front
    of q and one exchange; uf and vuf rebuilt from the traces."""
    nf = disc.dim + 2
    _, tr, _ = _front_end(disc, q, _proj(disc, proj))
    qm, qm_log = tr[:nf], tr[nf:nf + 2]
    pool, recipe = _pool(disc, bc, t)
    args = (qm, flux_to_conservative(qm, GAMMA), qm_log,
            entropy_vars_from_flux(qm, qm_log, GAMMA),
            disc.gather_traces(tr), torch.stack(disc.nxj), disc.sj,
            disc.inv_sj, pool)
    kw = dict(gamma=GAMMA, re=p["re"], dim=disc.dim, dissipation=True,
              with_penalty=True, recipe=recipe)
    return args, kw


def k7_inputs(disc, q, bc, p, t=0.0, proj=None):
    """K7's (positional arguments, keywords): v(U) of q and the jump dv
    of the plain K8 on ``k8_inputs``."""
    proj = _proj(disc, proj)
    _, _, vu_q = _front_end(disc, q, proj)
    args8, kw8 = k8_inputs(disc, q, bc, p, t, proj)
    _, dv, _ = cns_surface_plain(*args8, **kw8)
    front, vqlift, drpq = composed_operators(disc, proj=proj)
    args = (vu_q, dv, disc.geo, torch.stack(disc.nxj), disc.inv_jac[:1],
            disc.wjq, front, vqlift, disc.vhp[disc.nq:].contiguous(), drpq)
    kw = dict(gamma=GAMMA, mu=p["mu"], lam=None, pr=p["pr"], nq=disc.nq,
              proj=proj, contract=True)
    return args, kw
