"""Compressible Navier-Stokes semi-discretization (ES-DG + BR1).

Port of ``esdg_cns_tpu/solvers/cns.py``: the plain PyTorch twin of the
fused cavity path.  One CNS RHS = inviscid ES-DG RHS + BR1 viscous RHS
in entropy variables (reference rhs_viscous!,
dg2D_CNS_cavity_optimized.jl:749-849):

  1. entropy projection to modal coefficients: VU = Pq v(Vq Q),
  2. entropy-variable traces + ghost BCs -> BR1 gradient,
  3. sigma = K(v) grad(v) at quadrature points (physics.viscous),
  4. project sigma, contracted traction + stress ghost BCs,
  5. optional interface penalty tau = -1/(Re v4) with the wall energy row,
  6. BR1 divergence.

The integrated ``make_cns_rhs`` merges the entropy-variable traces into
the inviscid exchange: two exchanges per RHS (the reference has three).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..physics import euler as phys
from ..physics.viscous import viscous_flux_nd
from .dg_ops import _apply, dg_div_contracted, dg_grad


def make_viscous_rhs(disc, *, mu: float, lam: Optional[float] = None,
                     pr: float = 0.71, gamma: float = phys.GAMMA, bc=None,
                     dissipation: bool = False, re: Optional[float] = None):
    """Build the BR1 viscous RHS; rhs(q, t) -> (dq, aux with
    'rhstest_visc' = the (nonnegative) viscous entropy production)."""
    from ._shared import (adiabatic_mask, neighbor_traction,
                          viscous_penalty_rows)

    dim = disc.dim
    re = (1.0 / mu) if re is None else re
    adiab = adiabatic_mask(disc, bc)
    gather = disc.gather_traces

    def rhs(q, t=0.0):
        vu_q = phys.v_ufun(_apply(disc.vq, q), gamma)
        vu = _apply(disc.pq, vu_q)

        vuf = _apply(disc.vf, vu)
        vup = gather(vuf)
        if bc is not None:
            vup = bc.entropy_vars(disc, vuf, vup, t)

        grad = dg_grad(disc, vu, vuf, vup)          # dim x [Nf, Np, K]
        grad_q = [_apply(disc.vq, g) for g in grad]
        vuq = _apply(disc.vq, vu)

        sigma = viscous_flux_nd(vuq, grad_q, mu, lam, pr, gamma)
        rhstest_visc = sum(
            torch.sum(disc.wjq[None] * g * s) for g, s in zip(grad_q, sigma)
        )

        # contracted stress exchange: only the normal traction crosses
        sigma_m = [_apply(disc.pq, s) for s in sigma]
        s_f = [_apply(disc.vf, s) for s in sigma_m]
        t_f = sum(s_f[x] * disc.nxj[x][None] for x in range(dim))
        t_ex = gather(t_f)
        t_pn = neighbor_traction(disc, bc, t_f, t_ex, t)

        dq = dg_div_contracted(disc, sigma_m, 0.5 * (t_pn - t_f))
        if dissipation:
            pen = viscous_penalty_rows(disc, bc, adiab, vuf, vup,
                                       vup - vuf, re)
            dq = dq + _apply(disc.lift, pen)
        return dq, {"rhstest_visc": rhstest_visc}

    return rhs


def make_cns_rhs(disc, *, mu: float, lam: Optional[float] = None,
                 pr: float = 0.71, gamma: float = phys.GAMMA, bc=None,
                 inviscid_dissipation: bool = False,
                 viscous_dissipation: bool = False,
                 re: Optional[float] = None, flux_diff_impl: str = "auto",
                 compute_rhstest: bool = True,
                 rhstest_mode: str = "native"):
    """Full CNS RHS = inviscid ES-DG + BR1 viscous parts, integrated.

    One entropy evaluation v(U) feeds both the inviscid entropy
    projection and the viscous modal coefficients; the inviscid traces
    and the viscous entropy-variable traces ride ONE merged neighbour
    exchange; the contracted traction rides a second.  flux_diff_impl
    selects the volume flux differencing ('auto', 'xla', 'pallas',
    'lines', 'lines_pallas'; ``_shared.resolve_flux_diff``).

    Returns rhs(q, t) -> (dq, aux{'rhstest_visc'[, 'rhstest',
    'rhstest_visc_total']}).
    """
    from ..utils.compensated import weighted_entropy_residual
    from ._shared import (adiabatic_mask, inviscid_surface,
                          neighbor_traction, resolve_flux_diff,
                          viscous_penalty_rows)
    from .euler import entropy_projection, flux_variables

    dim = disc.dim
    nq = disc.nq
    re = (1.0 / mu) if re is None else re
    fd = resolve_flux_diff(disc, flux_diff_impl)
    adiab = adiabatic_mask(disc, bc)
    gather = disc.gather_traces

    def rhs(q, t=0.0):
        # ---- shared entropy front end ----
        vu_q, uh = entropy_projection(disc, q, gamma)   # v(U) at quad, Uh
        vu = _apply(disc.pq, vu_q)                      # modal coefficients
        vuf = _apply(disc.vf, vu)                       # viscous traces

        qh, qlog = flux_variables(uh, gamma)

        # ---- ONE merged neighbour exchange: inviscid + entropy traces ----
        flux, vup = inviscid_surface(
            disc, gather, qh[:, nq:, :], uh[:, nq:, :], qlog[:, nq:, :],
            gamma=gamma, dissipation=inviscid_dissipation,
            bc_inviscid=bc.inviscid if bc is not None else None,
            entropy_extras=True, t=t,
        )
        rhs_surf = _apply(disc.lift, flux)

        # ---- inviscid volume flux differencing ----
        qf = fd(qh, qlog, disc.geo, gamma)
        dq_i = -(_apply(disc.ph, qf) + rhs_surf) * disc.inv_jac[None]

        # ---- viscous part (BR1) ----
        if bc is not None:
            vup = bc.entropy_vars(disc, vuf, vup, t)

        grad = dg_grad(disc, vu, vuf, vup)
        grad_q = [_apply(disc.vq, g) for g in grad]
        vuq = _apply(disc.vq, vu)

        sigma = viscous_flux_nd(vuq, grad_q, mu, lam, pr, gamma)
        rhstest_visc = sum(
            weighted_entropy_residual(disc.wjq, g, s, rhstest_mode)
            for g, s in zip(grad_q, sigma)
        )

        # ---- ONE batched CONTRACTED stress exchange (Nf rows) ----
        sigma_m = [_apply(disc.pq, s) for s in sigma]
        s_f = [_apply(disc.vf, s) for s in sigma_m]
        t_f = sum(s_f[x] * disc.nxj[x][None] for x in range(dim))
        t_ex = gather(t_f)
        t_pn = neighbor_traction(disc, bc, t_f, t_ex, t)

        dq_v = dg_div_contracted(disc, sigma_m, 0.5 * (t_pn - t_f))
        if viscous_dissipation:
            pen = viscous_penalty_rows(disc, bc, adiab, vuf, vup,
                                       vup - vuf, re)
            dq_v = dq_v + _apply(disc.lift, pen)

        dq = dq_i + dq_v
        aux = {"rhstest_visc": rhstest_visc}
        if compute_rhstest:
            # total entropy balance (rhsRK!, cavity_optimized:960-971)
            rt = weighted_entropy_residual(
                disc.wjq, vuq, _apply(disc.vq, dq), rhstest_mode)
            rtv = weighted_entropy_residual(
                disc.wjq, vuq, _apply(disc.vq, dq_v), rhstest_mode)
            aux["rhstest"] = rt
            aux["rhstest_visc_total"] = rtv + rhstest_visc
        return dq, aux

    return rhs
