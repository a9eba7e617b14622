"""The compressible Navier-Stokes RHS on the dense flux differencing:
``solvers.cns.make_cns_rhs`` (a frozen copy of the port's plain twin)
line for line, with two departures made here:
  * the volume term is ``ops.flux_differencing.flux_differencing_dense``,
    the all-pairs sum of the modal elements (the triangle), on blocks of
    elements; ``make_cns_rhs`` keeps the line-sparse sum of the hex alone;
  * no entropy diagnostics: rhs(q, t) -> dq.
"""

from __future__ import annotations

from typing import Optional

from ..ops.flux_differencing import flux_differencing_dense
from ..physics import euler as phys
from ..physics.viscous import viscous_flux_nd
from ._shared import (adiabatic_mask, inviscid_surface, neighbor_traction,
                      viscous_penalty_rows)
from .dg_ops import _apply, dg_div_contracted, dg_grad
from .euler import entropy_projection, flux_variables


def make_cns_rhs_dense(disc, *, mu: float, lam: Optional[float] = None,
                       pr: float = 0.71, gamma: float = phys.GAMMA, bc=None,
                       inviscid_dissipation: bool = False,
                       viscous_dissipation: bool = False,
                       re: Optional[float] = None):
    """Inviscid ES-DG + BR1 viscous RHS with the dense volume sum on
    blocks of elements: one entropy evaluation for both parts, the traces
    of both on one exchange, the contracted traction on a second;
    rhs(q, t) -> dq."""
    dim = disc.dim
    nq = disc.nq
    re = (1.0 / mu) if re is None else re
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

        # ---- inviscid volume flux differencing, all pairs ----
        qf = flux_differencing_dense(qh, qlog, disc.q_skew, disc.geo, gamma)
        dq_i = -(_apply(disc.ph, qf) + rhs_surf) * disc.inv_jac[None]

        # ---- viscous part (BR1) ----
        if bc is not None:
            vup = bc.entropy_vars(disc, vuf, vup, t)

        grad = dg_grad(disc, vu, vuf, vup)
        grad_q = [_apply(disc.vq, g) for g in grad]
        vuq = _apply(disc.vq, vu)

        sigma = viscous_flux_nd(vuq, grad_q, mu, lam, pr, gamma)

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
        return dq_i + dq_v

    return rhs
