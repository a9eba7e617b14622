"""Building blocks of the Euler RHS constructors.

Port of the Euler half of ``esdg_cns_tpu/solvers/_shared.py``: the
flux-differencing dispatch (``'lines'`` only; the dense path for
triangles comes with the CNS slice) and the merged neighbor exchange +
EC surface flux + LF dissipation.
"""

from __future__ import annotations

import torch

from ..physics import euler as phys


def resolve_flux_diff(disc, flux_diff_impl: str):
    """Select the volume flux-differencing implementation.

    Returns fd(qh, qlog, geo, gamma) -> 2*QF [Nf, Nh, K].
    """
    from ..ops.tensor_product_fd import flux_differencing_lines

    if flux_diff_impl != "lines":
        raise ValueError(f"unknown flux_diff_impl: {flux_diff_impl!r} "
                         "(the port has 'lines' only)")
    if disc.line_ops is None:
        raise ValueError("'lines' requires a collocated quad/hex mesh")

    def fd(qh, qlog, geo, gamma):
        return flux_differencing_lines(
            qh, qlog, geo, gamma,
            elem_type=disc.elem_type, line_ops=disc.line_ops, nq=disc.nq,
        )

    return fd


def flux_to_conservative(q, gamma):
    """(rho, u_1..d, beta) flux-variable rows -> conservative rows
    (rho, m_1..d, E) with p = rho / (2 beta), dimension-generic."""
    rho, beta = q[0], q[q.shape[0] - 1]
    vel = [q[1 + d] for d in range(q.shape[0] - 2)]
    e = rho / (2.0 * beta * (gamma - 1.0)) + 0.5 * rho * sum(
        v * v for v in vel
    )
    return torch.cat(
        [rho[None]] + [(rho * v)[None] for v in vel] + [e[None]], dim=0
    )


def inviscid_surface(disc, gather, qm, uf, qm_log, *, gamma, dissipation):
    """Merged neighbor exchange + EC surface flux + LF dissipation.

    One batched exchange carries the flux-variable traces qm and their
    logs.  The conservative traces and the LF wavespeed never cross the
    exchange: both sides recompute them pointwise from the exchanged
    flux variables (the wavespeed's normal momentum uses the LOCAL
    normal).  Returns flux [Nf, Nfq, K] ready for LIFT.
    """
    dim = disc.dim
    nf = qm.shape[0]
    nbr = gather(torch.cat([qm, qm_log], dim=0))
    qp = nbr[:nf]
    qp_log = nbr[nf:nf + 2]

    fs = phys.ec_flux(qm, qp, qm_log, qp_log, gamma=gamma)
    flux = sum(f * n[None] for f, n in zip(fs, disc.nxj))
    if dissipation:
        up = flux_to_conservative(qp, gamma)

        def lam(u):
            rhoun = sum(u[1 + d] * disc.nxj[d] for d in range(dim))
            return phys.wavespeed(u[0], rhoun * disc.inv_sj, u[-1], gamma)

        lfc = 0.25 * torch.maximum(lam(uf), lam(up)) * disc.sj
        flux = flux - lfc[None] * (up - uf)
    return flux
