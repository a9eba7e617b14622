"""Building blocks shared by the Euler / CNS RHS constructors.

Port of ``esdg_cns_tpu/solvers/_shared.py``: the flux-differencing
dispatch, the merged neighbour exchange + EC surface flux + LF
dissipation, the adiabatic-region mask, the comm-avoiding trace rebuilds,
the contracted neighbour traction and the viscous interface penalty rows.
They live here once, so the paths the tests hold equal cannot drift
apart.
"""

from __future__ import annotations

import torch

from ..physics import euler as phys


def resolve_flux_diff(disc, flux_diff_impl: str):
    """The line-sparse flux differencing ('lines', or 'auto' on the
    collocated hex), the only form the reference keeps.

    Returns fd(qh, qlog, geo, gamma) -> 2*QF [Nf, Nh, K].
    """
    if flux_diff_impl not in ("auto", "lines") or disc.line_ops is None:
        raise ValueError("the reference keeps only the line-sparse flux "
                         "differencing of the collocated hex")
    from ..ops.tensor_product_fd import flux_differencing_lines

    def fd(qh, qlog, geo, gamma):
        return flux_differencing_lines(qh, qlog, geo, gamma,
                                       elem_type=disc.elem_type,
                                       line_ops=disc.line_ops, nq=disc.nq)

    return fd


def adiabatic_mask(disc, bc):
    """bool [Nfq, K] marking adiabatic-wall regions (None without bc)."""
    if bc is None:
        return None
    am = torch.zeros_like(bc.bmask)
    for r in bc.regions:
        if r.kind == "adiabatic":
            am = am | r.mask
    return am


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


_LOG2 = 0.6931471805599453


def entropy_vars_from_flux(qp, qp_log, gamma):
    """Entropy variables v(U) rebuilt from flux-variable traces
    (rho, u_1..d, beta) and their logs, with no transcendentals
    (log p = log rho - log beta - log 2):

      s   = -(gamma-1) log rho - log beta - log 2
      v1  = gamma - s - (gamma-1) beta |u|^2
      v_d = 2 (gamma-1) beta u_d
      ve  = -2 (gamma-1) beta

    Both sides of a face evaluate this same formula on the same exchanged
    payload, which is what makes the BR1 jump bitwise antisymmetric
    across conforming faces; do not replace it by v_ufun of the
    conservative rebuild.
    """
    dim = qp.shape[0] - 2
    gm1 = gamma - 1.0
    beta = qp[dim + 1]
    vel = [qp[1 + d] for d in range(dim)]
    s = -gm1 * qp_log[0] - qp_log[1] - _LOG2
    tb = (2.0 * gm1) * beta
    v1 = (gamma - s) - (0.5 * tb) * sum(v * v for v in vel)
    return torch.stack([v1] + [tb * v for v in vel] + [-tb])


def inviscid_surface(disc, gather, qm, uf, qm_log, *, gamma, dissipation,
                     bc_inviscid=None, extra_parts=(),
                     entropy_extras=False, t=0.0):
    """Merged neighbour exchange + EC surface flux + LF dissipation.

    One batched exchange carries the flux-variable traces qm, their logs
    (when anything reads them) and any caller extras.  The conservative
    traces and the LF wavespeed never cross the exchange: both sides
    recompute them pointwise from the exchanged flux variables (the
    wavespeed's normal momentum uses the LOCAL normal).

    bc_inviscid(disc, qm, qp, uf, up, t) -> (qp, up) applies ghost
    states; entropy_extras rebuilds the neighbour entropy variables from
    the exchanged payload (``entropy_vars_from_flux``).

    Returns (flux [Nf, Nfq, K] ready for LIFT, extras_nbr): the rebuilt
    neighbour entropy variables with entropy_extras, else the gathered
    counterpart of extra_parts (an empty slice if none given).
    """
    dim = disc.dim
    nf = qm.shape[0]
    # the neighbour logs are read only by the extras rebuild and by the
    # no-BC EC flux; ghost states force a log recompute anyway
    ship_logs = entropy_extras or bc_inviscid is None
    parts = [qm] + ([qm_log] if ship_logs else [])
    n_inv = nf + (2 if ship_logs else 0)
    parts.extend(extra_parts)
    nbr = gather(torch.cat(parts, dim=0))
    qp = nbr[:nf]
    qp_log = nbr[nf:nf + 2] if ship_logs else None
    extras = (entropy_vars_from_flux(qp, qp_log, gamma)
              if entropy_extras else None)
    up = (flux_to_conservative(qp, gamma)
          if (dissipation or bc_inviscid is not None) else None)

    if bc_inviscid is not None:
        qp, up = bc_inviscid(disc, qm, qp, uf, up, t)
        # ghost states may change rho/beta; recompute the ghost logs
        fs = phys.ec_flux(qm, qp, qm_log, None, gamma=gamma)
    else:
        fs = phys.ec_flux(qm, qp, qm_log, qp_log, gamma=gamma)
    flux = sum(f * n[None] for f, n in zip(fs, disc.nxj))
    if dissipation:
        def lam(u):
            rhoun = sum(u[1 + d] * disc.nxj[d] for d in range(dim))
            return phys.wavespeed(u[0], rhoun * disc.inv_sj, u[-1], gamma)

        lfc = 0.25 * torch.maximum(lam(uf), lam(up)) * disc.sj
        flux = flux - lfc[None] * (up - uf)
    return flux, (extras if entropy_extras else nbr[n_inv:])


def neighbor_traction(disc, bc, t_f, t_ex, t=0.0):
    """Neighbour normal traction along the LOCAL normal from the
    contracted stress exchange (t_ex = gather of t_f).  Interior faces
    read -t_ex; self-mapped (boundary) faces take the natural t_pn = t_f;
    BC regions then override their faces (``WallBC.stress_normal``)."""
    if bc is not None:
        return bc.stress_normal(disc, t_f, t_ex, t)
    return torch.where(disc.bmask[None], t_f, -t_ex)


def viscous_penalty_rows(disc, bc, adiab_mask, vuf, vup, dv, re):
    """Interface penalty tau = -1/(Re v_last) rows, stacked [Nf, Nfq, K]
    (reference dg2D_CNS_cavity_optimized.jl:817-840), with the wall
    energy row from ``bc.penalty_energy_rows``."""
    dim = disc.dim
    tau = -1.0 / (re * vuf[dim + 1])
    rows = [torch.zeros_like(dv[0])]
    for d in range(dim):
        rows.append(tau * dv[1 + d])
    if bc is not None and adiab_mask is not None:
        rows.append(bc.penalty_energy_rows(vuf, vup, dv, tau, adiab_mask))
    else:
        rows.append(tau * dv[dim + 1])
    return torch.stack(rows)
