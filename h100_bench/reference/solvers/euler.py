"""Entropy-stable DG semi-discretization of compressible Euler.

Port of ``esdg_cns_tpu/solvers/euler.py`` (``entropy_projection``,
``make_euler_rhs`` and ``l2_error``): the plain PyTorch twin of the fused
paths, built from tensor ops only, on collocated hexes (line-sparse flux
differencing) and on triangles (dense flux differencing).

  1. entropy projection  U -> V at quadrature -> project -> U at
     hybridized points,
  2. flux variables (rho, u, beta) + precomputed logs,
  3. face traces + neighbor gather (the only cross-element dependence),
  4. optional Lax-Friedrichs dissipation,
  5. EC surface flux + LIFT,
  6. volume flux differencing,
  7. scale by -1/J; entropy-balance diagnostic rhstest.
"""

from __future__ import annotations

import torch

from ..physics import euler as phys
from .dg_ops import _apply


def entropy_projection(disc, q, gamma: float):
    """U at solution nodes -> (VU at quad, U at hybridized points).

    For collocated quad/hex elements VhP = [I; Ef], so u_vfun(v_ufun(U))
    is the identity on the volume block — only the face extrapolation
    needs the inverse map (reference dg3D_euler_hex.jl:176-178).
    """
    if disc.line_ops is not None:  # collocated quad/hex
        vu = phys.v_ufun(q, gamma)
        uf = phys.u_vfun(_apply(disc.vhp[disc.nq:], vu), gamma)
        return vu, torch.cat([q, uf], dim=1)
    uq = _apply(disc.vq, q)
    vu = phys.v_ufun(uq, gamma)
    vuh = _apply(disc.vhp, vu)
    uh = phys.u_vfun(vuh, gamma)
    return vu, uh


def flux_variables(uh, gamma: float):
    """Conservative values at the hybridized points -> the flux variables
    qh = (rho, u_1..d, beta) and their logs qlog = (log rho, log beta),
    the input of the volume flux differencing."""
    beta = phys.betafun(uh, gamma)
    qh = torch.cat([uh[0][None], uh[1:-1] / uh[0], beta[None]], dim=0)
    return qh, torch.stack([torch.log(qh[0]), torch.log(qh[-1])])


def make_euler_rhs(
    disc,
    *,
    gamma: float = phys.GAMMA,
    dissipation: bool = True,
    bc_fun=None,
    flux_diff_impl: str = "xla",
    compute_rhstest: bool = True,
    rhstest_mode: str = "native",
):
    """Build the plain ES-DG Euler RHS.

    Args:
      disc: ``core.Discretization``.
      dissipation: add local Lax-Friedrichs interface dissipation
        (entropy-stable); without it the scheme is entropy-conservative.
      bc_fun: optional boundary hook
        ``bc_fun(disc, qm, qp, uf, up, t) -> (qp, up)`` applied to the
        gathered neighbour traces (flux-variable and conservative ghost
        states; ``WallBC.inviscid`` has this signature).  Periodicity is
        already in the exchange.
      flux_diff_impl: 'xla' (dense, the default, as in the TPU
        package), 'pallas' (dense, kernel K5), 'lines' (tensor-product
        sparse, collocated quad/hex), 'lines_pallas' (line-sparse, kernel
        row 10) or 'auto' ('lines' on collocated quad/hex, else 'xla');
        ``_shared.resolve_flux_diff``.
      rhstest_mode: 'native' or 'f64' (utils.compensated).

    Returns rhs(q, t) -> (dq/dt [Nf, Np, K], aux dict with 'rhstest').
    """
    from ._shared import inviscid_surface, resolve_flux_diff

    nq = disc.nq
    fd = resolve_flux_diff(disc, flux_diff_impl)

    def rhs(q, t: float = 0.0):
        vu, uh = entropy_projection(disc, q, gamma)
        qh, qlog = flux_variables(uh, gamma)

        # --- face traces + one batched neighbor exchange ---
        flux, _ = inviscid_surface(
            disc, disc.gather_traces, qh[:, nq:, :], uh[:, nq:, :],
            qlog[:, nq:, :], gamma=gamma, dissipation=dissipation,
            bc_inviscid=bc_fun, t=t,
        )
        rhs_surf = _apply(disc.lift, flux)

        # --- volume flux differencing ---
        qf = fd(qh, qlog, disc.geo, gamma)
        rhs_q = -(_apply(disc.ph, qf) + rhs_surf) * disc.inv_jac[None]

        aux = {}
        if compute_rhstest:
            from ..utils.compensated import weighted_entropy_residual

            aux["rhstest"] = weighted_entropy_residual(
                disc.wjq, vu, _apply(disc.vq, rhs_q), rhstest_mode
            )
        return rhs_q, aux

    return rhs


def l2_error(disc, q, q_exact_at_quad):
    """Quadrature L2 error of q against exact values at the quadrature
    points: sqrt(sum wJq (Vq q - q_exact)^2) over fields and elements."""
    dq = _apply(disc.vq, q) - q_exact_at_quad
    return torch.sqrt(torch.sum(disc.wjq[None] * dq * dq))
