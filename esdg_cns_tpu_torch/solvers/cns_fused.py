"""Affine-mesh fused CNS RHS: composed operators over K3 and K4.

Port of ``esdg_cns_tpu/solvers/cns_fused.make_cns_rhs_affine`` for the
paths of the 2D tri cavity.  On affine meshes the geometric factors and
1/J are per-element scalars, so they commute with the reference
operators and the viscous chain composes at setup time: the front
operator [Vq Pq; Vq D_r Pq], Vq LIFT and D_r Pq.  Per RHS:

  1. K3 ``ops.modal_volume.euler_modal_volume``: projection, flux
     variables, flux differencing and Ph QF; emits ph_qf, the face
     traces (qm | log rho, log beta) and v(U) at quadrature;
  2. one exchange of the traces (``Discretization.gather_traces``);
  3. K4 ``ops.surface_viscous.cns_surface_viscous``: BC ghosts, EC face
     flux + LF, entropy BC, BR1 jump, penalty, the viscous mid-section
     and (``merged_tail``) the LIFTs and the 1/J assembly;
  4. a second exchange, of the contracted traction;
  5. one LIFT of the traction jump and the 1/J scaling.

Semantics equal to ``solvers.cns.make_cns_rhs`` (the plain twin) up to
roundoff: the same physics, the same BC hooks, the same two exchanges.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..physics import euler as phys
from .dg_ops import _apply


def composed_operators(disc):
    """(front [(1+dim) Nq, Nq] = [Vq Pq; Vq D_r Pq], vqlift [Nq, Nfq] =
    Vq LIFT, drpq [dim, Np, Nq] = D_r Pq): products in float64 of the
    discretization's own operators, rounded once to its dtype."""
    f64 = torch.float64
    cast = lambda a: a.to(disc.vq.dtype).contiguous()
    vq64, pq64 = disc.vq.to(f64), disc.pq.to(f64)
    drpq64 = [di.to(f64) @ pq64 for di in disc.d]
    front = torch.cat([vq64 @ pq64] + [vq64 @ dp for dp in drpq64])
    return (cast(front), cast(vq64 @ disc.lift.to(f64)),
            cast(torch.stack(drpq64)))


def make_cns_rhs_affine(disc, *, mu: float, lam: Optional[float] = None,
                        pr: float = 0.71, gamma: float = phys.GAMMA, bc=None,
                        inviscid_dissipation: bool = False,
                        viscous_dissipation: bool = False,
                        re: Optional[float] = None,
                        volume_impl: str = "fused",
                        viscous_impl: str = "auto",
                        surface_impl: str = "auto",
                        compute_rhstest: bool = True):
    """Composed-operator CNS RHS for affine meshes; same contract as
    ``solvers.cns.make_cns_rhs``.

    volume_impl: 'fused' (K3, which holds its own flux differencing) is
      the port's; 'xla' and 'fused_hex' raise NotImplementedError
      (ROADMAP).
    viscous_impl: 'auto' or 'fused' (the viscous mid-section runs inside
      K4); 'xla' conflicts with the merged surface.
    surface_impl: 'merged' (K4, returns flux/penalty/divergence for an
      outside LIFT), 'merged_tail' (K4 with the LIFTs and 1/J folded in;
      requires compute_rhstest=False) or 'auto' ('merged_tail' when
      compute_rhstest is False, 'merged' otherwise).  'fused' and 'xla'
      raise NotImplementedError (ROADMAP).
    The composed operators come from ``composed_operators``.

    Returns rhs(q, t) -> (dq, aux{'rhstest_visc'[, 'rhstest',
    'rhstest_visc_total']}).
    """
    if not disc.affine:
        raise ValueError("make_cns_rhs_affine requires an affine mesh")
    from ..ops.cns_surface_bc import prepare_surface_bc
    from ..ops.modal_volume import euler_modal_volume
    from ..ops.surface_viscous import cns_surface_viscous
    from ..utils.compensated import weighted_entropy_residual
    from ._shared import adiabatic_mask, neighbor_traction

    if volume_impl == "fused_hex" and (disc.elem_type != "hex"
                                       or disc.line_ops is None):
        raise ValueError("volume_impl='fused_hex' requires a collocated "
                         "hex discretization")
    # the merged kernel's per-element production partials are summed in
    # the state dtype (the JAX rule's rhstest_mode='native')
    fused_visc_ok = volume_impl in ("fused", "fused_hex")
    if viscous_impl == "fused" and not fused_visc_ok:
        raise ValueError("viscous_impl='fused' requires volume_impl in "
                         "('fused', 'fused_hex')")
    if viscous_impl not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown viscous_impl: {viscous_impl!r}")
    if surface_impl not in ("auto", "fused", "merged", "merged_tail", "xla"):
        raise ValueError(f"unknown surface_impl: {surface_impl!r}")
    if surface_impl == "merged_tail" and compute_rhstest:
        # the tail-folded kernel emits only the assembled dq partial; the
        # separate dq_v of the rhstest splitting is not materialized
        raise ValueError("surface_impl='merged_tail' requires "
                         "compute_rhstest=False (use 'merged')")
    auto_merged = (surface_impl == "auto" and fused_visc_ok
                   and viscous_impl in ("auto", "fused"))
    use_merged = surface_impl in ("merged", "merged_tail") or auto_merged
    fold_tail = surface_impl == "merged_tail" or (auto_merged
                                                  and not compute_rhstest)
    if use_merged and not fused_visc_ok:
        raise ValueError("surface_impl='merged' requires volume_impl in "
                         "('fused', 'fused_hex')")
    if use_merged and viscous_impl == "xla":
        raise ValueError("surface_impl='merged' subsumes the viscous "
                         "mid-section; viscous_impl='xla' conflicts")
    if volume_impl != "fused":
        raise NotImplementedError(
            f"volume_impl={volume_impl!r} is not ported yet: 'xla' is "
            "ROADMAP Queue 1 item 6, 'fused_hex' the 3D cavity slice "
            "(Queue 2)")
    if not use_merged:
        raise NotImplementedError(
            f"surface_impl={surface_impl!r} with viscous_impl="
            f"{viscous_impl!r} is not ported yet: the standalone CNS "
            "surface and viscous kernels are ROADMAP Queue 2 items, the "
            "plain tensor surface is Queue 1 item 6")

    dim = disc.dim
    nf = dim + 2
    nq = disc.nq
    re = (1.0 / mu) if re is None else re
    adiab = adiabatic_mask(disc, bc)
    gather = disc.gather_traces

    front, vqlift, drpq = composed_operators(disc)
    q_skew = torch.stack(disc.q_skew)
    ef = disc.vhp[nq:].contiguous()
    nxj = torch.stack(disc.nxj)
    inv_j = disc.inv_jac[:1]                         # [1, K] affine
    surf_pool, surf_recipe, surf_evals = prepare_surface_bc(bc, adiab, dim)
    kw = dict(gamma=gamma, mu=mu, lam=lam, pr=pr, re=re, nq=nq,
              dissipation=inviscid_dissipation,
              with_penalty=viscous_dissipation, recipe=surf_recipe)

    def rhs(q, t=0.0):
        ph_qf, tr, vu_q = euler_modal_volume(q, disc.geo, q_skew, disc.vq,
                                             disc.vhp, disc.ph, gamma, nq=nq)
        qm, qm_log = tr[:nf], tr[nf:nf + 2]
        nbr = gather(tr)                 # exchange 1: (qm | logs)
        pool = surf_pool
        if surf_evals:
            pool = torch.cat([surf_pool] + [e(t) for e in surf_evals])
        args = (vu_q, qm, qm_log, nbr, nxj, disc.sj, disc.inv_sj, pool,
                disc.geo, inv_j, disc.wjq, front, vqlift, ef, drpq)
        if fold_tail:
            dq_part, t_f, prod, vuq = cns_surface_viscous(
                *args, ph_qf, disc.lift, fold_tail=True, **kw)
        else:
            flux, pen, t_f, div, prod, vuq = cns_surface_viscous(*args, **kw)
        rhstest_visc = torch.sum(prod)

        t_ex = gather(t_f)               # exchange 2: contracted traction
        t_pn = neighbor_traction(disc, bc, t_f, t_ex, t)
        jump_n = 0.5 * (t_pn - t_f)
        if fold_tail:
            dq = dq_part + _apply(disc.lift, jump_n) * inv_j[None]
            return dq, {"rhstest_visc": rhstest_visc}

        lift_in = [flux, jump_n] + ([pen] if viscous_dissipation else [])
        lifted = _apply(disc.lift, torch.stack(lift_in))
        dq_i = -(ph_qf + lifted[0]) * inv_j[None]
        dq_v = (div + lifted[1]) * inv_j[None]
        if viscous_dissipation:
            # the lifted penalty is added after the 1/J scaling
            # (reference cavity_optimized:840-846)
            dq_v = dq_v + lifted[2]
        dq = dq_i + dq_v
        aux = {"rhstest_visc": rhstest_visc}
        if compute_rhstest:
            aux["rhstest"] = weighted_entropy_residual(
                disc.wjq, vuq, _apply(disc.vq, dq))
            rtv = weighted_entropy_residual(
                disc.wjq, vuq, _apply(disc.vq, dq_v))
            aux["rhstest_visc_total"] = rtv + rhstest_visc
        return dq, aux

    return rhs
