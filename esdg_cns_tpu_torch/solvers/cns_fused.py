"""Affine-mesh fused CNS RHS: composed operators over the CNS kernels.

Port of ``esdg_cns_tpu/solvers/cns_fused.make_cns_rhs_affine``.  On
affine meshes the geometric factors and 1/J are per-element scalars, so
they commute with the reference operators and the viscous chain composes
at setup time: the front operator [Vq Pq; Vq D_r Pq], Vq LIFT and D_r Pq
(``composed_operators``).  Per RHS:

  1. the volume front end (``volume_impl``):
     'fused'     K3 ``ops.modal_volume.euler_modal_volume`` (any affine
                 mesh: lines, tris, hexes): projection, flux
                 differencing and Ph QF; emits ph_qf, the face traces
                 (qm | log rho, log beta) and v(U) at quadrature; the
                 viscous kernels then take the projected front
                 (proj=True) at every dim;
     'fused_hex' K1 ``ops.fused_volume.euler_volume`` (collocated hexes,
                 axis-aligned metric when ``detect_axis_aligned`` says
                 so), or at N = 7 the split path ``euler_volume_split``
                 (projection kernel, one fd kernel per direction), chosen
                 as the TPU package chooses; Vq = Pq = I
                 there, so the viscous front reads v(U) directly (K1
                 stores the v(U) of its projection; after the split
                 path ``phys.v_ufun``) and its front operator is the
                 gradient rows [Vq D_r Pq] alone (proj=False);
     'xla'       (the default, and any other name, as in the TPU
                 package) plain tensor code: one front GEMM [Vh Pq;
                 Vq Pq; Vq D_r Pq] on v(U) and ``flux_diff_impl``;
  2. one exchange of the traces (``Discretization.gather_traces``);
  3. the surface section and the viscous mid-section (``surface_impl``):
     'merged' / 'merged_tail' K4 ``ops.surface_viscous.
                 cns_surface_viscous`` (with ``merged_tail`` also the
                 LIFTs and the 1/J assembly);
     'fused'     K8 ``ops.cns_surface.cns_surface`` then K7
                 ``ops.surface_viscous.cns_viscous`` (or the plain
                 mid-section with viscous_impl='xla');
     'xla'       plain tensor code (``_shared.inviscid_surface``, the BC
                 hooks, ``viscous_penalty_rows``) and the plain or K7
                 mid-section;
  4. a second exchange, of the contracted traction;
  5. the LIFT of the traction jump (with the flux and penalty LIFTs
     unless folded into K4) and the 1/J scaling.
After K4's fold_tail form on collocated hexes with CUDA tensors, steps 4
and 5 are one kernel, ``ops.cns_tail.cns_traction_tail``, which reads
the neighbours' traction itself, wherever ``ops.cns_tail.traction_rule``
has a code for every wall region (interior, natural and adiabatic
points); elsewhere the plain lines.

Semantics equal to ``solvers.cns.make_cns_rhs`` (the plain twin) up to
roundoff: the same physics, the same BC hooks, the same two exchanges.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..physics import euler as phys
from ..physics.viscous import viscous_flux_nd
from ..tracing import span
from .dg_ops import _apply


def composed_operators(disc, proj: bool = True):
    """(front, vqlift [Nq, Nfq] = Vq LIFT, drpq [dim, Np, Nq] = D_r Pq):
    products in float64 of the discretization's own operators, rounded
    once to its dtype.  front is [(1+dim) Nq, Nq] = [Vq Pq; Vq D_r Pq]
    with proj, else the gradient rows [dim Nq, Nq] = [Vq D_r Pq] alone
    (collocated hexes, where Vq Pq = I)."""
    f64 = torch.float64
    cast = lambda a: a.to(disc.vq.dtype).contiguous()
    vq64, pq64 = disc.vq.to(f64), disc.pq.to(f64)
    drpq64 = [di.to(f64) @ pq64 for di in disc.d]
    rows = [vq64 @ dp for dp in drpq64]
    front = torch.cat(([vq64 @ pq64] if proj else []) + rows)
    return (cast(front), cast(vq64 @ disc.lift.to(f64)),
            cast(torch.stack(drpq64)))


def make_cns_rhs_affine(disc, *, mu: float, lam: Optional[float] = None,
                        pr: float = 0.71, gamma: float = phys.GAMMA, bc=None,
                        inviscid_dissipation: bool = False,
                        viscous_dissipation: bool = False,
                        re: Optional[float] = None,
                        flux_diff_impl: str = "auto",
                        volume_impl: str = "xla",
                        viscous_impl: str = "auto",
                        surface_impl: str = "auto",
                        compute_rhstest: bool = True,
                        rhstest_mode: str = "native",
                        axis_aligned: Optional[bool] = None,
                        fd_mode: Optional[str] = None):
    """Composed-operator CNS RHS for affine meshes; same contract as
    ``solvers.cns.make_cns_rhs``.

    volume_impl: 'xla' (the default, as in the TPU package: plain tensor
      code with ``flux_diff_impl``: 'auto', 'xla', 'pallas', 'lines' or
      'lines_pallas', ``_shared.resolve_flux_diff``), 'fused' (K3, any
      affine mesh: lines, tris, hexes) or 'fused_hex' (K1, collocated
      hexes; ``axis_aligned`` None detects the diagonal metric with
      ``detect_axis_aligned``).  Any other name
      takes the 'xla' front, as the TPU package does (its TGV example
      passes 'auto').  The fused volume kernels hold their own flux
      differencing.
    viscous_impl: 'fused' (K7, or inside K4; needs a fused volume and
      rhstest_mode='native', since the kernels sum the per-element
      production in the state dtype), 'xla' (plain tensor mid-section) or
      'auto' ('fused' whenever its requirements hold).
    surface_impl: 'merged' (K4), 'merged_tail' (K4 with the LIFTs and 1/J
      folded in; requires compute_rhstest=False), 'fused' (K8), 'xla'
      (plain tensor code) or 'auto' (the merged kernel on the fused
      volume paths: 'merged_tail' when compute_rhstest is False, 'merged'
      otherwise; 'xla' on the plain volume path).
    rhstest_mode: 'native' or 'f64' (the accumulation of the plain
      diagnostics, ``utils.compensated``).
    fd_mode: None, 'tri', 'tri8' or 'full': the TPU package's layouts of
      the fused front's flux differencing, one sum; checked, and the sum
      computed once.

    Returns rhs(q, t) -> (dq, aux{'rhstest_visc'[, 'rhstest',
    'rhstest_visc_total']}).
    """
    if not disc.affine:
        raise ValueError("make_cns_rhs_affine requires an affine mesh")
    from ..ops.cns_surface import cns_surface
    from ..ops.cns_tail import cns_traction_tail, traction_rule
    from ..ops.dense_fd import _check_mode
    from ..ops.cns_surface_bc import prepare_surface_bc
    from ..ops.fused_volume import (detect_axis_aligned, euler_volume,
                                    euler_volume_split)
    from ..ops.modal_volume import euler_modal_volume, modal_lists
    from ..ops.surface_viscous import (cns_surface_viscous, cns_viscous,
                                       visc_lists)
    from ..utils.compensated import weighted_entropy_residual
    from ._shared import (adiabatic_mask, entropy_vars_from_flux,
                          flux_to_conservative, inviscid_surface,
                          neighbor_traction, resolve_flux_diff,
                          viscous_penalty_rows)
    from .euler import flux_variables

    if fd_mode is not None:
        _check_mode(fd_mode)
    dim = disc.dim
    nf = dim + 2
    nq = disc.nq
    nh = disc.nh
    re = (1.0 / mu) if re is None else re

    if volume_impl == "fused_hex" and (disc.elem_type != "hex"
                                       or disc.line_ops is None):
        raise ValueError("volume_impl='fused_hex' requires a collocated "
                         "hex discretization")
    hex_diag = None
    # the TPU package's fused_hex front (cns_fused.py:314-318): the packed
    # joint kernel (K1 here) at misaligned orders (8 % (N+1) != 0) and at
    # N+1 = 4, the split path at any other N >= 4 (N = 7), K1 below
    packed = 8 % (disc.n + 1) != 0 or disc.n + 1 == 4
    split_front = volume_impl == "fused_hex" and disc.n >= 4 and not packed
    if volume_impl == "fused_hex":
        hex_diag = (detect_axis_aligned(disc) if axis_aligned is None
                    else axis_aligned)
    # the fused volume kernels contain their own flux differencing
    fd = (None if volume_impl in ("fused", "fused_hex")
          else resolve_flux_diff(disc, flux_diff_impl))
    adiab = adiabatic_mask(disc, bc)
    gather = disc.gather_traces

    # the fused viscous kernels consume the raw v(U) the fused volume
    # paths emit, and sum the per-element production in the state dtype
    fused_visc_ok = (volume_impl in ("fused", "fused_hex")
                     and rhstest_mode == "native")
    if viscous_impl == "fused" and not fused_visc_ok:
        raise ValueError("viscous_impl='fused' requires volume_impl in "
                         "('fused', 'fused_hex') and rhstest_mode='native'")
    if viscous_impl not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown viscous_impl: {viscous_impl!r}")
    use_fused_viscous = (viscous_impl == "fused"
                         or (viscous_impl == "auto" and fused_visc_ok))
    if surface_impl not in ("auto", "fused", "merged", "merged_tail",
                            "xla"):
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
                         "('fused', 'fused_hex') and rhstest_mode='native'")
    if use_merged and viscous_impl == "xla":
        raise ValueError("surface_impl='merged' subsumes the viscous "
                         "mid-section; viscous_impl='xla' conflicts")
    use_fused_surface = surface_impl == "fused"

    # ---- composed operators and per-element scalars (affine) ----
    # collocated hexes: Vq = Pq = I, so the fused viscous front is the
    # gradient rows alone and the kernels hand back the input v(U)
    proj = volume_impl != "fused_hex"
    front, vqlift, drpq = composed_operators(disc, proj=proj)
    if volume_impl not in ("fused", "fused_hex"):
        # rows [0:Nh) Vh Pq (the entropy projection; its face rows are
        # the entropy traces), then Vq Pq, then Vq D_r Pq
        front_h = torch.cat([disc.vhp, front])
    ef = disc.vhp[nq:].contiguous()
    q_skew = torch.stack(disc.q_skew)
    # K3's operator lists, built once with the RHS (on the CPU the plain
    # version reads the dense operators)
    k3_lists = (modal_lists(q_skew, disc.vq, disc.vhp, disc.ph, nq)
                if volume_impl == "fused" and q_skew.device.type == "cuda"
                else None)
    # the viscous kernels' operator lists on hexes, likewise (K4 and K7
    # read the dense operators on lines and tris)
    k4_lists = (visc_lists(front, vqlift, ef, drpq, disc.lift, nq=nq,
                           proj=proj)
                if dim == 3 and front.device.type == "cuda"
                and (use_merged or use_fused_viscous) else None)
    # the tail kernel's per-face-point rule, where it runs: after K4's
    # fold_tail form on collocated hexes at the line lengths it is built
    # for, every wall region of a kind it has a code for
    tail_rule = (traction_rule(disc, bc)
                 if fold_tail and dim == 3 and disc.elem_type == "hex"
                 and disc.line_ops is not None and disc.n + 1 <= 8
                 and front.device.type == "cuda" else None)
    nxj = torch.stack(disc.nxj)
    inv_j = disc.inv_jac[:1]                         # [1, K] affine
    geo = disc.geo                                   # [dim*dim, 1, K]
    surf_pool = surf_recipe = None
    surf_evals = ()
    if use_fused_surface or use_merged:
        surf_pool, surf_recipe, surf_evals = prepare_surface_bc(bc, adiab,
                                                                dim)
    visc_kw = dict(gamma=gamma, mu=mu, lam=lam, pr=pr, nq=nq, proj=proj,
                   lists=k4_lists)

    def front_xla(q):
        vu_q = phys.v_ufun(_apply(disc.vq, q), gamma)
        fr = _apply(front_h, vu_q)                   # [Nf, Nh+(1+dim)Nq, K]
        vuh = fr[:, :nh]
        vuq = fr[:, nh:nh + nq]
        vqd = [fr[:, nh + (1 + r) * nq:nh + (2 + r) * nq]
               for r in range(dim)]
        uh = phys.u_vfun(vuh, gamma)
        vuf = vuh[:, nq:]                            # = (Vf Pq) v: traces
        qh, qlog = flux_variables(uh, gamma)
        ph_qf = _apply(disc.ph, fd(qh, qlog, geo, gamma))
        tr = torch.cat([qh[:, nq:], qlog[:, nq:]])
        return tr, uh[:, nq:], vuf, vuq, vqd, ph_qf

    def traces(tr):
        """(uf, vuf): the conservative and entropy traces rebuilt
        pointwise from the kernel's flux-variable traces and logs.  The
        neighbour side evaluates the same formula on the exchanged payload,
        so the jump dv = vup - vuf is bitwise antisymmetric across
        conforming faces.  The merged kernel rebuilds both itself."""
        if use_merged:
            return None, None
        qm, qm_log = tr[:nf], tr[nf:nf + 2]
        return (flux_to_conservative(qm, gamma),
                entropy_vars_from_flux(qm, qm_log, gamma))

    def front_fused(q):
        ph_qf, tr, vu_q = euler_modal_volume(q, geo, q_skew, disc.vq,
                                             disc.vhp, disc.ph, gamma, nq=nq,
                                             lists=k3_lists)
        if use_fused_viscous:
            # the viscous kernels run the front product themselves
            return (tr, *traces(tr), vu_q, None, ph_qf)
        fr = _apply(front, vu_q)                     # [Nf, (1+dim)Nq, K]
        return (tr, *traces(tr), fr[:, :nq],
                list(fr[:, nq:].split(nq, dim=1)), ph_qf)

    def front_fused_hex(q):
        vkw = dict(line_ops=disc.line_ops, diag=hex_diag)
        if split_front:
            ph_qf, tr = euler_volume_split(q, geo, ef, disc.lift, gamma,
                                           **vkw)
            with span("solvers.cns_fused.entropy_vars"):
                vu_q = phys.v_ufun(q, gamma)
        else:
            # K1 stores the v(U) it computes for its projection
            ph_qf, tr, vu_q = euler_volume(q, geo, ef, disc.lift, gamma,
                                           with_v=True, **vkw)
        vqd = (None if use_fused_viscous
               else list(_apply(front, vu_q).split(nq, dim=1)))
        return (tr, *traces(tr), vu_q, vqd, ph_qf)

    front_fn = {"fused": front_fused,
                "fused_hex": front_fused_hex}.get(volume_impl, front_xla)

    def rhs(q, t=0.0):
        # tr = (qm | log rho, log beta) at the face points
        tr, uf, vuf, vuq, vqd, ph_qf = front_fn(q)
        qm, qm_log = tr[:nf], tr[nf:]
        pool = surf_pool
        if surf_evals:
            pool = torch.cat([surf_pool] + [e(t) for e in surf_evals])

        # ---- exchange 1 + surface (+ the viscous mid-section) ----
        if use_merged:
            nbr = gather(tr)
            args = (vuq, qm, qm_log, nbr, nxj, disc.sj, disc.inv_sj, pool,
                    geo, inv_j, disc.wjq, front, vqlift, ef, drpq)
            kw = dict(re=re, dissipation=inviscid_dissipation,
                      with_penalty=viscous_dissipation, recipe=surf_recipe,
                      **visc_kw)
            if fold_tail:
                dq_part, t_f, prod, vuq = cns_surface_viscous(
                    *args, ph_qf, disc.lift, fold_tail=True, **kw)
            else:
                flux, pen, t_f, div, prod, vuq = cns_surface_viscous(*args,
                                                                     **kw)
        elif use_fused_surface:
            nbr = gather(tr)
            flux, dv, pen = cns_surface(
                qm, uf, qm_log, vuf, nbr, nxj, disc.sj, disc.inv_sj, pool,
                gamma=gamma, re=re, dim=dim,
                dissipation=inviscid_dissipation,
                with_penalty=viscous_dissipation, recipe=surf_recipe)
        else:
            flux, vup = inviscid_surface(
                disc, gather, qm, uf, qm_log, gamma=gamma,
                dissipation=inviscid_dissipation,
                bc_inviscid=bc.inviscid if bc is not None else None,
                entropy_extras=True, t=t)
            if bc is not None:
                vup = bc.entropy_vars(disc, vuf, vup, t)
            dv = vup - vuf
            if viscous_dissipation:
                pen = viscous_penalty_rows(disc, bc, adiab, vuf, vup, dv, re)

        # the viscous mid-section, where K4 did not run it
        if use_fused_viscous and not use_merged:
            t_f, div, prod, vuq = cns_viscous(
                vuq, dv, geo, nxj, inv_j, disc.wjq, front, vqlift, ef, drpq,
                contract=True, **visc_kw)
        elif not use_fused_viscous:
            grad_q = [(sum(geo[r * dim + x] * vqd[r] for r in range(dim))
                       + _apply(vqlift, 0.5 * dv * disc.nxj[x][None]))
                      * inv_j for x in range(dim)]
            sigma = viscous_flux_nd(vuq, grad_q, mu, lam, pr, gamma)
            rhstest_visc = sum(
                weighted_entropy_residual(disc.wjq, g, s, rhstest_mode)
                for g, s in zip(grad_q, sigma))
            t_f = sum(_apply(ef, sigma[x]) * disc.nxj[x][None]
                      for x in range(dim))
            div = sum(_apply(drpq[r], sum(geo[r * dim + x] * sigma[x]
                                          for x in range(dim)))
                      for r in range(dim))

        # ---- the tail: the production's sum, exchange 2 (the contracted
        # traction), the traction BC, the jump's LIFT and the 1/J scaling
        with span("solvers.cns_fused.tail"):
            if use_fused_viscous:
                rhstest_visc = torch.sum(prod)
            if use_merged and fold_tail:
                # everything but the traction jump's LIFT happened in K4
                t_pn = (None if tail_rule is not None else
                        neighbor_traction(disc, bc, t_f, gather(t_f), t))
                dq = cns_traction_tail(dq_part, t_f, disc.lift, inv_j,
                                       rule=tail_rule, t_pn=t_pn)
                return dq, {"rhstest_visc": rhstest_visc}
            t_ex = gather(t_f)
            t_pn = neighbor_traction(disc, bc, t_f, t_ex, t)
            jump_n = 0.5 * (t_pn - t_f)

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
                    disc.wjq, vuq, _apply(disc.vq, dq), rhstest_mode)
                rtv = weighted_entropy_residual(
                    disc.wjq, vuq, _apply(disc.vq, dq_v), rhstest_mode)
                aux["rhstest_visc_total"] = rtv + rhstest_visc
            return dq, aux

    # the lists the kernels read, for holding them against the plain
    # versions on the same lists
    rhs.visc_lists = k4_lists
    return rhs
