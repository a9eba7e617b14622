"""Merged surface + viscous stage (K4) of the affine CNS RHS.

Port of ``esdg_cns_tpu/ops/pallas_viscous.py``: ``cns_surface_viscous``
(CUDA ``csrc/cns_surface_viscous.cu``) replaces
``_surface_viscous_kernel`` / ``cns_surface_viscous_pallas`` (body
``_viscous_body``).  After the trace exchange, per element: the
conservative and entropy traces rebuilt from the flux-variable payload,
the wall-BC ghosts (``ops.cns_surface_bc``), the EC face flux + LF, the
entropy BC and BR1 jump, the interface penalty; then the front product,
gradients, sigma = K(v) grad(v), the contracted traction, the
divergence and the per-element entropy production; with ``fold_tail``
also the flux/penalty LIFTs and the 1/J assembly against ``ph_qf``.

``cns_surface_viscous_plain`` is the same function in plain PyTorch, on
the very same BC hooks.  The wrapper takes it only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
``cns_surface_viscous.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from ..physics import euler as phys
from ..physics.viscous import viscous_flux_nd
from ..solvers._shared import (entropy_vars_from_flux, flux_to_conservative,
                               viscous_penalty_rows)
from ..solvers.dg_ops import _apply
from .cns_surface_bc import DiscShim, rebuild_surface_bc, region_table
from .fused_volume import _DTYPE_CODE, _check_cuda, _check_shape, _raise_on


def _viscous_body(vu, dv, geo, nxj, invj, wjq, front, vqlift, ef, drpq, *,
                  dim, nq, gamma, mu, lam, pr):
    """The viscous mid-section (front product, gradients, K(v), the
    contracted traction, divergence, production) on whole tensors;
    returns (t_f, div, prod [1, K], vuq)."""
    nf = dim + 2
    fr = _apply(front, vu)                           # [Nf, (1+dim) Nq, K]
    vuq = fr[:, :nq]
    vqd = [fr[:, (1 + r) * nq:(2 + r) * nq] for r in range(dim)]

    grads = []
    for x in range(dim):
        surf = _apply(vqlift, 0.5 * dv * nxj[x][None])
        vol = None
        for r in range(dim):
            term = geo[r * dim + x] * vqd[r]
            vol = term if vol is None else vol + term
        grads.append((vol + surf) * invj)

    sigma = viscous_flux_nd(vuq, grads, mu, lam, pr, gamma)

    t_f = None
    for x in range(dim):
        term = _apply(ef, sigma[x]) * nxj[x][None]
        t_f = term if t_f is None else t_f + term

    div = None
    for r in range(dim):
        g_r = None
        for x in range(dim):
            term = geo[r * dim + x] * sigma[x]
            g_r = term if g_r is None else g_r + term
        t = _apply(drpq[r], g_r)
        div = t if div is None else div + t

    prod = None
    for x in range(dim):
        for f in range(nf):
            term = torch.sum(wjq * grads[x][f] * sigma[x][f], dim=0,
                             keepdim=True)
            prod = term if prod is None else prod + term
    return t_f, div, prod, vuq


def cns_surface_viscous_plain(vu_q, qm, qm_log, nbr, nxj, sj, inv_sj, pool,
                              geo, inv_j, wjq, front, vqlift, ef, drpq,
                              ph_qf=None, lift=None, *, gamma, mu, lam, pr,
                              re, nq, dissipation, with_penalty, recipe=None,
                              fold_tail=False):
    """Plain PyTorch merged surface + viscous stage; same contract as
    ``cns_surface_viscous`` (any dim)."""
    nf = vu_q.shape[0]
    dim = nf - 2
    disc = DiscShim(dim)

    uf = flux_to_conservative(qm, gamma)
    vuf = entropy_vars_from_flux(qm, qm_log, gamma)
    qp = nbr[:nf]
    qp_log = nbr[nf:nf + 2]
    vup = entropy_vars_from_flux(qp, qp_log, gamma)

    bc = adiab = None
    if recipe is not None:
        bc, adiab = rebuild_surface_bc(pool, recipe, dim, nf)

    up = (flux_to_conservative(qp, gamma)
          if (dissipation or bc is not None) else None)
    if bc is not None:
        qp, up = bc.inviscid(disc, qm, qp, uf, up, 0.0)
        fs = phys.ec_flux(qm, qp, qm_log, None, gamma=gamma)
    else:
        fs = phys.ec_flux(qm, qp, qm_log, qp_log, gamma=gamma)
    flux = sum(f * n[None] for f, n in zip(fs, nxj))
    if dissipation:
        def lam_w(u):
            rhoun = sum(u[1 + d] * nxj[d] for d in range(dim))
            return phys.wavespeed(u[0], rhoun * inv_sj, u[nf - 1], gamma)

        lfc = 0.25 * torch.maximum(lam_w(uf), lam_w(up)) * sj
        flux = flux - lfc[None] * (up - uf)

    if bc is not None:
        vup = bc.entropy_vars(disc, vuf, vup, 0.0)
    dv = vup - vuf
    pen = (viscous_penalty_rows(disc, bc, adiab, vuf, vup, dv, re)
           if with_penalty else None)

    t_f, div, prod, vuq = _viscous_body(
        vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef, drpq, dim=dim,
        nq=nq, gamma=gamma, mu=mu, lam=lam, pr=pr)

    if fold_tail:
        # the lifted penalty is added after the 1/J scaling, as the
        # reference does (dg2D_CNS_cavity_optimized.jl:840-846)
        dq = -(ph_qf + _apply(lift, flux)) * inv_j + div * inv_j
        if with_penalty:
            dq = dq + _apply(lift, pen)
        return dq, t_f, prod, vuq
    return flux, pen, t_f, div, prod, vuq


def cns_surface_viscous(vu_q, qm, qm_log, nbr, nxj, sj, inv_sj, pool, geo,
                        inv_j, wjq, front, vqlift, ef, drpq, ph_qf=None,
                        lift=None, *, gamma, mu, lam, pr, re, nq,
                        dissipation, with_penalty, recipe=None,
                        fold_tail=False):
    """ONE kernel for the post-exchange surface stage and the viscous
    mid-section of the affine CNS path.

    vu_q [Nf, Nq, K] raw v(U) at quadrature; qm [Nf, Nfq, K] + qm_log
    [2, Nfq, K] local flux-variable traces; nbr [Nf+2, Nfq, K] the
    gathered (qp | qp_log); nxj [dim, Nfq, K]; sj / inv_sj [Nfq, K]; pool
    [L, Nfq, K] + recipe from ``cns_surface_bc.prepare_surface_bc``
    (Dirichlet evaluations already concatenated), or None; geo
    [dim*dim, 1, K]; inv_j [1, K]; wjq [Nq, K]; front [(1+dim) Nq, Nq];
    vqlift [Nq, Nfq]; ef [Nfq, Nq]; drpq [dim, Np, Nq].  lam None means
    the Stokes value -2/3 mu.

    Returns (flux, pen, t_f, div, prod, vuq) (pen None without
    with_penalty), or with fold_tail=True, which also takes ph_qf
    [Nf, Np, K] and lift [Np, Nfq], (dq_part, t_f, prod, vuq) with
    dq = dq_part + LIFT(jump)/J left to the caller.  The CUDA kernel
    covers dim = 2; the 3D cavity's form (dim = 3, no projection block on
    collocated hexes) is still to port.
    """
    args = (vu_q, qm, qm_log, nbr, nxj, sj, inv_sj, pool, geo, inv_j, wjq,
            front, vqlift, ef, drpq, ph_qf, lift)
    kw = dict(gamma=gamma, mu=mu, lam=lam, pr=pr, re=re, nq=nq,
              dissipation=dissipation, with_penalty=with_penalty,
              recipe=recipe, fold_tail=fold_tail)
    if vu_q.device.type == "cpu":
        return cns_surface_viscous_plain(*args, **kw)
    if vu_q.device.type != "cuda":
        raise ValueError(f"cns_surface_viscous: no kernel for device "
                         f"{vu_q.device}")
    name = "cns_surface_viscous"
    nf, _, k = vu_q.shape
    if nf != 4:
        raise NotImplementedError(
            f"{name}: the CUDA kernel covers dim = 2 (the 3D cavity's form "
            "is still to port)")
    nfq = qm.shape[1]
    np_ = drpq.shape[1]
    tensors = {"vu_q": vu_q, "qm": qm, "qm_log": qm_log, "nbr": nbr,
               "nxj": nxj, "sj": sj, "inv_sj": inv_sj, "geo": geo,
               "inv_j": inv_j, "wjq": wjq, "front": front, "vqlift": vqlift,
               "ef": ef, "drpq": drpq}
    shapes = {"vu_q": (4, nq, k), "qm": (4, nfq, k), "qm_log": (2, nfq, k),
              "nbr": (6, nfq, k), "nxj": (2, nfq, k), "sj": (nfq, k),
              "inv_sj": (nfq, k), "geo": (4, 1, k), "inv_j": (1, k),
              "wjq": (nq, k), "front": (3 * nq, nq), "vqlift": (nq, nfq),
              "ef": (nfq, nq), "drpq": (2, np_, nq)}
    if recipe is not None:
        tensors["pool"] = pool
        shapes["pool"] = (pool.shape[0], nfq, k)
        n_dir = sum(spec[0] == "dirichlet" for spec in recipe[3])
        rows = recipe[4] + 2 * nf * n_dir
        if pool.shape[0] != rows:
            raise ValueError(f"{name}: the pool has {pool.shape[0]} rows, "
                             f"the recipe reads {rows} (the Dirichlet "
                             "evaluations go after the static rows)")
    if fold_tail:
        tensors.update(ph_qf=ph_qf, lift=lift)
        shapes.update(ph_qf=(4, np_, k), lift=(np_, nfq))
    _check_cuda(name, tensors, vu_q.dtype, vu_q.device)
    for key, t in tensors.items():
        _check_shape(name, key, t, shapes[key])

    new = lambda *shape: torch.empty(shape, dtype=vu_q.dtype,
                                     device=vu_q.device)
    flux = None if fold_tail else new(4, nfq, k)
    pen = new(4, nfq, k) if with_penalty and not fold_tail else None
    t_f, div, prod, vuq = new(4, nfq, k), new(4, np_, k), new(1, k), \
        new(4, nq, k)
    if k == 0:
        return ((div, t_f, prod, vuq) if fold_tail
                else (flux, pen, t_f, div, prod, vuq))
    from ..kernels import library, pointer_array

    lib = library()
    if recipe is None:
        itab = ftab = None
    else:
        itab, ftab = region_table(recipe, vu_q.device)
    lam_v = -2.0 / 3.0 * mu if lam is None else lam
    ins = pointer_array([vu_q, qm, qm_log, nbr, nxj, sj, inv_sj,
                         pool if recipe is not None else None, geo, inv_j,
                         wjq, front, vqlift, ef, drpq,
                         ph_qf if fold_tail else None,
                         lift if fold_tail else None])
    outs = pointer_array([flux, pen, t_f, div, prod, vuq])
    with torch.cuda.device(vu_q.device):
        stream = torch.cuda.current_stream(vu_q.device).cuda_stream
        rc = lib.esdg_cns_surface_viscous(
            _DTYPE_CODE[vu_q.dtype], ins, outs,
            None if itab is None else itab.data_ptr(),
            None if ftab is None else ftab.data_ptr(), k, np_, nq, nfq,
            float(gamma), float(mu), float(lam_v), float(pr), float(re),
            int(dissipation), int(with_penalty), int(fold_tail),
            int(recipe is not None), stream)
    _raise_on(name, rc, "the element tile does not fit in shared memory")
    cns_surface_viscous.launches += 1
    if fold_tail:
        return div, t_f, prod, vuq
    return flux, pen, t_f, div, prod, vuq


cns_surface_viscous.launches = 0
