"""Post-exchange CNS surface stage (K8) of the affine CNS RHS.

Port of ``esdg_cns_tpu/ops/pallas_cns_surface.py``: ``cns_surface``
(CUDA ``csrc/cns_surface.cu``) replaces ``_surface_kernel`` /
``cns_surface_pallas``.  Per face node, after the trace exchange: the
neighbour's conservative and entropy traces rebuilt from the exchanged
flux-variable payload (no transcendentals), the wall-BC ghosts
(``ops.cns_surface_bc``), the EC face flux + LF, the entropy BC and BR1
jump dv, and the interface-penalty rows.  The local conservative and
entropy traces ``uf`` / ``vuf`` are inputs, rebuilt by the caller with
the same formulas.

``_surface_body`` is that section on whole tensors; the merged kernel
K4 (``ops.surface_viscous``) runs the same body before its viscous
mid-section, as the TPU kernel does.  ``cns_surface_plain`` is the
plain PyTorch version; the wrapper takes it only for CPU tensors, and
for CUDA tensors launches the kernel or raises.  ``cns_surface.launches``
counts the launches.
"""

from __future__ import annotations

import torch

from ..physics import euler as phys
from ..solvers._shared import (entropy_vars_from_flux, flux_to_conservative,
                               viscous_penalty_rows)
from .cns_surface_bc import (DiscShim, rebuild_surface_bc, recipe_rows,
                             region_table)
from .fused_volume import _DTYPE_CODE, _check_cuda, _check_shape, _raise_on


def _surface_body(qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool, recipe,
                  *, gamma, re, dissipation, with_penalty):
    """The surface section on whole tensors; returns (flux, dv, pen) with
    pen None without with_penalty."""
    nf = qm.shape[0]
    dim = nf - 2
    disc = DiscShim(dim)
    qp = nbr[:nf]
    qp_log = nbr[nf:nf + 2]
    # comm-avoiding: the exchange carries qm + logs only; the neighbour
    # entropy traces are rebuilt pointwise
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
    return flux, dv, pen


def cns_surface_plain(qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool, *,
                      gamma, re, dim, dissipation, with_penalty,
                      recipe=None):
    """Plain PyTorch surface stage; same contract as ``cns_surface``."""
    if qm.shape[0] != dim + 2:
        raise ValueError(f"cns_surface: {qm.shape[0]} fields for dim={dim}")
    flux, dv, pen = _surface_body(
        qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool, recipe, gamma=gamma,
        re=re, dissipation=dissipation, with_penalty=with_penalty)
    return flux, dv, torch.zeros_like(dv) if pen is None else pen


def cns_surface(qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool, *, gamma,
                re, dim, dissipation, with_penalty, recipe=None):
    """ONE kernel for the post-exchange surface stage of the affine CNS
    path (any dim).

    qm / uf / vuf [Nf, Nfq, K] local traces (flux variables,
    conservative, entropy variables); qm_log [2, Nfq, K]; nbr
    [Nf+2, Nfq, K] the gathered (qp | qp_log); nxj [dim, Nfq, K]; sj /
    inv_sj [Nfq, K]; pool [L, Nfq, K] + recipe from
    ``cns_surface_bc.prepare_surface_bc`` (Dirichlet evaluations already
    concatenated), or None.

    Returns (flux, dv, pen), each [Nf, Nfq, K]; pen is zeros without
    with_penalty.
    """
    args = (qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool)
    kw = dict(gamma=gamma, re=re, dim=dim, dissipation=dissipation,
              with_penalty=with_penalty, recipe=recipe)
    if qm.device.type == "cpu":
        return cns_surface_plain(*args, **kw)
    if qm.device.type != "cuda":
        raise ValueError(f"cns_surface: no kernel for device {qm.device}")
    name = "cns_surface"
    nf, nfq, k = qm.shape
    if dim not in (1, 2, 3) or nf != dim + 2:
        raise NotImplementedError(
            f"{name}: the CUDA kernel covers dim = 1, 2 and 3 (Nf = dim + "
            f"2), got dim={dim} with {nf} fields")
    tensors = {"qm": qm, "uf": uf, "qm_log": qm_log, "vuf": vuf, "nbr": nbr,
               "nxj": nxj, "sj": sj, "inv_sj": inv_sj}
    shapes = {"qm": (nf, nfq, k), "uf": (nf, nfq, k), "qm_log": (2, nfq, k),
              "vuf": (nf, nfq, k), "nbr": (nf + 2, nfq, k),
              "nxj": (dim, nfq, k), "sj": (nfq, k), "inv_sj": (nfq, k)}
    if recipe is not None:
        tensors["pool"] = pool
        shapes["pool"] = (recipe_rows(recipe, nf), nfq, k)
    _check_cuda(name, tensors, qm.dtype, qm.device)
    for key, t in tensors.items():
        _check_shape(name, key, t, shapes[key])

    flux, dv, pen = (torch.empty_like(qm) for _ in range(3))
    if k == 0:
        return flux, dv, pen
    from ..kernels import library, pointer_array

    itab, ftab = (None, None) if recipe is None else region_table(
        recipe, qm.device)
    ins = pointer_array([qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj,
                         pool if recipe is not None else None])
    outs = pointer_array([flux, dv, pen])
    lib = library()
    with torch.cuda.device(qm.device):
        stream = torch.cuda.current_stream(qm.device).cuda_stream
        rc = lib.esdg_cns_surface(
            _DTYPE_CODE[qm.dtype], dim, ins, outs,
            None if itab is None else itab.data_ptr(),
            None if ftab is None else ftab.data_ptr(), k, nfq, float(gamma),
            float(re), int(dissipation), int(with_penalty),
            int(recipe is not None), stream)
    _raise_on(name, rc)
    cns_surface.launches += 1
    return flux, dv, pen


cns_surface.launches = 0
