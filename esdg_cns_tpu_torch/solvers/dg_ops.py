"""Operator application and first-order DG building blocks.

Port of ``esdg_cns_tpu/solvers/dg_ops.py``: ``_apply`` (a plain matrix
product of small dense reference operators with [..., Np, K] fields,
outside any kernel) and the strong-form gradient / divergence with
central (BR1) interface corrections (reference dg_grad!/dg_div!,
dg2D_CNS_cavity_optimized.jl:548-611).  On the card the products run in
full f32/f64; the caller keeps ``torch.backends.cuda.matmul.allow_tf32``
False, because TF32 products (like the TPU's one-pass bf16 default)
break the discrete SBP and entropy identities.
"""

from __future__ import annotations

import torch


def _apply(mat, x):
    """mat [i, j] applied to x [..., j, k] -> [..., i, k]."""
    return torch.einsum("ij,...jk->...ik", mat, x)


def physical_derivatives(disc, u):
    """Strong-form physical derivatives (times J): tuple over x-dirs of
    sum_r geo[r*dim+x] * (D_r u), shape like u."""
    dim = disc.dim
    du_ref = [_apply(d, u) for d in disc.d]
    out = []
    for xdir in range(dim):
        acc = None
        for rdir in range(dim):
            g = disc.geo_nodal[rdir * dim + xdir]  # [Ngn, K]
            term = g * du_ref[rdir]
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)


def dg_grad(disc, u, uf, up):
    """BR1 gradient: strong volume derivative + 1/2 LIFT of the jump.

    u [..., Np, K] nodal field; uf its trace [..., Nfq, K]; up the
    neighbour (or ghost) trace.  Returns a tuple over x-dirs of
    [..., Np, K].
    """
    vol = physical_derivatives(disc, u)
    out = []
    for xdir in range(disc.dim):
        surf = _apply(disc.lift, 0.5 * (up - uf) * disc.nxj[xdir])
        out.append((vol[xdir] + surf) * disc.inv_jac)
    return tuple(out)


def dg_div(disc, flux_vols, flux_fs, flux_ps):
    """BR1 divergence of a vector field given per-direction components.

    flux_vols: tuple over x-dirs of [..., Np, K]; flux_fs / flux_ps:
    tuples of the own and neighbour traces [..., Nfq, K].
    """
    jump_n = sum(0.5 * (flux_ps[x] - flux_fs[x]) * disc.nxj[x]
                 for x in range(disc.dim))
    return dg_div_contracted(disc, flux_vols, jump_n)


def dg_div_contracted(disc, flux_vols, jump_n):
    """``dg_div`` with the interface jump already normal-contracted
    (jump_n [..., Nfq, K]): only sum_x flux_x nxj_x crosses the
    exchange."""
    acc = None
    for xdir in range(disc.dim):
        d = physical_derivatives(disc, flux_vols[xdir])[xdir]
        acc = d if acc is None else acc + d
    return (acc + _apply(disc.lift, jump_n)) * disc.inv_jac
