"""Viscous terms of compressible Navier-Stokes in entropy variables.

Port of ``esdg_cns_tpu/physics/viscous.py``: BR1-style viscous fluxes
sigma = K(v) grad(v) with symmetric positive semidefinite coefficient
matrices K in the entropy variables, so the viscous entropy production
is nonnegative.  The same formulas in the same evaluation order, on
torch tensors (or Python lists of them: only field indexing and
pointwise math are used).

Conventions: ``mu`` dynamic viscosity, ``lam`` the bulk-coupling Lame
parameter (``None`` means the Stokes hypothesis lam = -2/3 mu), ``pr``
the Prandtl number.  Parity: reference ``viscous_matrices!``
(dg1D_CNS_modalESDG.jl:296-311, dg2D_CNS_modalESDG.jl:391-424).
"""

from __future__ import annotations

import torch

GAMMA = 1.4


def viscous_flux_1d(v, vx, mu, lam=None, pr=0.75, gamma=GAMMA):
    """sigma = K(v) dv/dx for 1D CNS (fields v1, v2, v4); v, vx [3, ...].

    Returns sigma [3, ...] (first row zero: no mass diffusion).
    """
    lam = -2.0 / 3.0 * mu if lam is None else lam
    c2mu = 2.0 * mu + lam            # = 4/3 mu under Stokes
    kappa_cv = gamma * mu / pr       # kappa / cv
    v2, v4 = v[1], v[2]
    k22 = -c2mu / v4
    k23 = c2mu * v2 / (v4 * v4)
    k33 = -(c2mu * v2 * v2 - kappa_cv * v4) / (v4 ** 3)
    s2 = k22 * vx[1] + k23 * vx[2]
    s3 = k23 * vx[1] + k33 * vx[2]
    return torch.stack([torch.zeros_like(s2), s2, s3])


def viscous_flux_2d(v, vx, vy, mu, lam=None, pr=0.71, gamma=GAMMA):
    """(sigma_x, sigma_y) = (Kxx vx + Kxy vy, Kxy' vx + Kyy vy) for 2D CNS;
    v, vx, vy [4, ...]."""
    lam = -2.0 / 3.0 * mu if lam is None else lam
    l2m = 2.0 * mu + lam
    v2, v3, v4 = v[1], v[2], v[3]
    inv3 = 1.0 / (v4 ** 3)
    vx2, vx3, vx4 = vx[1], vx[2], vx[3]
    vy2, vy3, vy4 = vy[1], vy[2], vy[3]

    kxx22 = -l2m * v4 * v4 * inv3
    kxx24 = l2m * v2 * v4 * inv3
    kxx33 = -mu * v4 * v4 * inv3
    kxx34 = mu * v3 * v4 * inv3
    kxx44 = -(l2m * v2 * v2 + mu * v3 * v3 - gamma * mu * v4 / pr) * inv3
    kxy23 = -lam * v4 * v4 * inv3
    kxy24 = lam * v3 * v4 * inv3
    kxy32 = -mu * v4 * v4 * inv3
    kxy34 = mu * v2 * v4 * inv3
    kxy42 = mu * v3 * v4 * inv3
    kxy43 = lam * v2 * v4 * inv3
    kxy44 = -(lam + mu) * v2 * v3 * inv3
    kyy22 = -mu * v4 * v4 * inv3
    kyy24 = mu * v2 * v4 * inv3
    kyy33 = -l2m * v4 * v4 * inv3
    kyy34 = l2m * v3 * v4 * inv3
    kyy44 = -(l2m * v3 * v3 + mu * v2 * v2 - gamma * mu * v4 / pr) * inv3

    sx2 = kxx22 * vx2 + kxx24 * vx4 + kxy23 * vy3 + kxy24 * vy4
    sx3 = kxx33 * vx3 + kxx34 * vx4 + kxy32 * vy2 + kxy34 * vy4
    sx4 = (kxx24 * vx2 + kxx34 * vx3 + kxx44 * vx4
           + kxy42 * vy2 + kxy43 * vy3 + kxy44 * vy4)
    sy2 = kxy32 * vx3 + kxy42 * vx4 + kyy22 * vy2 + kyy24 * vy4
    sy3 = kxy23 * vx2 + kxy43 * vx4 + kyy33 * vy3 + kyy34 * vy4
    sy4 = (kxy24 * vx2 + kxy34 * vx3 + kxy44 * vx4
           + kyy24 * vy2 + kyy34 * vy3 + kyy44 * vy4)

    z = torch.zeros_like(sx2)
    return (torch.stack([z, sx2, sx3, sx4]), torch.stack([z, sy2, sy3, sy4]))


def viscous_flux_nd(v, grads, mu, lam=None, pr=0.71, gamma=GAMMA):
    """Dimension-generic sigma_a = sum_b K(ab) dv/dx_b for 1D/2D/3D CNS.

    With w_i = v_{1+i}, ve = v_last and c_i = 2 mu + lam for i == a, else
    mu: K(aa) is symmetric with diagonal -c_i ve^2 / ve^3, energy coupling
    c_i w_i ve / ve^3 and energy diagonal -(sum_i c_i w_i^2 - gamma mu ve /
    pr) / ve^3; K(ab), a != b, carries the lam/mu cross-coupling, with
    K(ba) = K(ab)^T.

    Args:
      v:     [dim+2, ...] entropy variables (or a list of dim+2 rows).
      grads: length-dim sequence of [dim+2, ...] derivatives.
    Returns a length-dim tuple of [dim+2, ...] viscous fluxes.
    """
    dim = len(grads)
    lam = -2.0 / 3.0 * mu if lam is None else lam
    l2m = 2.0 * mu + lam
    w = [v[1 + i] for i in range(dim)]
    ve = v[dim + 1]
    inv3 = 1.0 / (ve ** 3)
    ve2i = ve * ve * inv3      # = 1/ve
    wvei = [wi * ve * inv3 for wi in w]

    sigma = []
    for a in range(dim):
        s_mom = [0.0] * dim
        s_e = 0.0
        for b in range(dim):
            gw = [grads[b][1 + i] for i in range(dim)]
            gve = grads[b][dim + 1]
            if a == b:
                kee = 0.0
                for i in range(dim):
                    c = l2m if i == a else mu
                    s_mom[i] = s_mom[i] - c * ve2i * gw[i] + c * wvei[i] * gve
                    s_e = s_e + c * wvei[i] * gw[i]
                    kee = kee + c * w[i] * w[i]
                s_e = s_e - (kee - gamma * mu * ve / pr) * inv3 * gve
            else:
                s_mom[a] = s_mom[a] - lam * ve2i * gw[b] + lam * wvei[b] * gve
                s_mom[b] = s_mom[b] - mu * ve2i * gw[a] + mu * wvei[a] * gve
                s_e = (s_e + mu * wvei[b] * gw[a] + lam * wvei[a] * gw[b]
                       - (lam + mu) * w[a] * w[b] * inv3 * gve)
        z = torch.zeros_like(s_e)
        sigma.append(torch.stack([z, *s_mom, s_e]))
    return tuple(sigma)


def viscous_flux_3d(v, vx, vy, vz, mu, lam=None, pr=0.71, gamma=GAMMA):
    """(sigma_x, sigma_y, sigma_z) for 3D CNS (fields v1, v2..v4, v5)."""
    return viscous_flux_nd(v, (vx, vy, vz), mu, lam, pr, gamma)
