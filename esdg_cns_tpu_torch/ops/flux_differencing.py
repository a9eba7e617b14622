"""Dense volume flux differencing: QF_i = sum_j 2 A_ij . F(q_i, q_j).

Port of ``esdg_cns_tpu/ops/flux_differencing.flux_differencing_xla``: the
all-pairs two-point fluxes as broadcast tensor ops over [Nh, Nh, K]
tiles, contracted against the skew operators.  The zero face-face block
of the skew operators makes those pairs contribute exactly zero.  It is
the tri volume term of the plain RHS (reference dense_hadamard_sum,
dg2D_euler_tri.jl:88-126) and the plain version of the fused modal
volume kernel's flux differencing.
"""

from __future__ import annotations

import torch

from ..physics.euler import ec_flux


def flux_differencing_xla(qh, qlog, q_skew, geo, gamma):
    """All-pairs flux differencing.

    Args:
      qh:    [Nf, Nh, K] flux variables (rho, u_1..d, beta).
      qlog:  [2, Nh, K] (log rho, log beta), or None.
      q_skew: tuple of dim [Nh, Nh] skew-symmetric hybridized operators.
      geo:   [dim*dim, Ng, K]; Ng = 1 affine, Ng = Nh curved (pairwise
             average (geo_i + geo_j)/2, reference dg3D_euler_hex.jl:146).
      gamma: ratio of specific heats.

    Returns QF [Nf, Nh, K] with QF[f,i,k] = sum_j 2 A^d_ij F^d_f(q_i,q_j),
    where A^d = sum_r geo[r,d] q_skew[r].
    """
    dim = len(q_skew)

    qi = qh[:, :, None, :]      # [Nf, Nh, 1, K]
    qj = qh[:, None, :, :]      # [Nf, 1, Nh, K]
    li = qlog[:, :, None, :] if qlog is not None else None
    lj = qlog[:, None, :, :] if qlog is not None else None
    fluxes = ec_flux(qi, qj, li, lj, gamma)  # dim x [Nf, Nh, Nh, K]

    curved = geo.shape[1] != 1
    qf = None
    for rdir in range(dim):
        a = q_skew[rdir][None, :, :, None]                # [1, Nh, Nh, 1]
        for xdir in range(dim):
            g = geo[rdir * dim + xdir]                    # [Ng, K]
            if curved:
                gavg = 0.5 * (g[:, None, :] + g[None, :, :])
                contrib = torch.sum(a * gavg[None] * fluxes[xdir], dim=2)
            else:
                contrib = torch.sum(a * fluxes[xdir], dim=2) * g[None]
            qf = contrib if qf is None else qf + contrib
    return 2.0 * qf
