"""Dense volume flux differencing: QF_i = sum_j 2 A_ij . F(q_i, q_j).

The benchmark's frozen copy of
``esdg_cns_tpu_torch/ops/flux_differencing.flux_differencing_xla`` (the
triangle's volume term, the source's dense_hadamard_sum,
dg2D_euler_tri.jl:88-126), with two departures made here:
  * ``flux_differencing_dense`` runs it on blocks of elements, so that
    the all-pairs [Nf, Nh, Nh, K] fluxes fit on the card at a large K;
  * under ``solvers.dg_ops.matmul_rounding("tf32")`` the skew operators
    and the fluxes they contract are rounded to TF32, as every other
    operator product of the reference is.
"""

from __future__ import annotations

import torch

from ..physics.euler import ec_flux
from ..solvers import dg_ops

# the two-point pairs a block holds: [Nh, Nh, block] pairs, about 270 MB a
# temporary in float64 (the flux's few dozen temporaries stay under 10 GB)
BLOCK_PAIRS = 2 ** 25


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
    tf32 = dg_ops._MATMUL_ROUNDING.get() == "tf32"

    qi = qh[:, :, None, :]      # [Nf, Nh, 1, K]
    qj = qh[:, None, :, :]      # [Nf, 1, Nh, K]
    li = qlog[:, :, None, :] if qlog is not None else None
    lj = qlog[:, None, :, :] if qlog is not None else None
    fluxes = ec_flux(qi, qj, li, lj, gamma)  # dim x [Nf, Nh, Nh, K]
    if tf32:
        fluxes = [dg_ops.to_tf32(f) for f in fluxes]

    curved = geo.shape[1] != 1
    qf = None
    for rdir in range(dim):
        op = dg_ops.to_tf32(q_skew[rdir]) if tf32 else q_skew[rdir]
        a = op[None, :, :, None]                          # [1, Nh, Nh, 1]
        for xdir in range(dim):
            g = geo[rdir * dim + xdir]                    # [Ng, K]
            if curved:
                gavg = 0.5 * (g[:, None, :] + g[None, :, :])
                contrib = torch.sum(a * gavg[None] * fluxes[xdir], dim=2)
            else:
                contrib = torch.sum(a * fluxes[xdir], dim=2) * g[None]
            qf = contrib if qf is None else qf + contrib
    return 2.0 * qf


def flux_differencing_dense(qh, qlog, q_skew, geo, gamma, *,
                            block=None):
    """``flux_differencing_xla`` on blocks of ``block`` elements (by
    default as many as BLOCK_PAIRS pairs fill), the results joined along
    K; the numbers of one call, to roundoff (the sums run over
    other strides)."""
    nh, k = qh.shape[1], qh.shape[-1]
    block = max(1, BLOCK_PAIRS // (nh * nh)) if block is None else block
    if block >= k:
        return flux_differencing_xla(qh, qlog, q_skew, geo, gamma)
    parts = []
    for a in range(0, k, block):
        b = min(k, a + block)
        parts.append(flux_differencing_xla(
            qh[..., a:b], None if qlog is None else qlog[..., a:b], q_skew,
            geo[..., a:b], gamma))
    return torch.cat(parts, dim=-1)
