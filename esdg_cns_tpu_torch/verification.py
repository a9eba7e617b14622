"""Verification harnesses: the Becker shock-tube errors.

Port of the Becker part of ``esdg_cns_tpu/verification.py``:
``becker_shocktube_errors`` solves the Mach-3 viscous shock tube at the
reference 1D driver's configuration (dg1D_CNS_modalESDG.jl:83-103) with
adaptive DOPRI45 and scores it with the reference's norm conventions
(:497-512, ``becker_errors``).  By default it runs the plain twin
``solvers.make_cns_rhs``, as the TPU package does; ``volume_impl`` names
a front of ``solvers.make_cns_rhs_affine`` instead (``'fused'``: the
kernel path K3, then K4), scored by the same ``becker_errors``.  The
MMS, wall-BC and Reynolds-ensemble harnesses are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .presets import becker_shocktube_1d
from .solvers import make_cns_rhs, make_cns_rhs_affine
from .solvers.dg_ops import _apply
from .timestepping import dopri45


def becker_dt0(n: int, k: int) -> float:
    """The reference 1D driver's initial step on [-2, 2] with k elements:
    min(0.5 h / C_N, 2 / (C_N k^2)), C_N = (N+1)(N+2)/2, h = 4 / k."""
    cn = (n + 1) * (n + 2) / 2
    return min(0.5 * (4.0 / k) / cn, 2.0 / (cn * k * k))


def becker_errors(disc, q, shock, t: float):
    """Summed per-field relative errors of the 1D state q [3, Np, K]
    against the exact wave at time t, in the reference's normalizations:
    L1 and L2 divided by the NUMERICAL solution's norm, Linf by the exact
    solution's.  Returns {"l1", "l2", "linf"} (NumPy f64 on the host)."""
    uq = _apply(disc.vq, q).double().cpu().numpy()
    uex = np.stack(shock.conservative(disc.xq[0].double().cpu().numpy(), t))
    w = disc.wjq.double().cpu().numpy()
    l1 = float(sum(np.sum(w * np.abs(uq[f] - uex[f]))
                   / np.sum(w * np.abs(uq[f])) for f in range(3)))
    l2 = float(sum(np.sqrt(np.sum(w * (uq[f] - uex[f]) ** 2))
                   / np.sqrt(np.sum(w * uq[f] ** 2)) for f in range(3)))
    linf = float(sum(np.abs(uq[f] - uex[f]).max()
                     / np.abs(uex[f]).max() for f in range(3)))
    return {"l1": l1, "l2": l2, "linf": linf}


def becker_shocktube_errors(n: int, k: int, t_end: float = 0.1,
                            err_tol: float = 1e-7, *, dtype: torch.dtype,
                            device, volume_impl: Optional[str] = None):
    """L1/L2/Linf Becker shock-tube errors at the reference driver's
    configuration (``presets.becker_shocktube_1d``: Mach 3, mu=0.1,
    Pr=3/4 on [-2, 2]) after adaptive DOPRI45 to ``t_end`` from
    ``becker_dt0``, with LF dissipation and no rhstest.

    volume_impl None: the plain twin ``make_cns_rhs`` (the TPU package's
    choice); else ``make_cns_rhs_affine(volume_impl=...)``.

    Returns {"l1", "l2", "linf", "n_accepted"}.
    """
    disc, q0, bc, shock = becker_shocktube_1d(n=n, k=k, dtype=dtype,
                                              device=device)
    flags = dict(mu=shock.mu, pr=shock.pr, bc=bc, inviscid_dissipation=True,
                 compute_rhstest=False)
    rhs = (make_cns_rhs(disc, **flags) if volume_impl is None
           else make_cns_rhs_affine(disc, volume_impl=volume_impl, **flags))
    qf, stats = dopri45(rhs, q0, t_end, becker_dt0(n, k), err_tol=err_tol)
    return {**becker_errors(disc, qf, shock, t_end),
            "n_accepted": int(stats["n_accepted"])}
