"""Fused ES-DG Euler RHS for collocated periodic hex meshes (main path).

Port of ``esdg_cns_tpu/solvers/euler_fused.make_euler_rhs_fused``: three
stages per RHS,

  1. K1 ``ops.fused_volume.euler_volume``: entropy projection, line-sparse
     EC flux differencing and Ph QF; writes ph_qf and the 7-row face
     traces;
  2. the face-trace exchange ``Discretization.gather_traces`` (flat rolls
     on the periodic grid, plain tensor ops);
  3. K2 ``ops.fused_volume.euler_surface``: EC interface flux, LF
     penalty, LIFT, the sum with ph_qf and the 1/J scaling.

Only the semantics every TPU ``volume_mode`` shares are ported (the
packed, pad8 and split modes are TPU layouts).  Semantics equal to
``make_euler_rhs(flux_diff_impl='lines')``, tested against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fused_volume import detect_axis_aligned, euler_surface, euler_volume
from ..physics import euler as phys


def make_euler_rhs_fused(
    disc,
    *,
    gamma: float = phys.GAMMA,
    dissipation: bool = True,
    compute_rhstest: bool = False,
    rhstest_mode: str = "native",
    axis_aligned: Optional[bool] = None,
):
    """Build the fused RHS; requires a collocated hex discretization.

    axis_aligned: on uniform/cartesian meshes the metric is diagonal and
    each face group's normal has one nonzero component, so the kernels
    skip the cross-direction flux assembly and contraction terms.  None
    detects it here (host-side).

    Returns rhs(q, t) -> (dq/dt [5, Nq, K], aux dict, with 'rhstest' if
    compute_rhstest).
    """
    if disc.elem_type != "hex" or disc.line_ops is None:
        raise ValueError("fused RHS requires a collocated hex mesh")
    nq = disc.nq
    ef = disc.vhp[nq:]
    if axis_aligned is None:
        axis_aligned = detect_axis_aligned(disc)

    if axis_aligned:
        # compact one-row normal: each face point's single nonzero
        # component (the others are snapped exact zeros); the surface
        # kernel derives sj = |nxj| and 1/sj itself
        nxj = (disc.nxj[0] + disc.nxj[1] + disc.nxj[2])[None]
        inv_jac = disc.inv_jac[:1]
    else:
        nxj = torch.stack(disc.nxj)
        inv_jac = disc.inv_jac

    def rhs(q, t: float = 0.0):
        del t
        ph_qf, traces = euler_volume(q, disc.geo, ef, disc.lift, gamma,
                                     line_ops=disc.line_ops,
                                     diag=axis_aligned)
        nbr = disc.gather_traces(traces)
        rhs_q = euler_surface(traces, nbr, nxj, disc.sj, disc.inv_sj,
                              inv_jac, disc.lift, ph_qf, gamma,
                              dissipation=dissipation, diag=axis_aligned)
        aux = {}
        if compute_rhstest:
            from ..utils.compensated import weighted_entropy_residual

            vu = phys.v_ufun(q, gamma)  # collocated: Vq = I
            aux["rhstest"] = weighted_entropy_residual(disc.wjq, vu, rhs_q,
                                                       rhstest_mode)
        return rhs_q, aux

    return rhs
