"""Fused ES-DG Euler RHS for collocated periodic hex meshes (main path).

Port of ``esdg_cns_tpu/solvers/euler_fused.make_euler_rhs_fused``: three
stages per RHS,

  1. the volume stage, by ``volume_mode``: K1
     ``ops.fused_volume.euler_volume`` (entropy projection, line-sparse EC
     flux differencing and Ph QF in one kernel; it writes ph_qf) or the
     split front ``ops.fused_volume.euler_volume_split_parts``
     (projection kernel, one fd kernel per direction; it writes the three
     direction parts); either writes the 7-row face traces;
  2. on meshes without ``grid_shape``, the face-trace exchange
     ``Discretization.gather_traces`` (one ``index_select``); on fully
     periodic uniform grids (every fused Euler preset) none: K2 reads
     each neighbour's traces itself;
  3. K2 ``ops.fused_volume.euler_surface``: EC interface flux, LF
     penalty, LIFT, the sum with ph_qf (or, after the split front, the
     split combine folded into its LIFT) and the 1/J scaling.

The TPU package's volume modes are resolved as it resolves them: the
joint modes ('joint', 'joint_pad8', 'joint_packed') are K1's math in
three TPU layouts and run K1; the split modes ('split', 'split_pad8',
'split_dense') run the split path, which 'auto' picks on affine meshes at
N = 7 (8 % (N+1) == 0, N+1 != 4).  N >= 6 without ``force_fused`` is
the plain lines path, as in JAX.  Semantics equal to
``make_euler_rhs(flux_diff_impl='lines')``, tested against it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fused_volume import (detect_axis_aligned, euler_surface,
                                euler_volume, euler_volume_split_parts)
from ..physics import euler as phys


def resolve_volume_mode(disc, volume_mode: str = "auto") -> str:
    """The TPU package's 'auto' rule (``euler_fused.py:105-121``): on affine
    meshes the packed joint kernel at misaligned orders (8 % (N+1) != 0)
    and at N+1 = 4, the split path at other N >= 4 (N = 7), else joint."""
    if volume_mode != "auto":
        return volume_mode
    n1 = disc.n + 1
    if disc.affine and (8 % n1 != 0 or n1 == 4):
        return "joint_packed"
    if disc.n >= 4 and disc.affine:
        return "split"
    return "joint"


def make_euler_rhs_fused(
    disc,
    *,
    gamma: float = phys.GAMMA,
    dissipation: bool = True,
    compute_rhstest: bool = False,
    rhstest_mode: str = "native",
    force_fused: bool = False,
    volume_mode: str = "auto",
    axis_aligned: Optional[bool] = None,
):
    """Build the fused RHS; requires a collocated hex discretization.

    volume_mode: 'auto' (``resolve_volume_mode``), 'joint', 'joint_pad8',
    'joint_packed' (K1), 'split', 'split_pad8' (the split path, diag on
    axis-aligned meshes) or 'split_dense' (the split path's dense fd).
    force_fused: at N >= 6 this function returns the plain
    ``make_euler_rhs(flux_diff_impl='lines')`` unless this is set, and
    refuses ``axis_aligned`` and a named ``volume_mode`` there, which that
    path would ignore.
    axis_aligned: on uniform/cartesian meshes the metric is diagonal and
    each face group's normal has one nonzero component, so the kernels
    skip the cross-direction flux assembly and contraction terms.  None
    detects it here (host-side).

    Returns rhs(q, t) -> (dq/dt [5, Nq, K], aux dict, with 'rhstest' if
    compute_rhstest).
    """
    if disc.elem_type != "hex" or disc.line_ops is None:
        raise ValueError("fused RHS requires a collocated hex mesh")
    if disc.n >= 6 and not force_fused:
        # the fallback must not silently drop the flags it ignores
        dropped = {"axis_aligned": axis_aligned,
                   "volume_mode": None if volume_mode == "auto"
                   else volume_mode}
        set_flags = [k for k, v in dropped.items() if v is not None]
        if set_flags:
            raise ValueError(
                f"N={disc.n} >= 6 falls back to the XLA lines path, "
                f"which ignores {set_flags}; drop these arguments, use "
                f"make_euler_rhs directly, or pass force_fused=True")
        from .euler import make_euler_rhs

        return make_euler_rhs(disc, gamma=gamma, dissipation=dissipation,
                              flux_diff_impl="lines",
                              compute_rhstest=compute_rhstest,
                              rhstest_mode=rhstest_mode)
    nq = disc.nq
    ef = disc.vhp[nq:]
    if axis_aligned is None:
        axis_aligned = detect_axis_aligned(disc)
    mode = resolve_volume_mode(disc, volume_mode)
    # the split modes run the split front, the joint ones (and an unknown
    # name, as in the TPU package) K1
    split = mode in ("split", "split_pad8", "split_dense")
    split_kw = dict(dense=mode == "split_dense", diag=axis_aligned,
                    pad_x=mode == "split_pad8")
    # on a fully periodic uniform grid K2 finds the neighbours itself
    grid = disc.grid_shape

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
        ph_qf = parts = None
        if split:
            parts, traces = euler_volume_split_parts(
                q, disc.geo, ef, gamma, line_ops=disc.line_ops, **split_kw)
        else:
            ph_qf, traces = euler_volume(q, disc.geo, ef, disc.lift, gamma,
                                         line_ops=disc.line_ops,
                                         diag=axis_aligned)
        nbr = None if grid is not None else disc.gather_traces(traces)
        rhs_q = euler_surface(traces, nbr, nxj, disc.sj, disc.inv_sj,
                              inv_jac, disc.lift, ph_qf, gamma,
                              dissipation=dissipation, diag=axis_aligned,
                              grid=grid, parts=parts, line_ops=disc.line_ops)
        aux = {}
        if compute_rhstest:
            from ..utils.compensated import weighted_entropy_residual

            vu = phys.v_ufun(q, gamma)  # collocated: Vq = I
            aux["rhstest"] = weighted_entropy_residual(disc.wjq, vu, rhs_q,
                                                       rhstest_mode)
        return rhs_q, aux

    return rhs
