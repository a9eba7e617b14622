"""The tail of the merged CNS RHS on collocated hexes, as one kernel.

After K4's ``fold_tail`` form (``ops.surface_viscous.cns_surface_viscous``)
the RHS still needs the neighbours' normal traction, the wall rule of
``WallBC.stress_normal``, the jump's LIFT and the 1/J scaling:

    dq = dq_part + LIFT (0.5 (t_pn - t_f)) (1/J).

``cns_traction_tail`` (CUDA ``csrc/cns_tail.cu``) computes that in one
pass, reading each neighbour's traction itself through a per-face-point
code (``traction_rule``), so the second exchange of the traction leaves
the stage.  It replaces no TPU kernel: the TPU package's tail is jnp,
which XLA fuses, while in PyTorch it is an ``index_select``, ten
elementwise kernels and a GEMM.  The kernel is built for N+1 = 2..8 and
reads LIFT over each volume node's three lines (``common.cuh``'s
``lift_lines``), as K2 does.

``traction_rule`` covers interior faces, natural ones (boundary faces of
no region, isothermal walls, Dirichlet regions without ghost stresses)
and adiabatic walls; a slip region or a Dirichlet ``stress_state`` has no
code, and the caller passes the plain ``t_pn`` instead.
``cns_traction_tail_plain`` is the plain version: on the rule it repeats
``neighbor_traction``'s arithmetic point by point, so it equals the
exchange and ``stress_normal`` bitwise.  ``cns_traction_tail.launches``
counts the launches and ``cns_traction_tail.forms`` the calls by form
(``kernel``, ``plain``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..solvers.dg_ops import _apply
from .fused_volume import _DTYPE_CODE, _check_cuda, _check_shape, _raise_on

NATURAL = -1
"""The code of a natural face point: t_pn = t_f, a zero jump."""


class TractionRule(NamedTuple):
    """The neighbour traction's rule per face point.

    code: int32 [Nfq, K]; >= 0 an interior point, the neighbour's flat
    index node * K + element (``Discretization.map_p``); ``NATURAL``; or
    -2 - j an adiabatic point whose 2 u_wall is row j of wall.
    wall: [R, 3] in the state's dtype, 2 u_wall per row: one row a region
    whose u_wall is three scalars, one a face point where it holds arrays.
    """

    code: torch.Tensor
    wall: torch.Tensor


def traction_rule(disc, bc) -> Optional[TractionRule]:
    """The ``TractionRule`` of a 3D discretization and its WallBC (None:
    no BC), the regions applied in order as ``WallBC.stress_normal``
    applies them (a later region takes the points it shares); None when a
    region is slip or Dirichlet with ``stress_state``, which have no code.
    """
    code = torch.where(disc.bmask, torch.full_like(disc.map_p, NATURAL),
                       disc.map_p)
    dtype = disc.nxj[0].dtype
    rows = []
    for r in bc.regions if bc is not None else ():
        mask = torch.as_tensor(r.mask, device=code.device)
        if r.kind == "isothermal" or (r.kind == "dirichlet"
                                      and r.stress_state is None):
            code = torch.where(mask, NATURAL, code)
            continue
        if r.kind != "adiabatic":
            return None
        u = list(r.u_wall) + [0.0] * (3 - len(r.u_wall))
        if all(isinstance(c, (int, float)) for c in u):
            w = torch.tensor([[2.0 * float(c) for c in u]], dtype=dtype,
                             device=code.device)
        else:
            n = int(mask.sum())
            w = torch.stack([
                torch.full((n,), 2.0 * float(c), dtype=dtype,
                           device=code.device)
                if isinstance(c, (int, float))
                else 2.0 * torch.as_tensor(c, device=code.device)
                .to(dtype).expand(mask.shape)[mask] for c in u], dim=1)
        first = sum(len(x) for x in rows)
        rows.append(w)
        ids = torch.full_like(code, -2 - first)
        if len(w) > 1:
            ids[mask] = -2 - first - torch.arange(
                len(w), dtype=code.dtype, device=code.device)
        code = torch.where(mask, ids, code)
    wall = (torch.cat(rows) if rows
            else torch.zeros((0, 3), dtype=dtype, device=code.device))
    return TractionRule(code.contiguous(), wall.contiguous())


def rule_traction(t_f, rule: TractionRule):
    """The neighbour traction t_pn [5, Nfq, K] of ``rule``, with
    ``neighbor_traction``'s expressions at each point."""
    code = rule.code
    nf = t_f.shape[0]
    t_ex = t_f.reshape(nf, -1)[:, code.clamp(min=0).reshape(-1)].reshape(
        t_f.shape)
    t_pn = torch.where(code[None] >= 0, -t_ex, t_f)
    if rule.wall.shape[0] == 0:
        return t_pn
    w = rule.wall[(-2 - code).clamp(min=0)]          # [Nfq, K, 3]
    work = sum(w[..., d] * t_f[1 + d] for d in range(3))
    energy = torch.where(code <= -2, -t_f[4] + work, t_pn[4])
    return torch.cat([t_pn[:4], energy[None]])


def cns_traction_tail_plain(dq_part, t_f, lift, inv_j, *, rule=None,
                            t_pn=None):
    """dq_part + LIFT (0.5 (t_pn - t_f)) (1/J) by PyTorch expressions, t_pn
    given or from ``rule`` (``rule_traction``)."""
    if t_pn is None:
        t_pn = rule_traction(t_f, rule)
    jump_n = 0.5 * (t_pn - t_f)
    return dq_part + _apply(lift, jump_n) * inv_j[None]


def cns_traction_tail(dq_part, t_f, lift, inv_j, *, rule=None, t_pn=None):
    """The RHS after K4's fold_tail form: dq [5, Nq, K].

    dq_part [5, Nq, K] (K4's, overwritten by dq where the kernel runs);
    t_f [5, Nfq, K] the normal-contracted traction; lift [Nq, Nfq];
    inv_j [1, K].  Give one of rule (a ``TractionRule``: the kernel on
    CUDA tensors, ``cns_traction_tail_plain`` on CPU ones) and t_pn
    [5, Nfq, K], the neighbour traction computed by the caller (the plain
    lines on any device).
    """
    if (rule is None) == (t_pn is None):
        raise ValueError("cns_traction_tail: give one of rule and t_pn")
    if rule is None or dq_part.device.type == "cpu":
        cns_traction_tail.forms["plain"] += 1
        return cns_traction_tail_plain(dq_part, t_f, lift, inv_j, rule=rule,
                                       t_pn=t_pn)
    name = "cns_traction_tail"
    nf, nq, k = dq_part.shape
    nfq = t_f.shape[1]
    n1 = round(nq ** (1 / 3))
    if n1 ** 3 != nq or nfq != 6 * n1 * n1:
        raise ValueError(f"{name}: {nq} volume and {nfq} face points are "
                         "not a collocated hex's")
    _check_cuda(name, {"dq_part": dq_part, "t_f": t_f, "lift": lift,
                       "inv_j": inv_j, "wall": rule.wall},
                dq_part.dtype, dq_part.device)
    for key, t, shape in (("dq_part", dq_part, (5, nq, k)),
                          ("t_f", t_f, (5, nfq, k)),
                          ("lift", lift, (nq, nfq)), ("inv_j", inv_j, (1, k)),
                          ("code", rule.code, (nfq, k)),
                          ("wall", rule.wall, (rule.wall.shape[0], 3))):
        _check_shape(name, key, t, shape)
    code = rule.code
    if (code.dtype != torch.int32 or code.device != dq_part.device
            or not code.is_contiguous()):
        raise TypeError(f"{name}: code must be contiguous int32 on "
                        f"{dq_part.device}")
    if k == 0:
        return dq_part
    from ..kernels import library, pointer_array

    ptrs = pointer_array([dq_part, t_f, code, rule.wall, lift, inv_j])
    with torch.cuda.device(dq_part.device):
        stream = torch.cuda.current_stream(dq_part.device).cuda_stream
        rc = library().esdg_cns_tail(_DTYPE_CODE[dq_part.dtype], n1, ptrs, k,
                                     stream)
    _raise_on(name, rc, "no kernel for this polynomial degree (N = 1..7 are "
              "built)")
    cns_traction_tail.launches += 1
    cns_traction_tail.forms["kernel"] += 1
    return dq_part


cns_traction_tail.launches = 0
# calls by form: the kernel, or the plain lines (CPU tensors, or a t_pn
# the caller computed)
cns_traction_tail.forms = {"kernel": 0, "plain": 0}


def cns_traction_tail_shape(dtype, n1):
    """The kernel's launch shape at line length n1
    (``fused_volume.launch_shape``)."""
    from .fused_volume import launch_shape

    return launch_shape("esdg_cns_tail_shape", _DTYPE_CODE[dtype], n1)
