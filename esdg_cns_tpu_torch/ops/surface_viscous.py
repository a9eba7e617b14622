"""Merged surface + viscous stage (K4) and the viscous mid-section (K7) of
the affine CNS RHS.

Port of ``esdg_cns_tpu/ops/pallas_viscous.py``:

  * ``cns_surface_viscous`` (K4, CUDA ``csrc/cns_surface_viscous.cu``)
    replaces ``_surface_viscous_kernel`` / ``cns_surface_viscous_pallas``:
    after the trace exchange, per element, the conservative and entropy
    traces rebuilt from the flux-variable payload, the surface section of
    ``ops.cns_surface`` (BC ghosts, EC face flux + LF, entropy BC and BR1
    jump, interface penalty), then the viscous mid-section; with
    ``fold_tail`` also the flux/penalty LIFTs and the 1/J assembly
    against ``ph_qf``;
  * ``cns_viscous`` (K7, CUDA ``csrc/cns_viscous.cu``) replaces
    ``_viscous_kernel`` / ``cns_viscous_pallas``: the viscous mid-section
    alone, on the jump ``dv`` of the separate surface stage (K8).

The mid-section (``_viscous_body``): the front product, gradients,
sigma = K(v) grad(v), the traction (normal-contracted, or per direction),
the divergence and the per-element entropy production.  ``proj`` selects
the front operator's form: True (modal tris) = [Vq Pq; Vq D_r Pq], and
the kernel emits the projected entropy variables; False (collocated
hexes, where Vq = Pq = I) = the gradient rows [Vq D_r Pq] only, and the
returned vuq IS the input v(U).

On hexes (dim 3) the kernels read the operators as lists
(``visc_lists``): each row's entries above roundoff, padded to the
longest row of its operator.  The Gauss-collocated hex operators couple a
point only to its node lines, so at N=3 the five hold 2,752 entries
(2,688 without the projection block) of 47,104 (43,008), and every row of
one operator the same count (4 or 6): fixed-width rows cost no padding
there and need no row pointers, so the kernel finds row i at a fixed
stride.  The lists sit in shared memory beside the element tile (16,512
bytes in f32 at N=3 with 16-bit columns; read from global memory where
they pass 32 KB, as at N=5).  On lines and tris the operators are full
and the kernels keep their dense loops.

Each wrapper has its plain PyTorch version beside it (``*_plain``), on
the very same BC hooks and the dense operators; the wrapper takes it only
for CPU tensors, and for CUDA tensors launches its kernel or raises.
``.launches`` counts the launches; K4's ``cns_surface_viscous.forms``
counts them by dim, front and tail (``dim2.proj.fold_tail``,
``dim3.no_proj.fold_tail``, ...), and its launch call sits inside the
span ``ops.surface_viscous.cns_surface_viscous`` (``tracing.span``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..physics.viscous import viscous_flux_nd
from ..solvers._shared import entropy_vars_from_flux, flux_to_conservative
from ..solvers.dg_ops import _apply
from ..tracing import span
from .cns_surface import _surface_body
from .cns_surface_bc import recipe_rows, region_table
from .fused_volume import (_DTYPE_CODE, _check_cuda, _check_shape, _raise_on,
                           launch_shape)
from .modal_volume import ROUNDOFF

# the (dim, proj) forms the CUDA kernels are built for: the modal front
# (proj, K3's) on lines, tris and hexes, and the collocated-hex front (K1's)
_CUDA_FORMS = ((1, True), (2, True), (3, True), (3, False))


def _viscous_body(vu, dv, geo, nxj, invj, wjq, front, vqlift, ef, drpq, *,
                  dim, nq, gamma, mu, lam, pr, proj=True, contract=True):
    """The viscous mid-section on whole tensors; returns (s_f, div,
    prod [1, K], vuq) with s_f the contracted traction [Nf, Nfq, K]
    (contract) or the component stress traces [dim Nf, Nfq, K]."""
    nf = dim + 2
    fr = _apply(front, vu)                   # [Nf, (proj + dim) Nq, K]
    off = nq if proj else 0
    vuq = fr[:, :nq] if proj else vu
    vqd = [fr[:, off + r * nq:off + (r + 1) * nq] for r in range(dim)]

    grads = []
    for x in range(dim):
        surf = _apply(vqlift, 0.5 * dv * nxj[x][None])
        vol = None
        for r in range(dim):
            term = geo[r * dim + x] * vqd[r]
            vol = term if vol is None else vol + term
        grads.append((vol + surf) * invj)

    sigma = viscous_flux_nd(vuq, grads, mu, lam, pr, gamma)

    if contract:
        s_f = None
        for x in range(dim):
            term = _apply(ef, sigma[x]) * nxj[x][None]
            s_f = term if s_f is None else s_f + term
    else:
        s_f = torch.cat([_apply(ef, sigma[x]) for x in range(dim)])

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
    return s_f, div, prod, vuq


def _operator_shapes(nf, nq, nfq, np_, proj):
    """front, vqlift, ef, drpq as the kernels read them."""
    dim = nf - 2
    return {"front": ((proj + dim) * nq, nq), "vqlift": (nq, nfq),
            "ef": (nfq, nq), "drpq": (dim, np_, nq)}


# -----------------------------------------------------------------------------
# the operator lists of the hex kernels
# -----------------------------------------------------------------------------

# the lists, in order: Vq Pq (the projection block, proj only), the
# gradient rows Vq D_r Pq, Vq LIFT, Ef, D_r Pq and LIFT (K4's fold_tail)
VISC_LISTS = ("vqpq", "grad", "vqlift", "ef", "drpq", "lift")


@dataclasses.dataclass(frozen=True)
class ViscLists:
    """The viscous operators by padded rows, as ``csrc/cns_stages.cuh``
    (``ViscListLayout``) reads them: list l of VISC_LISTS is [rows][w_l]
    slots, its rows after the previous list's; a row's entries above
    roundoff in ascending column order, then zero values (their columns any
    of the row's) up to w_l.  vals in the operators' dtype, cols int16."""
    vals: torch.Tensor
    cols: torch.Tensor
    widths: tuple       # w_l, slots a row of each list (0: absent)
    entries: int        # the entries kept, pads not counted


def _padded_rows(a):
    """(columns, values) [rows, w] of the operator a [rows, cols]: each
    row's entries above ROUNDOFF of the largest, columns ascending, padded
    with zero values; and the count kept."""
    a_np = a.detach().cpu().numpy()
    mag = np.abs(a_np.astype(np.float64))
    keep = mag > ROUNDOFF * mag.max()
    w = int(keep.sum(1).max())
    # kept columns first, each group in ascending order
    order = np.argsort(~keep, axis=1, kind="stable")[:, :w]
    kept = np.take_along_axis(keep, order, 1)
    vals = np.where(kept, np.take_along_axis(a_np, order, 1), 0)
    return order, vals.astype(a_np.dtype), int(keep.sum())


def visc_lists(front, vqlift, ef, drpq, lift=None, *, nq, proj=True):
    """The lists of the viscous operators (``ViscLists``) on their device
    and in their dtype, built on the host once per discretization
    (``make_cns_rhs_affine`` builds them with the RHS): front [(proj + dim)
    Nq, Nq], vqlift [Nq, Nfq], ef [Nfq, Nq], drpq [dim, Np, Nq] and, for
    K4's fold_tail, lift [Np, Nfq]."""
    ops = (front[:nq] if proj else None, front[nq:] if proj else front,
           vqlift, ef, drpq.reshape(-1, drpq.shape[-1]), lift)
    cols, vals, widths, entries = [], [], [], 0
    for op in ops:
        if op is None:
            widths.append(0)
            continue
        c, v, n = _padded_rows(op)
        cols.append(c.ravel())
        vals.append(v.ravel())
        widths.append(c.shape[1])
        entries += n
    cols = np.concatenate(cols)
    if cols.max() > np.iinfo(np.int16).max:
        raise ValueError("visc_lists: an operator wider than 16-bit columns")
    return ViscLists(
        torch.as_tensor(np.concatenate(vals), device=front.device),
        torch.as_tensor(cols.astype(np.int16), device=front.device),
        tuple(widths), entries)


def _list_rows(dim, np_, nq, nfq):
    """The rows of each list of VISC_LISTS."""
    return (nq, dim * nq, nq, nfq, dim * np_, np_)


def _check_lists(name, lists, dtype, device, dim, np_, nq, nfq, proj,
                 with_lift):
    _check_cuda(name, {"lists.vals": lists.vals}, dtype, device)
    if (lists.cols.dtype != torch.int16 or lists.cols.device != device
            or not lists.cols.is_contiguous()):
        raise ValueError(f"{name}: lists.cols must be a contiguous int16 "
                         f"tensor on {device} (visc_lists)")
    w = tuple(lists.widths)
    slots = (sum(r * wl for r, wl in zip(_list_rows(dim, np_, nq, nfq), w))
             if len(w) == len(VISC_LISTS) else -1)
    if (slots != lists.vals.numel() or slots != lists.cols.numel()
            or (w[0] > 0) != bool(proj) or (with_lift and w[5] == 0)):
        raise ValueError(
            f"{name}: lists (widths {w}, {lists.vals.numel()} slots) do not "
            f"fit dim={dim} Np={np_} Nq={nq} Nfq={nfq} proj={proj}"
            + (" with LIFT" if with_lift else "") + " (visc_lists)")


def _lists_args(lists, dim):
    """(values, columns, widths) as the C entries take them: the lists at
    dim 3, nothing below."""
    if dim != 3:
        return None, None, None
    return (lists.vals.data_ptr(), lists.cols.data_ptr(),
            (ctypes.c_int * len(VISC_LISTS))(*lists.widths))


def _check_form(name, dim, proj):
    if (dim, bool(proj)) not in _CUDA_FORMS:
        raise NotImplementedError(
            f"{name}: the CUDA kernel covers proj=True at dim = 1, 2, 3 and "
            f"proj=False (collocated hexes) at dim = 3, got dim={dim} "
            f"proj={proj}")


# -----------------------------------------------------------------------------
# K4: merged surface + viscous stage
# -----------------------------------------------------------------------------

def cns_surface_viscous_plain(vu_q, qm, qm_log, nbr, nxj, sj, inv_sj, pool,
                              geo, inv_j, wjq, front, vqlift, ef, drpq,
                              ph_qf=None, lift=None, *, gamma, mu, lam, pr,
                              re, nq, dissipation, with_penalty, recipe=None,
                              proj=True, fold_tail=False, lists=None):
    """Plain PyTorch merged surface + viscous stage; same contract as
    ``cns_surface_viscous`` (any dim), on the dense operators (lists is
    not read)."""
    nf = vu_q.shape[0]
    dim = nf - 2
    # local traces rebuilt pointwise, as the neighbour's are
    uf = flux_to_conservative(qm, gamma)
    vuf = entropy_vars_from_flux(qm, qm_log, gamma)
    flux, dv, pen = _surface_body(
        qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool, recipe, gamma=gamma,
        re=re, dissipation=dissipation, with_penalty=with_penalty)
    t_f, div, prod, vuq = _viscous_body(
        vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef, drpq, dim=dim,
        nq=nq, gamma=gamma, mu=mu, lam=lam, pr=pr, proj=proj)

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
                        dissipation, with_penalty, recipe=None, proj=True,
                        fold_tail=False, lists: ViscLists | None = None):
    """ONE kernel for the post-exchange surface stage and the viscous
    mid-section of the affine CNS path.

    vu_q [Nf, Nq, K] raw v(U) at quadrature; qm [Nf, Nfq, K] + qm_log
    [2, Nfq, K] local flux-variable traces; nbr [Nf+2, Nfq, K] the
    gathered (qp | qp_log); nxj [dim, Nfq, K]; sj / inv_sj [Nfq, K]; pool
    [L, Nfq, K] + recipe from ``cns_surface_bc.prepare_surface_bc``
    (Dirichlet evaluations already concatenated), or None; geo
    [dim*dim, 1, K]; inv_j [1, K]; wjq [Nq, K]; front [(proj+dim) Nq, Nq]
    (``solvers.cns_fused.composed_operators``); vqlift [Nq, Nfq]; ef
    [Nfq, Nq]; drpq [dim, Np, Nq].  lam None means the Stokes value
    -2/3 mu.

    Returns (flux, pen, t_f, div, prod, vuq) (pen None without
    with_penalty; vuq the input vu_q when proj=False), or with
    fold_tail=True, which also takes ph_qf [Nf, Np, K] and lift
    [Np, Nfq], (dq_part, t_f, prod, vuq) with dq = dq_part + LIFT(jump)/J
    left to the caller.  The CUDA kernel covers proj=True at dim = 1, 2,
    3 and proj=False at dim = 3.  lists: ``visc_lists`` of these
    operators (with lift for fold_tail), which the kernel reads at dim 3
    (built here when not given: a host round trip each call); the plain
    version and the dense kernels of dims 1 and 2 read the operators.
    """
    args = (vu_q, qm, qm_log, nbr, nxj, sj, inv_sj, pool, geo, inv_j, wjq,
            front, vqlift, ef, drpq, ph_qf, lift)
    kw = dict(gamma=gamma, mu=mu, lam=lam, pr=pr, re=re, nq=nq,
              dissipation=dissipation, with_penalty=with_penalty,
              recipe=recipe, proj=proj, fold_tail=fold_tail)
    if vu_q.device.type == "cpu":
        return cns_surface_viscous_plain(*args, **kw)
    if vu_q.device.type != "cuda":
        raise ValueError(f"cns_surface_viscous: no kernel for device "
                         f"{vu_q.device}")
    name = "cns_surface_viscous"
    nf, _, k = vu_q.shape
    dim = nf - 2
    _check_form(name, dim, proj)
    nfq = qm.shape[1]
    np_ = drpq.shape[1]
    tensors = {"vu_q": vu_q, "qm": qm, "qm_log": qm_log, "nbr": nbr,
               "nxj": nxj, "sj": sj, "inv_sj": inv_sj, "geo": geo,
               "inv_j": inv_j, "wjq": wjq, "front": front, "vqlift": vqlift,
               "ef": ef, "drpq": drpq}
    shapes = {"vu_q": (nf, nq, k), "qm": (nf, nfq, k),
              "qm_log": (2, nfq, k), "nbr": (nf + 2, nfq, k),
              "nxj": (dim, nfq, k), "sj": (nfq, k), "inv_sj": (nfq, k),
              "geo": (dim * dim, 1, k), "inv_j": (1, k), "wjq": (nq, k),
              **_operator_shapes(nf, nq, nfq, np_, proj)}
    if recipe is not None:
        tensors["pool"] = pool
        shapes["pool"] = (recipe_rows(recipe, nf), nfq, k)
    if fold_tail:
        tensors.update(ph_qf=ph_qf, lift=lift)
        shapes.update(ph_qf=(nf, np_, k), lift=(np_, nfq))
    _check_cuda(name, tensors, vu_q.dtype, vu_q.device)
    for key, t in tensors.items():
        _check_shape(name, key, t, shapes[key])
    if dim == 3:
        if lists is None:
            lists = visc_lists(front, vqlift, ef, drpq,
                               lift if fold_tail else None, nq=nq, proj=proj)
        _check_lists(name, lists, vu_q.dtype, vu_q.device, dim, np_, nq,
                     nfq, proj, fold_tail)

    new = lambda *shape: torch.empty(shape, dtype=vu_q.dtype,
                                     device=vu_q.device)
    flux = None if fold_tail else new(nf, nfq, k)
    pen = new(nf, nfq, k) if with_penalty and not fold_tail else None
    t_f, div, prod = new(nf, nfq, k), new(nf, np_, k), new(1, k)
    vuq = new(nf, nq, k) if proj else vu_q
    if k == 0:
        return ((div, t_f, prod, vuq) if fold_tail
                else (flux, pen, t_f, div, prod, vuq))
    from ..kernels import library, pointer_array

    itab, ftab = (None, None) if recipe is None else region_table(
        recipe, vu_q.device)
    lam_v = -2.0 / 3.0 * mu if lam is None else lam
    ins = pointer_array([vu_q, qm, qm_log, nbr, nxj, sj, inv_sj,
                         pool if recipe is not None else None, geo, inv_j,
                         wjq, front, vqlift, ef, drpq,
                         ph_qf if fold_tail else None,
                         lift if fold_tail else None])
    outs = pointer_array([flux, pen, t_f, div, prod,
                          vuq if proj else None])
    lib = library()
    with torch.cuda.device(vu_q.device):
        stream = torch.cuda.current_stream(vu_q.device).cuda_stream
        with span("ops.surface_viscous.cns_surface_viscous"):
            rc = lib.esdg_cns_surface_viscous(
                _DTYPE_CODE[vu_q.dtype], dim, int(proj), ins, outs,
                *_lists_args(lists, dim),
                None if itab is None else itab.data_ptr(),
                None if ftab is None else ftab.data_ptr(), k, np_, nq, nfq,
                float(gamma), float(mu), float(lam_v), float(pr), float(re),
                int(dissipation), int(with_penalty), int(fold_tail),
                int(recipe is not None), stream)
    _raise_on(name, rc, "the element tile does not fit in shared memory")
    cns_surface_viscous.launches += 1
    cns_surface_viscous.forms[
        f"dim{dim}.{'proj' if proj else 'no_proj'}."
        f"{'fold_tail' if fold_tail else 'unfolded'}"] += 1
    if fold_tail:
        return div, t_f, prod, vuq
    return flux, pen, t_f, div, prod, vuq


cns_surface_viscous.launches = 0
# launches by dim, front (proj: the modal front's [Vq Pq; Vq D_r Pq];
# no_proj: the collocated hex's gradient rows) and tail (fold_tail: the
# LIFTs and 1/J folded in), over the forms the kernel is built for
cns_surface_viscous.forms = {
    f"dim{d}.{'proj' if p else 'no_proj'}.{t}": 0
    for d, p in _CUDA_FORMS for t in ("fold_tail", "unfolded")}


# -----------------------------------------------------------------------------
# K7: the viscous mid-section alone
# -----------------------------------------------------------------------------

def cns_viscous_plain(vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef,
                      drpq, *, gamma, mu, lam, pr, nq, proj=True,
                      contract=False, lists=None):
    """Plain PyTorch viscous mid-section; same contract as
    ``cns_viscous`` (any dim, both contract forms), on the dense
    operators (lists is not read)."""
    return _viscous_body(vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef,
                         drpq, dim=vu_q.shape[0] - 2, nq=nq, gamma=gamma,
                         mu=mu, lam=lam, pr=pr, proj=proj, contract=contract)


def cns_viscous(vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef, drpq, *,
                gamma, mu, lam, pr, nq, proj=True, contract=False,
                lists: ViscLists | None = None):
    """ONE kernel for the viscous mid-section of the affine CNS path.

    vu_q [Nf, Nq, K] raw v(U) at quadrature; dv [Nf, Nfq, K] the
    BC-adjusted entropy jumps (``cns_surface``); geo [dim*dim, 1, K]; nxj
    [dim, Nfq, K]; inv_j [1, K]; wjq [Nq, K]; front [(proj+dim) Nq, Nq];
    vqlift [Nq, Nfq]; ef [Nfq, Nq]; drpq [dim, Np, Nq].

    Returns (s_f, div [Nf, Np, K], prod [1, K], vuq [Nf, Nq, K]) with s_f
    the normal-contracted traction t_f = sum_x (Ef sigma_x) nxj_x
    [Nf, Nfq, K] (contract=True) or the component stress traces
    [dim Nf, Nfq, K] (contract=False, rows x Nf + f = (Ef sigma_x)_f);
    vuq is the input vu_q when proj=False.  The CUDA kernel covers both
    contract forms, with proj=True at dim = 1, 2, 3 and proj=False at
    dim = 3.  lists: ``visc_lists`` of these operators, read at dim 3 as
    ``cns_surface_viscous`` reads them (LIFT's list not needed).
    """
    args = (vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef, drpq)
    kw = dict(gamma=gamma, mu=mu, lam=lam, pr=pr, nq=nq, proj=proj,
              contract=contract)
    if vu_q.device.type == "cpu":
        return cns_viscous_plain(*args, **kw)
    if vu_q.device.type != "cuda":
        raise ValueError(f"cns_viscous: no kernel for device {vu_q.device}")
    name = "cns_viscous"
    nf, _, k = vu_q.shape
    dim = nf - 2
    _check_form(name, dim, proj)
    nfq = dv.shape[1]
    np_ = drpq.shape[1]
    tensors = {"vu_q": vu_q, "dv": dv, "geo": geo, "nxj": nxj,
               "inv_j": inv_j, "wjq": wjq, "front": front,
               "vqlift": vqlift, "ef": ef, "drpq": drpq}
    shapes = {"vu_q": (nf, nq, k), "dv": (nf, nfq, k),
              "geo": (dim * dim, 1, k), "nxj": (dim, nfq, k),
              "inv_j": (1, k), "wjq": (nq, k),
              **_operator_shapes(nf, nq, nfq, np_, proj)}
    _check_cuda(name, tensors, vu_q.dtype, vu_q.device)
    for key, t in tensors.items():
        _check_shape(name, key, t, shapes[key])
    if dim == 3:
        if lists is None:
            lists = visc_lists(front, vqlift, ef, drpq, nq=nq, proj=proj)
        _check_lists(name, lists, vu_q.dtype, vu_q.device, dim, np_, nq,
                     nfq, proj, False)

    new = lambda *shape: torch.empty(shape, dtype=vu_q.dtype,
                                     device=vu_q.device)
    s_f = new(nf if contract else dim * nf, nfq, k)
    div, prod = new(nf, np_, k), new(1, k)
    vuq = new(nf, nq, k) if proj else vu_q
    if k == 0:
        return s_f, div, prod, vuq
    from ..kernels import library, pointer_array

    lam_v = -2.0 / 3.0 * mu if lam is None else lam
    ins = pointer_array([vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef,
                         drpq])
    outs = pointer_array([s_f, div, prod, vuq if proj else None])
    lib = library()
    with torch.cuda.device(vu_q.device):
        stream = torch.cuda.current_stream(vu_q.device).cuda_stream
        rc = lib.esdg_cns_viscous(
            _DTYPE_CODE[vu_q.dtype], dim, int(proj), int(contract), ins,
            outs, *_lists_args(lists, dim), k, np_, nq, nfq, float(gamma), float(mu), float(lam_v),
            float(pr), stream)
    _raise_on(name, rc, "the element tile does not fit in shared memory")
    cns_viscous.launches += 1
    return s_f, div, prod, vuq


cns_viscous.launches = 0


def viscous_shapes(dtype, dim, proj, np_, nq, nfq, lists=None):
    """{'K4' (fold_tail), 'K4 no tail', 'K7': (the launch shape
    (``fused_volume.launch_shape``), whether the operators or lists are
    read from global memory)} at these sizes; lists (dim 3) with LIFT's."""
    widths = (None if dim != 3 else
              (ctypes.c_int * len(VISC_LISTS))(*lists.widths))
    code = _DTYPE_CODE[dtype]
    out = {}
    for key, entry, args in (
            ("K4", "esdg_cns_surface_viscous_shape",
             (code, dim, int(proj), 1, np_, nq, nfq, widths)),
            ("K4 no tail", "esdg_cns_surface_viscous_shape",
             (code, dim, int(proj), 0, np_, nq, nfq, widths)),
            ("K7", "esdg_cns_viscous_shape",
             (code, dim, int(proj), np_, nq, nfq, widths))):
        occ = launch_shape(entry, *args)
        out[key] = (occ[:6], bool(occ[6]))
    return out
