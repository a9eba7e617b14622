"""Fused modal volume stage (K3) of the affine CNS / Euler RHS on lines,
tris and hexes.

Port of ``esdg_cns_tpu/ops/pallas_modal_volume.py``:
``euler_modal_volume`` (CUDA ``csrc/modal_volume.cuh``, entry
``csrc/tri_modal_volume.cu``, one source per dim) replaces
``_modal_volume_kernel`` / ``euler_modal_volume_pallas``.  Per element:
Uq = Vq U, v(Uq), the hybridized projection and U(v_h) at the Nh points,
flux variables and logs, skew EC flux differencing, Ph QF.

The kernel takes its operators as lists (``modal_lists``): each row's
entries above roundoff, the flux differencing's (``csrc/dense_fd.cuh``
``list_fd_row``) a partner list with the Q_r entries of each partner.  On
lines and tris that is every entry; on the Gauss-collocated hex the
points of each row's node lines (672 pairs an element at N=3 where the
dense sum has 8,160), and Vq, Vh Pq and Ph the identity and one node line
per face point.  Affine metrics at dim 1, 2 and 3, curved tris.
``euler_modal_volume_plain`` is the same function in plain PyTorch, with
the dense operators and the dense all-pairs flux differencing
(``ops.flux_differencing``).  The
wrapper takes it only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
``euler_modal_volume.launches`` counts the launches and
``euler_modal_volume.forms`` the launches by dim and metric
(``dim2.affine``, ``dim2.curved``, ...); the launch call sits inside the
span ``ops.modal_volume.euler_modal_volume`` (``tracing.span``).  The TPU
``fd_mode`` variants ('tri', 'tri8', 'full') are layouts of one sum: the
port computes that sum once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..solvers.dg_ops import _apply
from ..tracing import span
from .flux_differencing import flux_differencing_xla
from .fused_volume import _DTYPE_CODE, _check_cuda, _check_shape, _raise_on


def euler_modal_volume_plain(q, geo, q_skew, vq, vhp, ph, gamma, *, nq):
    """Plain PyTorch fused modal volume stage; same contract as
    ``euler_modal_volume`` (any dim, affine or curved geo)."""
    nf = q.shape[0]
    gm1 = gamma - 1.0
    q_skew = tuple(q_skew)

    uq = _apply(vq, q)
    rho, e = uq[0], uq[nf - 1]
    mom = [uq[1 + d] for d in range(nf - 2)]
    p = gm1 * (e - 0.5 * sum(m * m for m in mom) / rho)
    s = torch.log(p) - gamma * torch.log(rho)
    v1 = (gamma + 1.0 - s) - gm1 * e / p
    vm = [gm1 * m / p for m in mom]
    ve = -gm1 * rho / p
    vu_q = torch.stack([v1, *vm, ve])

    hv = _apply(vhp, vu_q)
    hv1, hvm, hve = hv[0], [hv[1 + d] for d in range(nf - 2)], hv[nf - 1]
    vnorm = sum(v * v for v in hvm)
    sf = gamma - hv1 + vnorm / (2.0 * hve)
    rhoe = (gm1 / (-hve) ** gamma) ** (1.0 / gm1) * torch.exp(-sf / gm1)
    hrho = rhoe * (-hve)
    he = rhoe * (1.0 - vnorm / (2.0 * hve))
    hu = [v / (-hve) for v in hvm]
    hp = gm1 * (he - 0.5 * hrho * sum(u * u for u in hu))
    hbeta = hrho / (2.0 * hp)
    qh = torch.stack([hrho, *hu, hbeta])
    qlog = torch.stack([torch.log(hrho), torch.log(hbeta)])

    traces = torch.cat([qh[:, nq:], qlog[:, nq:]], dim=0)
    ph_qf = _apply(ph, flux_differencing_xla(qh, qlog, q_skew, geo, gamma))
    return ph_qf.contiguous(), traces, vu_q


# an operator entry is needed above this share of the operator's largest
# (the rule of the hex line operators' roundoff, chip_smoke.py entries())
ROUNDOFF = 1e-12


@dataclasses.dataclass(frozen=True)
class ModalLists:
    """K3's operators by rows: idx (int32) holds the row pointers of Q
    (nh + 1), Vq (nq + 1), Vh Pq (nh + 1) and Ph (np + 1), then each
    list's columns in that order; vals holds Q's entries (dim a partner,
    Q_r[i, j] for r = 0..dim-1), then Vq's, Vh Pq's and Ph's."""
    idx: torch.Tensor
    vals: torch.Tensor
    pairs: int          # Q's ordered partners (each pair from both sides)


def partner_mask(q_skew, nq):
    """[nh, nh] bool: the pairs (i, j) with an entry of some Q_r above
    ROUNDOFF of the largest, the zero diagonal and face-face block left
    out (the rule of chip_smoke.py's needed_pairs)."""
    a = np.abs(np.asarray(q_skew, dtype=np.float64))
    nz = (a > ROUNDOFF * a.max()).any(0)
    nz[nq:, nq:] = False
    np.fill_diagonal(nz, False)
    return nz


def _rows(mask):
    """(row pointers, columns) of a [rows, cols] bool mask, columns
    ascending within each row."""
    rp = np.concatenate([[0], np.cumsum(mask.sum(1))])
    return rp, np.nonzero(mask)[1]


def modal_lists(q_skew, vq, vhp, ph, nq) -> ModalLists:
    """The lists of K3's operators on their device and in their dtype.
    Built on the host once per discretization (``make_cns_rhs_affine``
    builds it with the RHS); q_skew [dim, nh, nh] or a tuple of dim
    [nh, nh]."""
    qs = q_skew if torch.is_tensor(q_skew) else torch.stack(tuple(q_skew))
    qn = qs.detach().cpu().double().numpy()
    mask = partner_mask(qn, nq)
    rp_q, c_q = _rows(mask)
    i_q = np.repeat(np.arange(mask.shape[0]), np.diff(rp_q))
    parts_rp, parts_c, parts_v = [rp_q], [c_q], [qn[:, i_q, c_q].T.ravel()]
    for op in (vq, vhp, ph):
        a = op.detach().cpu().double().numpy()
        m = np.abs(a) > ROUNDOFF * np.abs(a).max()
        rp, cols = _rows(m)
        parts_rp.append(rp)
        parts_c.append(cols)
        parts_v.append(a[m])
    idx = np.concatenate(parts_rp + parts_c).astype(np.int32)
    vals = np.concatenate(parts_v)
    return ModalLists(
        torch.as_tensor(idx, device=qs.device),
        torch.as_tensor(vals, dtype=qs.dtype, device=qs.device),
        int(mask.sum()))


def euler_modal_volume(q, geo, q_skew, vq, vhp, ph, gamma, *, nq,
                       lists: ModalLists | None = None):
    """Fused modal volume stage.

    q [Nf, Np, K] conservative state; geo [dim*dim, 1, K] affine metric
    or [dim*dim, Nh, K] curved (pairwise-averaged in the sum); q_skew a
    [dim, Nh, Nh] tensor or a tuple of dim [Nh, Nh]; vq [Nq, Np];
    vhp [Nh, Nq]; ph [Np, Nh].  Returns (ph_qf [Nf, Np, K],
    traces [Nf + 2, Nfq, K] = (rho, u_1..d, beta, log rho, log beta) at
    the face points, vu_q [Nf, Nq, K] = v(Vq U)), Nf = dim + 2.  The
    CUDA kernel covers dim = 1, 2, 3 on affine geo and dim = 2 curved.
    lists: ``modal_lists`` of these operators, which the kernel reads
    (built here when not given: a host round trip each call); the plain
    version reads the dense operators.
    """
    if q.device.type == "cpu":
        return euler_modal_volume_plain(q, geo, q_skew, vq, vhp, ph, gamma,
                                        nq=nq)
    if q.device.type != "cuda":
        raise ValueError(f"euler_modal_volume: no kernel for device {q.device}")
    name = "euler_modal_volume"
    qs = q_skew if torch.is_tensor(q_skew) else torch.stack(tuple(q_skew))
    nf, np_, k = q.shape
    nh = vhp.shape[0]
    dim = nf - 2
    if dim not in (1, 2, 3):
        raise ValueError(f"{name}: {nf} fields (dim = 1, 2, 3 take 3, 4, 5)")
    curved = geo.shape[1] != 1
    if curved and dim != 2:
        raise NotImplementedError(f"{name}: the CUDA kernel takes a curved "
                                  "metric on tris (dim = 2) only")
    tensors = {"q": q, "geo": geo, "q_skew": qs, "vq": vq, "vhp": vhp,
               "ph": ph}
    _check_cuda(name, tensors, q.dtype, q.device)
    for key, shape in (("geo", (dim * dim, nh if curved else 1, k)),
                       ("q_skew", (dim, nh, nh)),
                       ("vq", (nq, np_)), ("vhp", (nh, nq)),
                       ("ph", (np_, nh))):
        _check_shape(name, key, tensors[key], shape)
    if lists is None:
        lists = modal_lists(qs, vq, vhp, ph, nq)
    _check_cuda(name, {"lists.vals": lists.vals}, q.dtype, q.device)
    if (lists.idx.dtype != torch.int32 or lists.idx.device != q.device
            or not lists.idx.is_contiguous()
            or lists.idx.numel() < 2 * nh + nq + np_ + 4):
        raise ValueError(f"{name}: lists.idx must be a contiguous int32 "
                         f"tensor on {q.device} (modal_lists)")
    out = torch.empty((nf, np_, k), dtype=q.dtype, device=q.device)
    traces = torch.empty((nf + 2, nh - nq, k), dtype=q.dtype, device=q.device)
    vu_q = torch.empty((nf, nq, k), dtype=q.dtype, device=q.device)
    if k == 0:
        return out, traces, vu_q
    from ..kernels import library

    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with span("ops.modal_volume.euler_modal_volume"):
            rc = lib.esdg_modal_volume(
                _DTYPE_CODE[q.dtype], dim, int(curved), q.data_ptr(),
                geo.data_ptr(), lists.idx.data_ptr(), lists.vals.data_ptr(),
                out.data_ptr(), traces.data_ptr(), vu_q.data_ptr(), k, np_,
                nq, nh, lists.idx.numel(), lists.vals.numel(), float(gamma),
                stream)
    _raise_on(name, rc, "the element tile does not fit in shared memory")
    euler_modal_volume.launches += 1
    euler_modal_volume.forms[
        f"dim{dim}.{'curved' if curved else 'affine'}"] += 1
    return out, traces, vu_q


euler_modal_volume.launches = 0
# launches by dim and metric: the forms the kernel is built for
euler_modal_volume.forms = {"dim1.affine": 0, "dim2.affine": 0,
                            "dim2.curved": 0, "dim3.affine": 0}


def euler_modal_volume_shape(dtype, dim, curved, np_, nq, nh, lists):
    """(K3's launch shape at these sizes (``fused_volume.launch_shape``),
    whether its lists are read from global memory)."""
    from .fused_volume import launch_shape

    occ = launch_shape("esdg_modal_volume_shape", _DTYPE_CODE[dtype], dim,
                       int(curved), np_, nq, nh, lists.idx.numel(),
                       lists.vals.numel())
    return occ[:6], bool(occ[6])
