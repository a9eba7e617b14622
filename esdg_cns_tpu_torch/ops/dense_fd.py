"""Dense skew flux differencing of any element type (K5).

Port of ``esdg_cns_tpu/ops/pallas_fd.py``: ``flux_differencing_dense``
(CUDA ``csrc/dense_fd.cu``) replaces ``_fd_kernel`` /
``flux_differencing_pallas``, the volume term of the plain RHS with
``flux_diff_impl='pallas'``.  It has the contract of
``ops.flux_differencing.flux_differencing_xla``:

    2 QF_i = 2 sum_j sum_x (sum_r Q_r[i, j] g_rx) F_x(q_i, q_j),

with g the element's affine metric or, on curved elements, the pairwise
average (g_i + g_j) / 2; the zero face-face block of the operators is
skipped (partners j >= nq of a face row i >= nq).

``flux_differencing_dense_plain`` is the same sum in plain PyTorch (the
dense all-pairs tensor form).  The wrapper takes it only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
``flux_differencing_dense.launches`` counts the launches.  The TPU
``fd_mode`` variants ('tri', 'tri8', 'full') are layouts of one sum: the
value is checked and the sum computed once.
"""

from __future__ import annotations

import torch

from .flux_differencing import flux_differencing_xla
from .fused_volume import _DTYPE_CODE, _check_cuda, _check_shape, _raise_on

FD_MODES = ("tri", "tri8", "full")


def _check_mode(fd_mode):
    if fd_mode not in FD_MODES:
        raise ValueError(f"unknown fd_mode: {fd_mode!r} (one of {FD_MODES})")


def flux_differencing_dense_plain(qh, qlog, q_skew, geo, gamma, *, nq,
                                  fd_mode="tri"):
    """Plain PyTorch version; same contract as ``flux_differencing_dense``
    (the zero face-face block contributes exact zeros, so nq is not
    needed here)."""
    del nq
    _check_mode(fd_mode)
    return flux_differencing_xla(qh, qlog, tuple(q_skew), geo, gamma)


def flux_differencing_dense(qh, qlog, q_skew, geo, gamma, *, nq,
                            fd_mode="tri"):
    """Dense skew flux differencing; returns 2 QF [Nf, Nh, K].

    qh [Nf, Nh, K] flux variables (rho, u_1..dim, beta), Nf = dim + 2;
    qlog [2, Nh, K] (log rho, log beta); q_skew a [dim, Nh, Nh] tensor or
    a tuple of dim [Nh, Nh]; geo [dim*dim, 1 | Nh, K]; nq the volume
    point count.  dim 1, 2 or 3.
    """
    _check_mode(fd_mode)
    if qh.device.type == "cpu":
        return flux_differencing_dense_plain(qh, qlog, q_skew, geo, gamma,
                                             nq=nq)
    if qh.device.type != "cuda":
        raise ValueError(f"flux_differencing_dense: no kernel for device "
                         f"{qh.device}")
    name = "flux_differencing_dense"
    qs = q_skew if torch.is_tensor(q_skew) else torch.stack(tuple(q_skew))
    nf, nh, k = qh.shape
    dim = qs.shape[0]
    if dim not in (1, 2, 3):
        raise ValueError(f"{name}: dim {dim} (1, 2 or 3)")
    curved = geo.shape[1] != 1
    tensors = {"qh": qh, "qlog": qlog, "q_skew": qs, "geo": geo}
    _check_cuda(name, tensors, qh.dtype, qh.device)
    for key, shape in (("qh", (dim + 2, nh, k)), ("qlog", (2, nh, k)),
                       ("q_skew", (dim, nh, nh)),
                       ("geo", (dim * dim, nh if curved else 1, k))):
        _check_shape(name, key, tensors[key], shape)
    out = torch.empty_like(qh)
    if k == 0:
        return out
    from ..kernels import library

    lib = library()
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = lib.esdg_dense_fd(
            _DTYPE_CODE[qh.dtype], dim, int(curved), qh.data_ptr(),
            qlog.data_ptr(), qs.data_ptr(), geo.data_ptr(), out.data_ptr(),
            k, nq, nh, float(gamma), stream)
    _raise_on(name, rc, "one element's tile does not fit in shared memory")
    flux_differencing_dense.launches += 1
    return out


flux_differencing_dense.launches = 0
