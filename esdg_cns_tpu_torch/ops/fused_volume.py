"""Fused volume (K1), split volume (rows 3, 4) and surface (K2) stages of
the collocated-hex Euler RHS.

Port of the hex kernels of ``esdg_cns_tpu/ops/pallas_volume.py``:

  * ``euler_volume`` (K1, CUDA ``csrc/hex_volume.cu``) replaces
    ``_volume_kernel`` / ``euler_volume_pallas``;
  * ``euler_volume_split`` replaces ``euler_volume_split_pallas``: the
    projection ``hex_project`` (row 3, ``_proj_kernel``), one
    flux-differencing launch per direction, ``hex_fd_dir`` (row 4a,
    ``_fd_dir_kernel`` / ``_fd_dir_pad8_kernel``) or ``hex_fd_dir_dense``
    (row 4b, ``_fd_dir_dense_kernel`` / ``_fd_dir_dense_chunked_kernel``),
    all CUDA ``csrc/hex_split.cu``, then a plain-tensor combine
    (``split_combine``), as the TPU package's is XLA;
    ``euler_volume_split_parts`` stops before the combine;
  * ``euler_surface`` (K2, CUDA ``csrc/hex_surface.cu``) replaces
    ``_surface_kernel`` / ``euler_surface_pallas``; on a fully periodic
    uniform grid it reads each neighbour's traces itself (the exchange's
    rolls leave the stage), and after the split front it takes the three
    direction parts and folds the combine into its LIFT.

Each wrapper has a plain PyTorch version beside it (``*_plain``).  The
wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute (``euler_volume.launches``), bumped only where the
kernel is launched; K1 and K2 count them by form besides
(``euler_volume.forms``, ``euler_surface.forms``), and K1 the launches
that wrote v(U) (``euler_volume.with_v``).  The launch calls of
K1, K2 and the projection sit inside a span named by the wrapper
(``ops.fused_volume.euler_volume``; ``tracing.span``).

The TPU kernels' lane blocking, sublane padding and packed folds are
layouts, not math: the port keeps the math.  The CUDA kernels cover
affine meshes (diagonal and general metric) and curved ones: K1 with the
metric at every hybridized point (geo [9, Nh, K], pairwise-averaged in
the line loop, ``csrc/line_fd.cuh``), K2 with per-point normals, sj and
1/J (its general form).  K1 keeps an element's flux variables in shared
memory and runs one thread per (element, direction, line), the three
directions at once (``csrc/line_fd.cuh``); it is built, as K2 and the
split path (affine only; the fd spreads each line's pairs over its
nodes' threads, ``fd_pair_schedule``) are, for N = 1..7.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.discretization import grid_neighbours
from ..physics.euler import ec_flux_fields, v_ufun
from ..tracing import span
from .tensor_product_fd import (LineOps, _dir_layout, _hex_line_coeffs,
                                flux_differencing_lines)

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def detect_axis_aligned(disc, tol: float = 1e-9) -> bool:
    """True when the hex discretization's metric is diagonal and every
    face-group normal has a single nonzero component (uniform/cartesian
    meshes).

    Host-side, when the RHS is constructed.  tol matches the setup-time
    snap gate (core.discretization._snap, 1e-9 relative; the curl-form noise is
    absolute, so its RELATIVE size grows with k1d — 1e-11 failed at the
    k1d=32 mesh): any off-axis entry the snap left alone fails detection,
    so a detected-aligned mesh carries EXACT zeros in the entries the
    diag kernels statically drop, and the specialization is never an
    approximation.
    """
    if disc.elem_type != "hex" or disc.line_ops is None:
        return False
    geo = disc.geo.detach().cpu().numpy()
    if geo.shape[1] != 1:        # curved
        return False
    scale = np.abs(geo).max()
    for d in range(3):
        for x in range(3):
            if x != d and np.abs(geo[d * 3 + x]).max() > tol * scale:
                return False
    nxj = np.stack([a.detach().cpu().numpy() for a in disc.nxj])
    nfp = nxj.shape[1] // 6
    nscale = np.abs(nxj).max()
    for fid in range(6):
        d = fid // 2
        rows = slice(fid * nfp, (fid + 1) * nfp)
        for x in range(3):
            if x != d and np.abs(nxj[x, rows]).max() > tol * nscale:
                return False
    return True


def _inv_weights(line_ops: LineOps):
    """(1/wq [Nq], 1/wface [Nfp]) from the 1D weights."""
    n1 = line_ops.n1d
    w1 = np.asarray(line_ops.w1)
    idx = np.arange(n1 ** 3)
    wq = w1[idx % n1] * w1[(idx // n1) % n1] * w1[idx // (n1 * n1)]
    fidx = np.arange(n1 * n1)
    wf = w1[fidx % n1] * w1[fidx // n1]
    return 1.0 / wq, 1.0 / wf


@functools.lru_cache(maxsize=16)
def _volume_consts(line_ops: LineOps, dtype: torch.dtype, device: torch.device):
    """cvol [3 n1, Nq], cface [6, Nq], 1/wq [Nq], 1/wf [Nfp] on the device."""
    cvol, cface = _hex_line_coeffs(line_ops)
    iw, iwf = _inv_weights(line_ops)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (cvol, cface, iw, iwf))


def _check_cuda(name, tensors, dtype, device):
    """Raise unless every tensor is a contiguous CUDA tensor of one dtype."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(float32 or float64)")
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_shape(name, key, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


# K1, K2 and the split path are built for N+1 = 2..8
_N7_BUILT = "no kernel for this polynomial degree (N = 1..7 are built)"


def _raise_on(name, rc, unsupported="no kernel for this polynomial degree"):
    if rc == -1:
        raise NotImplementedError(f"{name}: {unsupported}")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")


# -----------------------------------------------------------------------------
# K1: volume stage
# -----------------------------------------------------------------------------

def _entropy_project_hex(q, ef, gamma):
    """Collocated-hex entropy projection (mirror of the TPU kernel's
    ``_entropy_project_hex``): q [5, Nq, K] -> hybridized flux variables
    qh [5, Nh, K] = (rho, u1..3, beta) and logs qlog [2, Nh, K]."""
    gm1 = gamma - 1.0
    rho, m1, m2, m3, e = q.unbind(0)
    rhou2 = m1 * m1 + m2 * m2 + m3 * m3
    p = gm1 * (e - 0.5 * rhou2 / rho)
    s = torch.log(p) - gamma * torch.log(rho)
    v1 = (gamma + 1.0 - s) - gm1 * e / p
    vm = [gm1 * m / p for m in (m1, m2, m3)]
    ve = -gm1 * rho / p

    fv1, fve = ef @ v1, ef @ ve
    fvm = [ef @ v for v in vm]
    vnorm = fvm[0] * fvm[0] + fvm[1] * fvm[1] + fvm[2] * fvm[2]
    sf = gamma - fv1 + vnorm / (2.0 * fve)
    rhoe = (gm1 / (-fve) ** gamma) ** (1.0 / gm1) * torch.exp(-sf / gm1)
    frho = rhoe * (-fve)
    fmom = [rhoe * v for v in fvm]
    fe = rhoe * (1.0 - vnorm / (2.0 * fve))

    beta_v = rho / (2.0 * p)
    uvel = [m / rho for m in (m1, m2, m3)]
    fp = gm1 * (fe - 0.5 * (fmom[0] * fmom[0] + fmom[1] * fmom[1]
                            + fmom[2] * fmom[2]) / frho)
    beta_f = frho / (2.0 * fp)
    fuvel = [m / frho for m in fmom]

    hyb = lambda vol_x, face_x: torch.cat([vol_x, face_x], dim=0)
    qh = torch.stack([hyb(rho, frho)]
                     + [hyb(uvel[d], fuvel[d]) for d in range(3)]
                     + [hyb(beta_v, beta_f)])
    return qh, torch.stack([torch.log(qh[0]), torch.log(qh[4])])


def euler_volume_plain(q, geo, ef, lift, gamma, *, line_ops: LineOps,
                       diag: bool = False, with_v: bool = False):
    """Plain PyTorch fused volume stage; same contract as ``euler_volume``.

    Entropy projection, line-sparse flux differencing, then
    Ph QF = QF_vol / wq + LIFT (QF_face / wf).  diag (affine meshes only,
    as in the kernel) drops the off-diagonal metric terms, exactly as
    the kernel's single-term contraction does.  with_v: v(U) is
    ``v_ufun(q, gamma)``.
    """
    nq = q.shape[1]
    qh, qlog = _entropy_project_hex(q, ef, gamma)
    curved = geo.shape[1] != 1
    if diag and not curved:
        eye = torch.eye(3, dtype=geo.dtype, device=geo.device)
        geo = geo * eye.reshape(9, 1, 1)
    qf = flux_differencing_lines(qh, qlog, geo, gamma, elem_type="hex",
                                 line_ops=line_ops, nq=nq)   # = 2 QF
    iw, iwf = _inv_weights(line_ops)
    iw = torch.as_tensor(iw, dtype=q.dtype, device=q.device)[:, None]
    iwf = torch.as_tensor(np.tile(iwf, 6), dtype=q.dtype,
                          device=q.device)[:, None]
    ph_qf = iw * qf[:, :nq] + lift @ (iwf * qf[:, nq:])
    traces = torch.cat([qh[:, nq:], qlog[:, nq:]], dim=0)
    if with_v:
        return ph_qf, traces, v_ufun(q, gamma)
    return ph_qf, traces


def euler_volume(q, geo, ef, lift, gamma, *, line_ops: LineOps,
                 diag: bool = False, with_v: bool = False):
    """Fused volume stage.  Returns (ph_qf [5, Nq, K], traces [7, Nfq, K])
    with traces = (rho, u1, u2, u3, beta, log rho, log beta) at the face
    points; with_v, also the entropy variables v(U) [5, Nq, K] at the
    volume nodes that the kernel computes for its projection.

    q [5, Nq, K] conservative state; geo [9, 1, K] affine metric or
    [9, Nh, K] curved; ef [Nfq, Nq] face extrapolation; lift [Nq, Nfq].
    diag: axis-aligned mesh (``detect_axis_aligned``); ignored on curved
    geometry, as in the TPU kernel.
    """
    if q.device.type == "cpu":
        return euler_volume_plain(q, geo, ef, lift, gamma,
                                  line_ops=line_ops, diag=diag,
                                  with_v=with_v)
    if q.device.type != "cuda":
        raise ValueError(f"euler_volume: no kernel for device {q.device}")
    name = "euler_volume"
    nf, nq, k = q.shape
    n1 = line_ops.n1d
    nfq = 6 * n1 * n1
    curved = geo.shape[1] != 1
    diag = diag and not curved
    _check_cuda(name, {"q": q, "geo": geo, "ef": ef, "lift": lift},
                q.dtype, q.device)
    for key, t, shape in (("q", q, (5, n1 ** 3, k)),
                          ("geo", geo, (9, n1 ** 3 + nfq if curved else 1, k)),
                          ("ef", ef, (nfq, nq)), ("lift", lift, (nq, nfq))):
        _check_shape(name, key, t, shape)
    out = torch.empty((nf, nq, k), dtype=q.dtype, device=q.device)
    traces = torch.empty((7, nfq, k), dtype=q.dtype, device=q.device)
    v = (torch.empty((nf, nq, k), dtype=q.dtype, device=q.device)
         if with_v else None)
    res = (out, traces, v) if with_v else (out, traces)
    if k == 0:
        return res
    cvol, cface, iw, iwf = _volume_consts(line_ops, q.dtype, q.device)
    from ..kernels import library

    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with span("ops.fused_volume.euler_volume"):
            rc = lib.esdg_hex_volume(
                _DTYPE_CODE[q.dtype], n1, int(diag), int(curved),
                q.data_ptr(), geo.data_ptr(), cvol.data_ptr(),
                cface.data_ptr(), iw.data_ptr(), iwf.data_ptr(),
                ef.data_ptr(), lift.data_ptr(), out.data_ptr(),
                traces.data_ptr(), v.data_ptr() if with_v else None, k,
                float(gamma), stream)
    _raise_on(name, rc, _N7_BUILT)
    euler_volume.launches += 1
    euler_volume.forms["curved" if curved else "diag" if diag
                       else "general"] += 1
    euler_volume.with_v += int(with_v)
    return res


euler_volume.launches = 0
# launches by metric form: one-row diagonal, general affine, curved
euler_volume.forms = {"diag": 0, "general": 0, "curved": 0}
# launches that wrote v(U) (the CNS front's; the Euler fronts ask for none)
euler_volume.with_v = 0


def launch_shape(entry, *args):
    """(resident blocks per SM, threads per block, shared memory bytes,
    registers per thread, local bytes per thread, elements per block, a
    flag of the kernel's own) of a kernel on the current card, from its
    library entry's shape query (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    cudaFuncGetAttributes)."""
    import ctypes

    from ..kernels import library

    occ = (ctypes.c_int * 7)()
    rc = getattr(library(), entry)(*args, occ)
    _raise_on(entry, rc)
    return tuple(occ)


def euler_volume_shape(dtype, n1, *, diag=False, curved=False,
                       with_v=False):
    """K1's launch shape at line length n1, in the form that stores v(U)
    with with_v (``launch_shape``)."""
    return launch_shape("esdg_hex_volume_shape", _DTYPE_CODE[dtype], n1,
                        int(diag), int(curved), int(with_v))


# -----------------------------------------------------------------------------
# K2: surface stage
# -----------------------------------------------------------------------------

def surface_neighbour_index(grid_shape, nfp):
    """K2's neighbour rule on a fully periodic uniform grid
    (``csrc/hex_surface.cuh``, GRID) in the form of ``map_p``: int64
    [6 nfp, K] flat indices fp' K + k' of each face point's neighbour.
    Element k = x + kx (y + ky z) of grid_shape (kz, ky, kx); face 2d pairs
    with face 2d+1 of element k - s_d (face 2d+1 with face 2d of k + s_d)
    at the same face-local index, wrapped at the grid's ends;
    s = (1, kx, kx ky)."""
    kz, ky, kx = grid_shape
    k = kx * ky * kz
    elem = np.arange(k)
    coord = (elem % kx, (elem // kx) % ky, elem // (kx * ky))
    period, stride = (kx, ky, kz), (1, kx, kx * ky)
    out = np.empty((6 * nfp, k), dtype=np.int64)
    for face in range(6):
        d, side = divmod(face, 2)
        sign = 1 if side else -1
        wrap = coord[d] == (period[d] - 1 if side else 0)
        kn = elem + sign * stride[d] - sign * wrap * period[d] * stride[d]
        first = (face - sign) * nfp     # the neighbour's face, point 0
        out[face * nfp:(face + 1) * nfp] = (
            (first + np.arange(nfp))[:, None] * k + kn[None, :])
    return out


def _surface_form(name, nbr, grid, ph_qf, parts, line_ops):
    """Check that exactly one neighbour source and one volume term are
    given; returns (grid form, split form)."""
    if (nbr is None) == (grid is None):
        raise ValueError(f"{name}: pass the gathered neighbour traces nbr "
                         "or the periodic grid (kz, ky, kx), not both")
    if (ph_qf is None) == (parts is None):
        raise ValueError(f"{name}: pass ph_qf or the split path's three "
                         "direction parts, not both")
    if parts is not None and (line_ops is None or len(parts) != 3):
        raise ValueError(f"{name}: the split form takes three parts and "
                         "line_ops")
    return grid is not None, parts is not None


def euler_surface_plain(traces, nbr, nxj, sj, inv_sj, inv_jac, lift, ph_qf,
                        gamma, *, dissipation: bool = True,
                        diag: bool = False, grid=None, parts=None,
                        line_ops: LineOps | None = None):
    """Plain PyTorch fused surface stage; same contract as
    ``euler_surface`` (mirror of the TPU ``_surface_kernel``).  The grid
    form takes the neighbours by the exchange's rolls
    (``core.discretization.grid_neighbours``), the split form ph_qf by
    ``split_combine``, then the same surface stage."""
    grid_form, split_form = _surface_form("euler_surface_plain", nbr, grid,
                                          ph_qf, parts, line_ops)
    if grid_form:
        nbr = grid_neighbours(traces, grid)
    if split_form:
        ph_qf = split_combine(parts, lift, line_ops)
    gm1 = gamma - 1.0
    nfp = traces.shape[1] // 6

    def conservative(q5):
        # (rho, u, beta) -> (rho, m, E) with p = rho/(2 beta)
        rho, u1, u2, u3, beta = q5
        u2norm = u1 * u1 + u2 * u2 + u3 * u3
        e = rho / (2.0 * beta * gm1) + 0.5 * rho * u2norm
        return rho, rho * u1, rho * u2, rho * u3, e

    def group_flux(qm, qp, logs_m, logs_p, nxj_g, sj_g, isj_g, dirs):
        """EC flux + LF for one row group (or the whole face set)."""
        fluxes = ec_flux_fields(qm, qp, logs_m, logs_p, gamma, dirs=dirs)
        if dirs is None:
            flux = [sum(fluxes[x][f] * nxj_g[x] for x in range(3))
                    for f in range(5)]
        else:
            flux = [fluxes[0][f] * nxj_g[0] for f in range(5)]
        if dissipation:
            um = conservative(qm)
            up = conservative(qp)

            def lam(u):
                rho, m1, m2, m3, e = u
                if dirs is None:
                    un = (m1 * nxj_g[0] + m2 * nxj_g[1]
                          + m3 * nxj_g[2]) * isj_g
                else:
                    un = (m1, m2, m3)[dirs[0]] * nxj_g[0] * isj_g
                p = gm1 * (e - 0.5 * un * un / rho)
                return torch.abs(un / rho) + torch.sqrt(gamma * p / rho)

            lfc = 0.25 * torch.maximum(lam(um), lam(up)) * sj_g
            for f in range(5):
                flux[f] = flux[f] - lfc * (up[f] - um[f])
        return flux

    if diag:
        parts = []
        for d in range(3):
            rows = slice(2 * d * nfp, 2 * (d + 1) * nfp)
            nxj_g = nxj[0, rows]
            sj_g = torch.abs(nxj_g)           # = sqrt(nxj_d^2): exact
            parts.append(group_flux(
                tuple(traces[i, rows] for i in range(5)),
                tuple(nbr[i, rows] for i in range(5)),
                (traces[5, rows], traces[6, rows]),
                (nbr[5, rows], nbr[6, rows]),
                (nxj_g,), sj_g, 1.0 / sj_g, (d,),
            ))
        flux = [torch.cat([parts[d][f] for d in range(3)], dim=0)
                for f in range(5)]
    else:
        flux = group_flux(
            tuple(traces[i] for i in range(5)),
            tuple(nbr[i] for i in range(5)),
            (traces[5], traces[6]), (nbr[5], nbr[6]),
            tuple(nxj[x] for x in range(3)), sj, inv_sj, None,
        )
    return -(ph_qf + lift @ torch.stack(flux)) * inv_jac


def euler_surface(traces, nbr, nxj, sj, inv_sj, inv_jac, lift, ph_qf,
                  gamma, *, dissipation: bool = True, diag: bool = False,
                  grid=None, parts=None, line_ops: LineOps | None = None):
    """Fused surface stage; returns the complete RHS dq [5, Nq, K].

    traces [7, Nfq, K]: the local traces.  The neighbours' are nbr
    [7, Nfq, K] (gathered), or, with nbr None and grid = (kz, ky, kx) of a
    fully periodic uniform grid (``Discretization.grid_shape``), read by
    the kernel from traces itself (``surface_neighbour_index``).
    The volume term is ph_qf [5, Nq, K], or, with ph_qf None, the split
    path's three direction parts ``parts`` [5, Nq + 2 Nfp, K]
    (``euler_volume_split_parts``; line_ops gives their weights): the
    kernel folds ``split_combine`` into its LIFT.
    diag: nxj is the COMPACT [1, Nfq, K] normal (each face point's single
    nonzero component) and inv_jac its first row [1, K]; sj / inv_sj are
    not read (derived in the kernel).  General: nxj [3, Nfq, K], sj and
    inv_sj [Nfq, K], inv_jac [Nq, K].
    """
    if traces.device.type == "cpu":
        return euler_surface_plain(traces, nbr, nxj, sj, inv_sj, inv_jac,
                                   lift, ph_qf, gamma,
                                   dissipation=dissipation, diag=diag,
                                   grid=grid, parts=parts, line_ops=line_ops)
    if traces.device.type != "cuda":
        raise ValueError(f"euler_surface: no kernel for device {traces.device}")
    name = "euler_surface"
    grid_form, split_form = _surface_form(name, nbr, grid, ph_qf, parts,
                                          line_ops)
    _, nfq, k = traces.shape
    n1 = round((nfq // 6) ** 0.5)
    nq, nfp = n1 ** 3, n1 * n1
    tensors = {"traces": traces, "nxj": nxj, "inv_jac": inv_jac,
               "lift": lift}
    shapes = {"traces": (7, nfq, k), "nxj": (1 if diag else 3, nfq, k),
              "inv_jac": (1 if diag else nq, k), "lift": (nq, nfq)}
    if not diag:
        tensors.update(sj=sj, inv_sj=inv_sj)
        shapes.update(sj=(nfq, k), inv_sj=(nfq, k))
    if grid_form:
        kz, ky, kx = grid
        if kx * ky * kz != k:
            raise ValueError(f"{name}: grid {tuple(grid)} holds "
                             f"{kx * ky * kz} elements, traces {k}")
    else:
        kz = ky = kx = 0
        tensors["nbr"], shapes["nbr"] = nbr, (7, nfq, k)
    iw = iwf = None
    if split_form:
        if line_ops.n1d != n1:
            raise ValueError(f"{name}: line_ops has N+1 = {line_ops.n1d}, "
                             f"the traces {n1}")
        for d in range(3):
            tensors[f"parts[{d}]"] = parts[d]
            shapes[f"parts[{d}]"] = (5, nq + 2 * nfp, k)
        iw, iwf = _volume_consts(line_ops, traces.dtype, traces.device)[2:]
    else:
        tensors["ph_qf"], shapes["ph_qf"] = ph_qf, (5, nq, k)
    _check_cuda(name, tensors, traces.dtype, traces.device)
    for key, t in tensors.items():
        _check_shape(name, key, t, shapes[key])
    out = torch.empty((5, nq, k), dtype=traces.dtype, device=traces.device)
    if k == 0:
        return out
    import ctypes

    from ..kernels import library, pointer_array

    lib = library()
    part = list(parts) if split_form else [None] * 3
    ptrs = pointer_array([traces, nbr, nxj, None if diag else sj,
                          None if diag else inv_sj, inv_jac, lift, ph_qf,
                          *part, iw, iwf, out])
    dims = (ctypes.c_int * 3)(kx, ky, kz)
    with torch.cuda.device(traces.device):
        stream = torch.cuda.current_stream(traces.device).cuda_stream
        with span("ops.fused_volume.euler_surface"):
            rc = lib.esdg_hex_surface(
                _DTYPE_CODE[traces.dtype], n1, int(diag), int(grid_form),
                int(split_form), int(dissipation), ptrs, dims, k,
                float(gamma), stream)
    _raise_on(name, rc, _N7_BUILT)
    euler_surface.launches += 1
    forms = euler_surface.forms
    forms[("diag." if diag else "general.")
          + ("grid" if grid_form else "gather")] += 1
    if split_form:
        forms["split"] += 1
    return out


euler_surface.launches = 0
# launches by normal form (compact diagonal or general) crossed with the
# neighbours' source (read on the grid or gathered); "split" counts the
# launches that took the split front's parts, each also counted above
euler_surface.forms = {"diag.grid": 0, "diag.gather": 0, "general.grid": 0,
                       "general.gather": 0, "split": 0}


def euler_surface_shape(dtype, n1, *, diag=False, grid=False, split=False):
    """K2's launch shape at line length n1 in one form (``launch_shape``)."""
    return launch_shape("esdg_hex_surface_shape", _DTYPE_CODE[dtype], n1,
                        int(diag), int(grid), int(split))


# -----------------------------------------------------------------------------
# The split volume path (rows 3, 4a, 4b)
# -----------------------------------------------------------------------------


def hex_project_plain(q, ef, gamma):
    """Plain PyTorch projection; same contract as ``hex_project``."""
    nq = q.shape[1]
    qh, qlog = _entropy_project_hex(q, ef, gamma)
    return qh, qlog, torch.cat([qh[:, nq:], qlog[:, nq:]], dim=0)


def hex_project(q, ef, gamma):
    """Split-path projection (row 3): q [5, Nq, K], ef [Nfq, Nq] ->
    (qh [5, Nh, K], qlog [2, Nh, K], traces [7, Nfq, K]): the flux
    variables (rho, u1..3, beta) and their logs at all hybridized points,
    and the face traces of K1's contract."""
    if q.device.type == "cpu":
        return hex_project_plain(q, ef, gamma)
    if q.device.type != "cuda":
        raise ValueError(f"hex_project: no kernel for device {q.device}")
    name = "hex_project"
    nf, nq, k = q.shape
    nfq = ef.shape[0]
    n1 = round(nq ** (1.0 / 3.0))
    _check_cuda(name, {"q": q, "ef": ef}, q.dtype, q.device)
    _check_shape(name, "q", q, (5, n1 ** 3, k))
    _check_shape(name, "ef", ef, (6 * n1 * n1, nq))
    nh = nq + nfq
    qh = torch.empty((5, nh, k), dtype=q.dtype, device=q.device)
    qlog = torch.empty((2, nh, k), dtype=q.dtype, device=q.device)
    traces = torch.empty((7, nfq, k), dtype=q.dtype, device=q.device)
    if k == 0:
        return qh, qlog, traces
    from ..kernels import library

    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with span("ops.fused_volume.hex_project"):
            rc = lib.esdg_hex_project(
                _DTYPE_CODE[q.dtype], n1, q.data_ptr(), ef.data_ptr(),
                qh.data_ptr(), qlog.data_ptr(), traces.data_ptr(), k,
                float(gamma), stream)
    _raise_on(name, rc, _N7_BUILT)
    hex_project.launches += 1
    return qh, qlog, traces


hex_project.launches = 0


def hex_project_shape(dtype, n1):
    """The projection's launch shape at line length n1 (``launch_shape``)."""
    return launch_shape("esdg_hex_project_shape", _DTYPE_CODE[dtype], n1)


def _fd_coeffs(line_ops, qh, coeffs):
    """(cvol, cface): the given tables, or line_ops' on qh's device."""
    if coeffs is not None:
        return coeffs
    return _volume_consts(line_ops, qh.dtype, qh.device)[:2]


def _fd_dir_plain(qh, qlog, geo, gamma, line_ops, d, diag, dense,
                  coeffs=None):
    """One direction of the line-sparse fd, triangular or dense (mirror of
    ``_fd_dir_kernel`` / ``_fd_dir_dense_kernel``): [5, Nq + 2 Nfp, K] =
    the volume rows, then the face rows of faces 2d and 2d+1 (not scaled
    by 1/wf).  coeffs: (cvol, cface) in place of line_ops' tables."""
    if geo.shape[1] != 1:
        raise ValueError("split volume path is affine-only")
    n1 = line_ops.n1d
    nq, nfp, k = n1 ** 3, n1 * n1, qh.shape[2]
    cvol, cface = _fd_coeffs(line_ops, qh, coeffs)
    shape, axis = _dir_layout(3, n1, d)
    vshape = (*shape, k)
    vol = [qh[f, :nq].reshape(vshape) for f in range(5)]
    vlog = [qlog[l, :nq].reshape(vshape) for l in range(2)]
    gshape = (1,) * len(shape) + (k,)
    xs = (d,) if diag else (0, 1, 2)
    geo_d = [geo[d * 3 + x, 0].reshape(gshape) for x in xs]
    dirs = (d,) if diag else None

    def contract(ql, qr, ll, lr):
        fluxes = ec_flux_fields(ql, qr, ll, lr, gamma, dirs=dirs)
        return [sum(g * fl[f] for g, fl in zip(geo_d, fluxes))
                for f in range(5)]

    line = lambda a, j, n=1: a.narrow(axis, j, n)
    coeff = lambda row: row.reshape(*shape, 1)
    acc = [torch.zeros(vshape, dtype=qh.dtype, device=qh.device)
           for _ in range(5)]
    if dense:
        for ap in range(n1):
            fr = contract(vol, [line(v, ap) for v in vol], vlog,
                          [line(l, ap) for l in vlog])
            c = coeff(cvol[d * n1 + ap])
            acc = [a + c * r for a, r in zip(acc, fr)]
    else:
        for ap in range(1, n1):
            fr = contract([line(v, 0, ap) for v in vol],
                          [line(v, ap) for v in vol],
                          [line(l, 0, ap) for l in vlog],
                          [line(l, ap) for l in vlog])
            c = line(coeff(cvol[d * n1 + ap]), 0, ap)
            zshape = list(vshape)
            zshape[axis] = n1 - ap - 1
            for f in range(5):
                w = c * fr[f]
                acc[f] = acc[f] + torch.cat(
                    [w, -w.sum(axis, keepdim=True),
                     w.new_zeros(zshape)], dim=axis)
    fshape = list(vshape)
    fshape[axis] = 1
    face_rows = []
    for side in range(2):
        fid = 2 * d + side
        rows = slice(nq + fid * nfp, nq + (fid + 1) * nfp)
        fr = contract(vol, [qh[f, rows].reshape(fshape) for f in range(5)],
                      vlog, [qlog[l, rows].reshape(fshape) for l in range(2)])
        c = coeff(cface[fid])
        rows_out = []
        for f in range(5):
            w = c * fr[f]
            acc[f] = acc[f] + w
            rows_out.append(-w.sum(axis).reshape(nfp, k))
        face_rows.append(rows_out)
    return torch.stack([torch.cat([acc[f].reshape(nq, k), face_rows[0][f],
                                   face_rows[1][f]]) for f in range(5)])


def _fd_dir_launch(name, qh, qlog, geo, gamma, line_ops, d, diag, dense,
                   coeffs=None):
    if qh.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {qh.device}")
    if geo.shape[1] != 1:
        raise ValueError("split volume path is affine-only")
    if d not in (0, 1, 2):
        raise ValueError(f"{name}: direction {d}, expected 0, 1 or 2")
    n1 = line_ops.n1d
    nq, nfp, k = n1 ** 3, n1 * n1, qh.shape[2]
    nh = nq + 6 * nfp
    cvol, cface = _fd_coeffs(line_ops, qh, coeffs)
    tensors = {"qh": qh, "qlog": qlog, "geo": geo, "cvol": cvol,
               "cface": cface}
    _check_cuda(name, tensors, qh.dtype, qh.device)
    for key, shape in (("qh", (5, nh, k)), ("qlog", (2, nh, k)),
                       ("geo", (9, 1, k))):
        _check_shape(name, key, tensors[key], shape)
    for key, rows in (("cvol", 3 * n1), ("cface", 6)):
        if tensors[key].numel() != rows * nq:
            raise ValueError(f"{name}: {key} has shape "
                             f"{tuple(tensors[key].shape)}, expected "
                             f"{rows} x {nq} values")
    out = torch.empty((5, nq + 2 * nfp, k), dtype=qh.dtype, device=qh.device)
    if k == 0:
        return out
    from ..kernels import library

    lib = library()
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = lib.esdg_hex_fd_dir(
            _DTYPE_CODE[qh.dtype], n1, d, int(diag), int(dense),
            qh.data_ptr(), qlog.data_ptr(), geo.data_ptr(), cvol.data_ptr(),
            cface.data_ptr(), out.data_ptr(), k, float(gamma), stream)
    _raise_on(name, rc, _N7_BUILT)
    return out


def fd_pair_schedule(n1):
    """The split fd kernel's pair schedule on one line
    (``csrc/hex_split.cuh``, kFdPairs): a list of rounds, each a list of
    the pairs (a, p) that the threads of nodes a evaluate in that round,
    p a node of the line or, p = n1 + side, its face point on face
    2d + side.  Rounds r = 1..n1 // 2 pair node a with node a + r mod n1
    (at even n1 the last round, distance n1 / 2, only for a < n1 / 2):
    node a keeps s F(a, p) and node p receives its negative, s the
    triangular form's coefficient cvol[d n1 + max(a, p)][node min(a, p)],
    negated when a > p.  The last two rounds pair every node with face
    point 0, then 1: node a keeps c F and the face row, summed over the
    line's nodes in node order, takes the negatives."""
    rounds = [[(a, (a + r) % n1) for a in range(n1) if 2 * r < n1 or a < r]
              for r in range(1, n1 // 2 + 1)]
    return rounds + [[(a, n1 + side) for a in range(n1)] for side in (0, 1)]


def hex_fd_dir_plain(qh, qlog, geo, gamma, *, line_ops: LineOps, d: int,
                     diag: bool = False, coeffs=None):
    """Plain PyTorch version of ``hex_fd_dir``."""
    return _fd_dir_plain(qh, qlog, geo, gamma, line_ops, d, diag, False,
                         coeffs)


def hex_fd_dir(qh, qlog, geo, gamma, *, line_ops: LineOps, d: int,
               diag: bool = False, coeffs=None):
    """Direction d of the triangular line-sparse flux differencing (row 4a):
    every vol-vol pair of a line once, the vol-face pairs of faces 2d and
    2d+1; diag (axis-aligned mesh) one metric term, else the 3-term affine
    contraction.  qh [5, Nh, K], qlog [2, Nh, K], geo [9, 1, K] ->
    [5, Nq + 2 Nfp, K]: the volume rows, then the face rows of faces 2d
    and 2d+1, not scaled by 1/wf.  coeffs: (cvol [3 N1, Nq], cface
    [6, Nq]) in place of line_ops' tables (the fd-section study's random
    ones, ``probes.fd_section``); line_ops then gives N+1 alone."""
    if qh.device.type == "cpu":
        return hex_fd_dir_plain(qh, qlog, geo, gamma, line_ops=line_ops, d=d,
                                diag=diag, coeffs=coeffs)
    out = _fd_dir_launch("hex_fd_dir", qh, qlog, geo, gamma, line_ops, d,
                         diag, False, coeffs)
    hex_fd_dir.launches += 1
    return out


hex_fd_dir.launches = 0


def hex_fd_dir_dense_plain(qh, qlog, geo, gamma, *, line_ops: LineOps,
                           d: int):
    """Plain PyTorch version of ``hex_fd_dir_dense``."""
    return _fd_dir_plain(qh, qlog, geo, gamma, line_ops, d, False, True)


def hex_fd_dir_dense(qh, qlog, geo, gamma, *, line_ops: LineOps, d: int):
    """Direction d of the dense flat-partner flux differencing (row 4b):
    every node against all N+1 nodes of its line and both face points,
    always the 3-term affine contraction; same contract as
    ``hex_fd_dir``.  cvol's line blocks are skew with a zero diagonal and
    the flux is symmetric, so on the card it runs ``hex_fd_dir``'s general
    kernel, every pair once: the same function, another roundoff."""
    if qh.device.type == "cpu":
        return hex_fd_dir_dense_plain(qh, qlog, geo, gamma,
                                      line_ops=line_ops, d=d)
    out = _fd_dir_launch("hex_fd_dir_dense", qh, qlog, geo, gamma, line_ops,
                         d, False, True)
    hex_fd_dir_dense.launches += 1
    return out


hex_fd_dir_dense.launches = 0


def hex_fd_dir_shape(dtype, n1, *, diag=False, d=0):
    """The split fd's launch shape at line length n1 in direction d, diag
    or general (the dense form's) (``launch_shape``)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"hex_fd_dir_shape: dtype {dtype} not supported "
                        "(float32 or float64)")
    if d not in (0, 1, 2):
        raise ValueError(f"hex_fd_dir_shape: direction {d}, expected 0, 1 "
                         "or 2")
    if not 2 <= n1 <= 8:
        raise NotImplementedError(f"hex_fd_dir_shape: N+1 = {n1}: "
                                  f"{_N7_BUILT}")
    return launch_shape("esdg_hex_fd_dir_shape", _DTYPE_CODE[dtype], n1, d,
                        int(diag))


def split_combine(parts, lift, line_ops: LineOps):
    """Ph QF = 2 (1/wq) sum_d QF_vol,d + 2 LIFT ((1/wf) QF_face): the three
    directions' [5, Nq + 2 Nfp, K] parts -> ph_qf [5, Nq, K].  Plain
    tensor code on every device (the TPU package's combine is XLA); the
    LIFT product is a float32 matmul with TF32 off.
    ``split_combine.calls`` counts the calls."""
    split_combine.calls += 1
    n1 = line_ops.n1d
    nq, nfp = n1 ** 3, n1 * n1
    p0 = parts[0]
    _, _, iw, iwf = _volume_consts(line_ops, p0.dtype, p0.device)
    acc_vol = parts[0][:, :nq] + parts[1][:, :nq] + parts[2][:, :nq]
    qf_face = torch.cat([iwf[:, None] * parts[d][:, nq + side * nfp:
                                                 nq + (side + 1) * nfp]
                         for d in range(3) for side in range(2)], dim=1)
    return 2.0 * iw[:, None] * acc_vol + 2.0 * torch.matmul(lift, qf_face)


split_combine.calls = 0


def _check_split(geo, dense, pad_x):
    if geo.shape[1] != 1:
        raise ValueError("split volume path is affine-only")
    if pad_x and dense:
        raise ValueError("pad_x is only implemented for the non-dense "
                         "split fd kernels")


def euler_volume_split_plain(q, geo, ef, lift, gamma, *, line_ops: LineOps,
                             dense: bool = False, diag: bool = False,
                             pad_x: bool = False):
    """Plain PyTorch split volume stage; same contract as
    ``euler_volume_split``."""
    _check_split(geo, dense, pad_x)
    qh, qlog, traces = hex_project_plain(q, ef, gamma)
    parts = [_fd_dir_plain(qh, qlog, geo, gamma, line_ops, d,
                           diag and not dense, dense) for d in range(3)]
    return split_combine(parts, lift, line_ops), traces


def euler_volume_split_parts(q, geo, ef, gamma, *, line_ops: LineOps,
                             dense: bool = False, diag: bool = False,
                             pad_x: bool = False):
    """The split volume stage up to the combine: ``hex_project``, then one
    ``hex_fd_dir`` (or, dense, ``hex_fd_dir_dense``) per direction.
    Returns (parts, traces): the three [5, Nq + 2 Nfp, K] direction parts,
    which ``split_combine`` or K2 (``euler_surface(parts=...)``) sum, and
    traces [7, Nfq, K].  Arguments as ``euler_volume_split``."""
    _check_split(geo, dense, pad_x)
    qh, qlog, traces = hex_project(q, ef, gamma)
    if dense:
        parts = [hex_fd_dir_dense(qh, qlog, geo, gamma, line_ops=line_ops,
                                  d=d) for d in range(3)]
    else:
        parts = [hex_fd_dir(qh, qlog, geo, gamma, line_ops=line_ops, d=d,
                            diag=diag) for d in range(3)]
    return parts, traces


def euler_volume_split(q, geo, ef, lift, gamma, *, line_ops: LineOps,
                       dense: bool = False, diag: bool = False,
                       pad_x: bool = False):
    """Split volume stage (affine hex): ``euler_volume_split_parts``, then
    ``split_combine``.  Same contract as ``euler_volume``: (ph_qf
    [5, Nq, K], traces [7, Nfq, K]).

    diag: one metric term per direction (axis-aligned mesh; ignored by the
    dense form, which always contracts all three, as in the TPU package).
    pad_x: the TPU package's sublane-padded layout of the same math; it
    runs the same line kernel here and is refused with dense, as there.
    """
    parts, traces = euler_volume_split_parts(q, geo, ef, gamma,
                                             line_ops=line_ops, dense=dense,
                                             diag=diag, pad_x=pad_x)
    return split_combine(parts, lift, line_ops), traces
