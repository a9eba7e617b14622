"""Line-sparse flux differencing for tensor-product (collocated) elements.

Port of ``esdg_cns_tpu/ops/tensor_product_fd.py`` (``LineOps``, the
direction layouts, ``flux_differencing_lines``, the volume term of the
plain RHS, and ``flux_differencing_lines_fused``, the CUDA counterpart of
``flux_differencing_lines_pallas``).

For Gauss-collocated quad/hex elements the hybridized skew operators are
Kronecker-sparse:

  * volume-volume couplings act only along 1D node lines:
    A_d[(..a..),(..a'..)] = (prod of other-dir weights) * S1[a, a'],
    with S1 = (W D - D' W)/2 from the 1D Gauss operators;
  * each volume node couples to exactly the two face nodes that its line
    pierces, with weights -+ 0.5 * wline * e(-+)[a];
  * face rows are the skew negatives; face-face couplings vanish.

So the O(Nh^2) all-pairs sum collapses to O(Nq * (n1d + 2)) two-point
fluxes per direction.  Line constants are host-side numpy, moved to the
state's dtype and device per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..basis.jacobi import gauss_quad, grad_vandermonde_1d, vandermonde_1d
from ..physics.euler import ec_flux_fields


@dataclasses.dataclass(frozen=True)
class LineOps:
    """1D building blocks of the Kronecker structure (hashable: tuples)."""

    n1d: int
    s1: tuple        # [n1d][n1d]: (W D - D' W)/2
    e_minus: tuple   # interpolation to r = -1
    e_plus: tuple    # interpolation to r = +1
    w1: tuple        # Gauss weights

    @staticmethod
    def make(n: int, r1=None, w1=None) -> "LineOps":
        """Build from the collocated element's 1D rule (default Gauss;
        pass the LGL nodes/weights for the DG-SEM variant)."""
        if r1 is None:
            r1, w1 = gauss_quad(0, 0, n)
        r1, w1 = np.asarray(r1), np.asarray(w1)
        vinv = np.linalg.inv(vandermonde_1d(n, r1))
        d1 = grad_vandermonde_1d(n, r1) @ vinv
        s1 = 0.5 * (np.diag(w1) @ d1 - d1.T @ np.diag(w1))
        em = (vandermonde_1d(n, np.array([-1.0])) @ vinv).ravel()
        ep = (vandermonde_1d(n, np.array([1.0])) @ vinv).ravel()
        t = lambda a: tuple(map(tuple, a)) if a.ndim == 2 else tuple(a)
        return LineOps(n + 1, t(s1), t(em), t(ep), t(w1))


def _dir_layout(dim: int, n1d: int, d: int):
    """Volume reshape and line axis for direction d.

    Volume node flat index is a + n1d*b (+ n1d^2*c), a fastest.  Faces
    are ordered (r-,r+,s-,s+[,t-,t+]) for hex; (s-,r+,s+,r-) for quad
    is handled by the caller via the face table.
    """
    if dim == 3:
        shapes = {
            0: (n1d * n1d, n1d),   # (cb, a)
            1: (n1d, n1d, n1d),    # (c, b, a)
            2: (n1d, n1d * n1d),   # (c, ba)
        }
        axis = {0: 1, 1: 1, 2: 0}[d]
        return shapes[d], axis
    shapes = {0: (n1d, n1d), 1: (n1d, n1d)}  # (b, a)
    axis = {0: 1, 1: 0}[d]
    return shapes[d], axis


def _face_table(elem_type: str, n1d: int, dim: int):
    """(face_id_minus, face_id_plus, perm) per direction.

    perm maps the direction's group index to the face-node index (needed
    for the reference quad face ordering where top/left run reversed).
    """
    ident = np.arange(n1d)
    if elem_type == "hex":
        return {d: (2 * d, 2 * d + 1, None) for d in range(dim)}
    # quad faces: 0=bottom(s-), 1=right(r+), 2=top(s+), 3=left(r-)
    rev = ident[::-1]
    return {
        0: (3, 1, (rev, ident)),   # r-dir: left reversed, right identity
        1: (0, 2, (ident, rev)),   # s-dir: bottom identity, top reversed
    }


def _group_weights(dim: int, n1d: int, d: int, w1: np.ndarray):
    """w-product over non-line axes, shaped to broadcast over the volume
    reshape (without the trailing K axis)."""
    if dim == 3:
        if d == 0:
            return np.outer(w1, w1).reshape(n1d * n1d, 1)
        if d == 1:
            return (w1[:, None, None] * w1[None, None, :]).reshape(n1d, 1, n1d)
        return np.outer(w1, w1).reshape(1, n1d * n1d)
    return w1.reshape(n1d, 1) if d == 0 else w1.reshape(1, n1d)


def _hex_line_coeffs(line_ops: LineOps):
    """Host-built coefficient tables of the hex volume kernel.

    cvol[d*n1d + ap, i] = wgroup_d(i) * S1[a_d(i), ap]      [3*n1d, Nq]
    cface[d*2 + side, i] = (-+) 0.5 * wgroup_d(i) * e(-+)[a_d(i)]  [6, Nq]
    """
    n1 = line_ops.n1d
    s1 = np.asarray(line_ops.s1)
    em = np.asarray(line_ops.e_minus)
    ep = np.asarray(line_ops.e_plus)
    w1 = np.asarray(line_ops.w1)
    nq = n1 ** 3
    idx = np.arange(nq)
    coord = [idx % n1, (idx // n1) % n1, idx // (n1 * n1)]
    wq = w1[coord[0]] * w1[coord[1]] * w1[coord[2]]

    cvol = np.zeros((3 * n1, nq))
    cface = np.zeros((6, nq))
    for d in range(3):
        a = coord[d]
        wg = wq / w1[a]
        for ap in range(n1):
            cvol[d * n1 + ap] = wg * s1[a, ap]
        cface[d * 2 + 0] = -0.5 * wg * em[a]
        cface[d * 2 + 1] = 0.5 * wg * ep[a]
    return cvol, cface


def flux_differencing_lines(qh, qlog, geo, gamma, *, elem_type: str,
                            line_ops: LineOps, nq: int):
    """Line-sparse flux differencing for collocated quad/hex elements.

    qh [Nf, Nh, K] flux variables, qlog [2, Nh, K], geo [dim*dim, Ng, K]
    (Ng = 1 affine, Nh curved); returns 2*QF [Nf, Nh, K].
    """
    nf, nh, k = qh.shape
    dim = 3 if elem_type == "hex" else 2
    n1d = line_ops.n1d
    nfp = (nh - nq) // (2 * dim)
    dev, dt = qh.device, qh.dtype
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    s1 = tens(line_ops.s1)
    em = tens(line_ops.e_minus)
    ep = tens(line_ops.e_plus)
    w1 = np.asarray(line_ops.w1)
    curved = geo.shape[1] != 1
    faces = _face_table(elem_type, n1d, dim)

    acc_vol = [torch.zeros((nq, k), dtype=dt, device=dev) for _ in range(nf)]
    acc_face = [[None] * nf for _ in range(2 * dim)]

    def fields_at(rows):
        return tuple(qh[f, rows[0]:rows[1], :] for f in range(nf))

    vol_fields = fields_at((0, nq))
    vol_logs = (qlog[0, :nq, :], qlog[1, :nq, :])

    for d in range(dim):
        shape, axis = _dir_layout(dim, n1d, d)
        vshape = (*shape, k)
        vol_d = [v.reshape(vshape) for v in vol_fields]
        logs_d = [l.reshape(vshape) for l in vol_logs]
        gw = tens(_group_weights(dim, n1d, d, w1)[..., None])   # bcastable

        geo_d = []
        for x in range(dim):
            g = geo[d * dim + x]
            if curved:
                geo_d.append(g[:nq].reshape(vshape))
            else:
                geo_d.append(g.reshape((1,) * len(shape) + (k,)))

        def contract(fluxes, gj=None):
            """per-field geo-contracted flux: sum_x geo_avg[x]*F[x][f]."""
            out = []
            for f in range(nf):
                t = None
                for x in range(dim):
                    g = geo_d[x]
                    if curved and gj is not None:
                        g = 0.5 * (g + gj[x])
                    term = g * fluxes[x][f]
                    t = term if t is None else t + term
                out.append(t)
            return out

        def line_index(arr, j):
            return arr.narrow(axis, j, 1)

        # ---- volume-volume partners along the line ----
        cshape = [1] * len(shape)
        cshape[axis] = n1d
        for ap in range(n1d):
            qj = tuple(line_index(v, ap) for v in vol_d)
            lj = tuple(line_index(l, ap) for l in logs_d)
            fluxes = ec_flux_fields(vol_d, qj, logs_d, lj, gamma)
            gj = [line_index(g, ap) for g in geo_d] if curved else None
            fr = contract(fluxes, gj)
            coeff = s1[:, ap].reshape(*cshape, 1)
            for f in range(nf):
                acc_vol[f] = acc_vol[f] + (gw * coeff * fr[f]).reshape(nq, k)

        # ---- the two faces pierced by the line ----
        fid_m, fid_p, perm = faces[d]
        fshape = list(shape)
        fshape[axis] = 1
        for fid, evec, sign in ((fid_m, em, -1.0), (fid_p, ep, +1.0)):
            rows = (nq + fid * nfp, nq + (fid + 1) * nfp)
            fvals = fields_at(rows)
            flogs = (qlog[0, rows[0]:rows[1], :], qlog[1, rows[0]:rows[1], :])
            p = None
            if perm is not None:
                p = torch.as_tensor(perm[0] if fid == fid_m else perm[1],
                                    device=dev)
                fvals = tuple(v[p, :] for v in fvals)
                flogs = tuple(l[p, :] for l in flogs)
            fvals = tuple(v.reshape(*fshape, k) for v in fvals)
            flogs = tuple(l.reshape(*fshape, k) for l in flogs)

            fluxes = ec_flux_fields(vol_d, fvals, logs_d, flogs, gamma)
            if curved:
                gj = [geo[d * dim + x, rows[0]:rows[1], :] for x in range(dim)]
                if p is not None:
                    gj = [g[p, :] for g in gj]
                gj = [g.reshape(*fshape, k) for g in gj]
            else:
                gj = None
            fr = contract(fluxes, gj)

            coeff = (0.5 * sign) * evec.reshape(*cshape, 1)
            for f in range(nf):
                acc_vol[f] = acc_vol[f] + (gw * coeff * fr[f]).reshape(nq, k)
                # face row: skew negative, reduced along the line
                contrib = -torch.sum(gw * coeff * fr[f], dim=axis)
                contrib = contrib.reshape(nfp, k)
                if p is not None:
                    contrib = contrib[torch.argsort(p), :]
                prev = acc_face[fid][f]
                acc_face[fid][f] = contrib if prev is None else prev + contrib

    out_rows = []
    for f in range(nf):
        face_rows = [
            acc_face[i][f] if acc_face[i][f] is not None
            else torch.zeros((nfp, k), dtype=dt, device=dev)
            for i in range(2 * dim)
        ]
        out_rows.append(torch.cat([acc_vol[f], *face_rows], dim=0))
    return 2.0 * torch.stack(out_rows, dim=0)
