"""Device-resident discretization: operators + mesh arrays as one dataclass.

Port of ``esdg_cns_tpu/core/discretization.py``.  ``build_discretization``
runs the same host-side NumPy float64 setup as the JAX package (so both
packages hold bit-identical arrays in f64) and then moves every array to
torch on the given device and dtype.

Layout (kept from the JAX package so the two compare like with like):
  * element axis last everywhere: state [Nf, Np, K], traces [Nfq, K]
    (the K-fastest layout makes loads of one node across neighbouring
    elements contiguous for the CUDA kernels);
  * ``map_p`` is an int32 row-major flat index (node * K + elem) into the
    flattened [Nfq, K] trace array: one gather, no scatter anywhere;
  * geometric factors are stored at the hybridized points, collapsed to a
    single per-element value when the mesh is affine.

Not ported: the compiled roll plan (``roll_plan`` / ``roll_masks``), a
TPU re-expression of the same gather; meshes without ``grid_shape`` (the
tri cavity among them) take the ``map_p`` gather, one ``index_select``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..mesh.connectivity import build_node_maps, connect_mesh, make_periodic
from ..mesh.geometry import geometric_factors_2d, geometric_factors_3d
from ..tracing import span
from .ref_elem import RefElem

# static fields, and the tensor fields (tuple-valued ones hold one tensor
# per direction) — the interop layer and the tests walk these lists
META_FIELDS = (
    "elem_type", "n", "dim", "nfaces", "num_elements", "np_", "nq", "nfq",
    "nh", "affine", "periodic_axes", "line_ops", "grid_shape",
)
TUPLE_FIELDS = ("d", "q_skew", "x", "xq", "xf", "nxj")
ARRAY_FIELDS = (
    "vq", "vf", "pq", "lift", "d", "q_skew", "vh", "ph", "vhp", "wq", "wf",
    "vp", "x", "xq", "xf", "geo", "geo_nodal", "jac", "inv_jac", "wjq",
    "nxj", "sj", "inv_sj", "map_p", "bmask",
)


@dataclasses.dataclass
class Discretization:
    # ---- static metadata ----
    elem_type: str
    n: int
    dim: int
    nfaces: int
    num_elements: int
    np_: int
    nq: int
    nfq: int
    nh: int
    affine: bool
    periodic_axes: tuple
    line_ops: object          # LineOps for collocated quad/hex, else None
    grid_shape: tuple         # (kz, ky, kx) for fully periodic uniform
                              # hex grids in generator order, else None

    # ---- reference operators (compute dtype) ----
    vq: torch.Tensor          # [Nq, Np]
    vf: torch.Tensor          # [Nfq, Np]
    pq: torch.Tensor          # [Np, Nq]
    lift: torch.Tensor        # [Np, Nfq]
    d: tuple                  # dim x [Np, Np]
    q_skew: tuple             # dim x [Nh, Nh]
    vh: torch.Tensor          # [Nh, Np]
    ph: torch.Tensor          # [Np, Nh]
    vhp: torch.Tensor         # [Nh, Nq]
    wq: torch.Tensor          # [Nq]
    wf: torch.Tensor          # [Nfq]
    vp: torch.Tensor          # [Nplot, Np] plotting interpolation

    # ---- mesh arrays ----
    x: tuple                  # dim x [Np, K] nodal coordinates
    xq: tuple                 # dim x [Nq, K]
    xf: tuple                 # dim x [Nfq, K]
    geo: torch.Tensor         # [dim*dim, Ng, K]; Ng = 1 (affine) or Nh
    geo_nodal: torch.Tensor   # [dim*dim, Ngn, K]; Ngn = 1 (affine) or Np
    jac: torch.Tensor         # [Np, K]
    inv_jac: torch.Tensor     # [Np, K]
    wjq: torch.Tensor         # [Nq, K]
    nxj: tuple                # dim x [Nfq, K] scaled outward normals
    sj: torch.Tensor          # [Nfq, K]
    inv_sj: torch.Tensor      # [Nfq, K]
    map_p: torch.Tensor       # int32 [Nfq, K] flat gather indices
    bmask: torch.Tensor       # bool [Nfq, K] true on (non-periodic) boundary

    # periodic-wrap masks of the grid exchange (lowmask, highmask per
    # axis), derived from grid_shape once instead of on every gather
    wrap_masks: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.wrap_masks = ()
        if self.grid_shape is not None:
            self.wrap_masks = _wrap_masks(self.grid_shape, self.map_p.device)

    def gather_traces(self, uf: torch.Tensor) -> torch.Tensor:
        """Neighbor values: uf may be [Nfq, K] or [Nf, Nfq, K].

        On fully periodic uniform hex grids (grid_shape set) the generic
        gather is replaced by ``grid_neighbours``' flat rolls; elsewhere
        one ``index_select`` through map_p.
        """
        with span("core.discretization.gather_traces"):
            if self.grid_shape is not None and self.elem_type == "hex":
                return grid_neighbours(uf, self.grid_shape, self.wrap_masks)
            flat = uf.reshape(*uf.shape[:-2], self.nfq * self.num_elements)
            return torch.index_select(flat, -1, self.map_p.reshape(-1)) \
                .reshape(uf.shape)


def _wrap_masks(grid_shape, device):
    """(lowmask, highmask) per grid axis x, y, z over the element axis."""
    kz, ky, kx = grid_shape
    idx = torch.arange(kx * ky * kz, device=device)
    coords = (idx % kx, (idx // kx) % ky, idx // (kx * ky))
    return tuple((c == 0, c == p - 1) for c, p in zip(coords, (kx, ky, kz)))


def grid_neighbours(uf: torch.Tensor, grid_shape, wrap_masks=None):
    """The face-trace exchange of a fully periodic uniform hex grid:
    uf [.., Nfq, K] -> the neighbours' values at each face point.

    Six flat rolls along the element axis: a +-1 shift along grid axis d
    is a roll by its stride, with the periodic wrap fixed by blending in
    a second roll on the wrap columns.  Face 2d pairs with the
    neighbour's face 2d+1 at the same face-local index.  Plain tensor
    code; ``grid_neighbours.calls`` counts the calls.
    """
    grid_neighbours.calls += 1
    kz, ky, kx = grid_shape
    if wrap_masks is None:
        wrap_masks = _wrap_masks(grid_shape, uf.device)
    strides = (1, kx, kx * ky)
    periods = (kx, ky, kz)
    lead = uf.shape[:-2]
    nfq, k = uf.shape[-2:]
    v = uf.reshape(*lead, 6, nfq // 6, k)
    fidx = len(lead)

    def take_face(i):
        return v.select(fidx, i)             # [.., nfp, K]

    outs = []
    for d in range(3):
        s = strides[d]
        p = periods[d] * s
        lo, hi = wrap_masks[d]
        src_minus = take_face(2 * d + 1)   # opposite (+) face
        src_plus = take_face(2 * d)        # opposite (-) face
        outs.append(torch.where(
            lo, torch.roll(src_minus, s - p, dims=-1),
            torch.roll(src_minus, s, dims=-1),
        ))
        outs.append(torch.where(
            hi, torch.roll(src_plus, p - s, dims=-1),
            torch.roll(src_plus, -s, dims=-1),
        ))
    out = torch.stack(outs, dim=fidx)
    return out.reshape(uf.shape)


grid_neighbours.calls = 0


def build_discretization(
    ref: RefElem,
    vertices: Sequence[np.ndarray],
    etov: np.ndarray,
    periodic_axes: tuple = (),
    curved_map=None,
    *,
    dtype: torch.dtype,
    device,
    grid_shape: Optional[tuple] = None,
) -> Discretization:
    """Assemble the full device-resident discretization.

    Args:
      ref: reference element from ``core.ref_elem``.
      vertices: dim arrays of vertex coordinates.
      etov: [K, nverts] element-to-vertex table.
      periodic_axes: axes along which the domain is periodic.
      curved_map: optional callable (x, y[, z]) -> same-shaped coords to
        curve the mesh after vertex interpolation.
      dtype, device: compute dtype and device of every float tensor.
      grid_shape: (kz, ky, kx) of a fully periodic uniform hex grid in
        generator order; turns on the roll exchange.
    """
    dim = ref.dim
    k = etov.shape[0]

    # nodal coordinates: x = V1 @ VX[EToV]^T   (SetupDG.jl:287)
    coords = [ref.v1 @ np.asarray(v)[etov].T for v in vertices]
    if curved_map is not None:
        coords = list(curved_map(*coords))

    xf_np = [ref.vf @ c for c in coords]
    xq_np = [ref.vq @ c for c in coords]

    # connectivity + node maps
    ftof = connect_mesh(etov, ref.face_vertices)
    nfp = ref.nfp
    _, map_p, _ = build_node_maps(xf_np, ftof, nfp)
    if periodic_axes:
        lengths = [np.asarray(v).max() - np.asarray(v).min() for v in vertices]
        map_p, ftof = make_periodic(
            xf_np, lengths, ftof, map_p, nfp, axes=periodic_axes
        )

    # geometric factors at solution nodes, stored rdir-major:
    # geo_list[rdir*dim + xdir] pairs the rdir-direction operator with the
    # xdir-direction flux (d/dx_j = sum_r geo[r*dim+j] * D_r / J)
    if dim == 1:
        (dr,) = ref.d
        xr = dr @ coords[0]
        jac_np = xr
        geo_list = [np.ones_like(xr)]  # rxJ = rx * J = 1 in 1D
    elif dim == 2:
        rxj, sxj, ryj, syj, jac_np = geometric_factors_2d(*coords, *ref.d)
        geo_list = [rxj, ryj, sxj, syj]
    else:
        g = geometric_factors_3d(*coords, *ref.d)
        rxj, sxj, txj, ryj, syj, tyj, rzj, szj, tzj = g[:9]
        jac_np = g[9]
        geo_list = [rxj, ryj, rzj, sxj, syj, szj, txj, tyj, tzj]

    if np.any(jac_np <= 0):
        raise ValueError("non-positive Jacobian: inverted element")

    # snap sub-roundoff metric entries to exact zero, AFFINE meshes only:
    # on axis-aligned meshes the off-diagonal geofacs (and off-axis normal
    # components below) are pure setup-matmul noise; zeroing them makes
    # the axis-aligned kernel specialization (ops.fused_volume diag=True)
    # bit-consistent with the general contraction.  The curl-form noise
    # is RELATIVE to the coordinate scale, not the metric scale, so its
    # relative size grows with mesh refinement (3.8e-11 at k1d=32, which
    # defeats a 1e-11 gate); the gate is 1e-9 relative.  Curved meshes
    # are NOT snapped: their curl-form GCL is an exact nodal identity.
    def _snap(arrs):
        scale = max(np.abs(a).max() for a in arrs)
        return [np.where(np.abs(a) < 1e-9 * scale, 0.0, a) for a in arrs]

    g_stack = np.stack(geo_list)
    g_spread = np.abs(g_stack - g_stack.mean(axis=1, keepdims=True)).max()
    snap_ok = bool(g_spread < 1e-6 * max(np.abs(g_stack).max(), 1e-300))
    if snap_ok:
        geo_list = _snap(geo_list)

    # surface normals: nxJ = sum_r (Vf @ geo[r,x]) * nhat_r  (SetupDG.jl:312)
    nxj_np = []
    for xdir in range(dim):
        acc = np.zeros((ref.nfq, k))
        for rdir in range(dim):
            acc += (ref.vf @ geo_list[rdir * dim + xdir]) * ref.nrst_j[rdir][:, None]
        nxj_np.append(acc)
    if snap_ok:
        nxj_np = _snap(nxj_np)
    sj_np = np.sqrt(sum(v**2 for v in nxj_np))

    # interpolate geofacs to hybridized points; collapse if affine
    geo_h = np.stack([ref.vh @ g for g in geo_list], axis=0)  # [dim*dim, Nh, K]
    spread = np.abs(geo_h - geo_h.mean(axis=1, keepdims=True)).max()
    scale = max(np.abs(geo_h).max(), 1e-300)
    # the 3D curl-form construction carries O(eps) absolute roundoff, so
    # the per-element spread of truly affine metrics can reach ~1e-13;
    # use a loose relative gate
    affine = bool(spread < 1e-6 * scale)
    if affine:
        geo_h = geo_h.mean(axis=1, keepdims=True)  # [dim*dim, 1, K]
    geo_nodal = np.stack(geo_list, axis=0)         # [dim*dim, Np, K]
    if affine:
        geo_nodal = geo_nodal.mean(axis=1, keepdims=True)

    wjq_np = ref.wq[:, None] * (ref.vq @ jac_np)

    # convert mapP flat ids (node + Nfq*elem) -> row-major (node*K + elem)
    node = map_p % (ref.nfq)
    elem = map_p // (ref.nfq)
    map_p_rm = (node * k + elem).astype(np.int32)

    flat_self = (np.arange(ref.nfq)[:, None] * k + np.arange(k)[None, :]).astype(np.int32)
    bmask_np = map_p_rm == flat_self

    if grid_shape is not None:
        if ref.elem_type != "hex" or len(periodic_axes) != dim:
            raise ValueError("grid_shape needs a fully periodic hex mesh")
        if int(np.prod(grid_shape)) != k:
            raise ValueError("grid_shape does not match element count")

    line_ops = None
    if ref.elem_type in ("quad", "hex") and ref.collocated:
        from ..ops.tensor_product_fd import LineOps

        # recover the 1D rule from the tensor structure (x fastest,
        # symmetric weights), so Gauss and LGL collocation both work
        n1 = ref.n + 1
        r1 = np.asarray(ref.rq[0])[:n1]
        w0 = float(np.asarray(ref.wq)[0]) ** (1.0 / dim)
        w1 = np.asarray(ref.wq)[:n1] / w0 ** (dim - 1)
        line_ops = LineOps.make(ref.n, r1, w1)

    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return Discretization(
        elem_type=ref.elem_type, n=ref.n, dim=dim, nfaces=ref.nfaces,
        num_elements=k, np_=ref.np_, nq=ref.nq, nfq=ref.nfq, nh=ref.nh,
        affine=affine, periodic_axes=tuple(periodic_axes),
        line_ops=line_ops,
        grid_shape=tuple(grid_shape) if grid_shape is not None else None,
        vq=f(ref.vq), vf=f(ref.vf), pq=f(ref.pq), lift=f(ref.lift),
        d=tuple(f(di) for di in ref.d),
        q_skew=tuple(f(qi) for qi in ref.q_skew),
        vh=f(ref.vh), ph=f(ref.ph), vhp=f(ref.vhp),
        wq=f(ref.wq), wf=f(ref.wf), vp=f(ref.vp),
        x=tuple(f(c) for c in coords),
        xq=tuple(f(c) for c in xq_np),
        xf=tuple(f(c) for c in xf_np),
        geo=f(geo_h), geo_nodal=f(geo_nodal),
        jac=f(jac_np), inv_jac=f(1.0 / jac_np),
        wjq=f(wjq_np),
        nxj=tuple(f(v) for v in nxj_np),
        sj=f(sj_np), inv_sj=f(1.0 / sj_np),
        map_p=torch.as_tensor(map_p_rm, device=device),
        bmask=torch.as_tensor(bmask_np, device=device),
    )
