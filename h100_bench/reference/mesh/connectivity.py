"""Mesh topology: face connectivity, face-node maps, periodic patching.

Capability parity with reference ``src/connect_mesh.jl:17`` (sort-based
face matching) and ``src/node_map_functions.jl`` (build_node_maps :23,
build_periodic_boundary_maps 2D :66 / 3D :139) — vectorized NumPy,
0-based, element-major face numbering (global face id = e*Nfaces + f).

All outputs are plain int arrays; they become static gather indices on
device.  ``mapP`` is expressed in *face-trace space*: index into the
flattened ``[Nfaces*Nfp, K]`` face-node array (column-major element
blocks, i.e. flat id = node + (Nfaces*Nfp) * elem).
"""

from __future__ import annotations

import numpy as np

_NODETOL = 1e-10


def connect_mesh(etov: np.ndarray, face_vertices) -> np.ndarray:
    """Face-to-face connectivity by matching sorted face-vertex tuples.

    Returns FToF of shape [K, Nfaces] with FToF[e, f] = global id of the
    neighboring face (self for boundary faces).  Global face ids are
    e * Nfaces + f.
    """
    k = etov.shape[0]
    nfaces = len(face_vertices)
    fnodes = np.concatenate(
        [np.sort(etov[:, list(fv)], axis=1) for fv in face_vertices], axis=0
    )  # [Nfaces*K, nverts_per_face], face-major blocks
    # global ids in the same (face-major) order, then convert at the end
    gid_facemajor = np.arange(nfaces * k)
    order = np.lexsort(fnodes.T[::-1])
    sorted_nodes = fnodes[order]
    match = np.all(sorted_nodes[:-1] == sorted_nodes[1:], axis=1)

    ftof = gid_facemajor.copy()
    a = order[:-1][match]
    b = order[1:][match]
    ftof[a] = gid_facemajor[b]
    ftof[b] = gid_facemajor[a]

    # face-major id = f*K + e  ->  element-major id = e*Nfaces + f
    def to_elem_major(ids):
        f, e = np.divmod(ids, k)
        return e * nfaces + f

    ftof_elem = np.empty(nfaces * k, dtype=np.int64)
    ftof_elem[to_elem_major(gid_facemajor)] = to_elem_major(ftof)
    return ftof_elem.reshape(k, nfaces)


def build_node_maps(xf_list, ftof: np.ndarray, nfp: int):
    """Match face nodes across faces by physical coordinates.

    Args:
      xf_list: tuple of coordinate arrays, each [Nfaces*Nfp, K]
               (face-node traces, rows grouped by face).
      ftof:    [K, Nfaces] from connect_mesh.
      nfp:     nodes per face.

    Returns (mapM, mapP, mapB): mapM/mapP of shape [Nfaces*Nfp, K] holding
    flat indices node + (Nfaces*Nfp)*elem; mapB = flat boundary indices.
    """
    k, nfaces = ftof.shape
    nft = nfaces * nfp

    # coords per global face: [K*Nfaces, Nfp, dim]
    coords = np.stack(
        [np.asarray(x).reshape(nfaces, nfp, k).transpose(2, 0, 1).reshape(-1, nfp)
         for x in xf_list],
        axis=-1,
    )
    flat_ftof = ftof.reshape(-1)
    my = coords  # [F, Nfp, d]
    nb = coords[flat_ftof]  # neighbor face coords

    # pairwise L1 distance within each face pair: [F, Nfp(self), Nfp(nb)]
    dist = np.abs(my[:, :, None, :] - nb[:, None, :, :]).sum(axis=-1)
    # scale-invariant threshold, with an absolute fallback for single-node
    # faces (1D) whose in-face spread is zero
    global_mag = max(float(np.abs(coords).max()), 1.0)
    scale = np.maximum(dist.max(axis=(1, 2), keepdims=True), global_mag)
    matched = dist <= _NODETOL * scale
    # each self node must match exactly one neighbor node
    counts = matched.sum(axis=2)
    if not np.all(counts == 1):
        bad = np.argwhere(counts != 1)
        raise ValueError(f"face-node matching failed at (face,node) {bad[:5]}")
    idp = matched.argmax(axis=2)  # [F, Nfp] neighbor-local node index

    # mapM: flat id of (elem, face, node)
    gface = np.arange(k * nfaces)
    elem_self = gface // nfaces
    face_self = gface % nfaces
    elem_nb = flat_ftof // nfaces
    face_nb = flat_ftof % nfaces

    node_ids = np.arange(nfp)
    map_m = (face_self[:, None] * nfp + node_ids[None, :]) + nft * elem_self[:, None]
    map_p = (face_nb[:, None] * nfp + idp) + nft * elem_nb[:, None]

    is_boundary = flat_ftof == gface
    map_p[is_boundary] = map_m[is_boundary]

    # reshape to [Nfaces*Nfp, K]
    def to_trace_layout(m):
        return m.reshape(k, nfaces * nfp).T.copy()

    map_m_t = to_trace_layout(map_m)
    map_p_t = to_trace_layout(map_p)
    map_b = np.flatnonzero(map_m_t.T.ravel() == map_p_t.T.ravel())
    # mapB as flat ids (node + nft*elem), sorted
    map_b = np.sort(map_m_t.T.ravel()[map_b])
    return map_m_t, map_p_t, map_b


def make_periodic(xf_list, domain_lengths, ftof: np.ndarray, map_p: np.ndarray,
                  nfp: int, axes=None):
    """Rewrite mapP (and FToF) so opposite domain boundaries are identified.

    Args:
      xf_list: coordinate traces, each [Nfaces*Nfp, K].
      domain_lengths: (LX, LY[, LZ]).
      axes: which axes to periodicize (default: all).

    Returns (mapP, FToF) updated copies.
    """
    dim = len(xf_list)
    axes = tuple(range(dim)) if axes is None else tuple(axes)
    k, nfaces = ftof.shape
    nft = ftof.shape[1] * nfp

    map_p = map_p.copy()
    ftof = ftof.copy()
    flat_ftof = ftof.reshape(-1)

    gface = np.arange(k * nfaces)
    bfaces = np.flatnonzero(flat_ftof == gface)
    if len(bfaces) == 0:
        return map_p, ftof

    coords = np.stack(
        [np.asarray(x).reshape(nfaces, nfp, k).transpose(2, 0, 1).reshape(-1, nfp)
         for x in xf_list],
        axis=-1,
    )  # [F, Nfp, d]
    bc = coords[bfaces]  # boundary faces only
    cent = bc.mean(axis=1)  # [Nb, d]

    tol = _NODETOL * max(domain_lengths)
    for ax in axes:
        length = domain_lengths[ax]
        lo, hi = cent[:, ax].min(), cent[:, ax].max()
        on_lo = np.abs(cent[:, ax] - lo) < tol
        on_hi = np.abs(cent[:, ax] - hi) < tol
        idx_lo = np.flatnonzero(on_lo)
        idx_hi = np.flatnonzero(on_hi)
        if len(idx_lo) == 0:
            continue
        # match centroids in the other coordinates
        other = [a for a in range(dim) if a != ax]
        lo_keys = cent[idx_lo][:, other]
        hi_keys = cent[idx_hi][:, other]
        d = np.abs(lo_keys[:, None, :] - hi_keys[None, :, :]).sum(axis=-1) \
            if other else np.zeros((len(idx_lo), len(idx_hi)))
        partner = d.argmin(axis=1)
        if other and not np.all(d[np.arange(len(idx_lo)), partner] < tol):
            raise ValueError(f"periodic face matching failed on axis {ax}")

        for i_lo, i_hi in zip(idx_lo, idx_hi[partner]):
            for a_idx, b_idx in ((i_lo, i_hi), (i_hi, i_lo)):
                fa, fb = bfaces[a_idx], bfaces[b_idx]
                # node matching by coords in 'other' axes
                pa = coords[fa][:, other]
                pb = coords[fb][:, other]
                if other:
                    dd = np.abs(pa[:, None, :] - pb[None, :, :]).sum(axis=-1)
                    ids = dd.argmin(axis=1)
                    if not np.all(dd[np.arange(nfp), ids] < tol):
                        raise ValueError("periodic node matching failed")
                else:
                    ids = np.zeros(nfp, dtype=np.int64)

                ea, fla = divmod(fa, nfaces)
                eb, flb = divmod(fb, nfaces)
                rows_a = fla * nfp + np.arange(nfp)
                map_p[rows_a, ea] = (flb * nfp + ids) + nft * eb
                flat_ftof[fa] = fb

    return map_p, flat_ftof.reshape(k, nfaces)
