"""Carry state and operators across from the JAX package as numpy.

The port never imports JAX; a caller that holds a JAX ``Discretization``
hands its leaves over as numpy arrays (``np.asarray``) and its static
fields as plain Python values, and gets the port's ``Discretization``
with the same bits (in f64) on the requested device; likewise a JAX
``WallBC`` becomes the port's (``wall_bc_from_arrays``).  The tests use
this to feed both packages the same operators and boundary conditions.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.discretization import (
    ARRAY_FIELDS,
    META_FIELDS,
    TUPLE_FIELDS,
    Discretization,
)
from .ops.tensor_product_fd import LineOps
from .solvers.boundary import Region, WallBC


def _line_ops(lo):
    """Any object with LineOps' fields (the JAX LineOps) -> port LineOps."""
    if lo is None or isinstance(lo, LineOps):
        return lo
    return LineOps(n1d=int(lo.n1d), s1=tuple(map(tuple, lo.s1)),
                   e_minus=tuple(lo.e_minus), e_plus=tuple(lo.e_plus),
                   w1=tuple(lo.w1))


def discretization_from_arrays(arrays: dict, meta: dict, *, device,
                               dtype: torch.dtype) -> Discretization:
    """Build the port's Discretization from numpy leaves and static fields.

    arrays: every name in ``ARRAY_FIELDS``; a tuple-valued field
      (``TUPLE_FIELDS``) is given stacked along a leading direction axis
      (what ``np.asarray`` makes of the JAX tuple) or as a sequence.
    meta: every name in ``META_FIELDS``.
    Float arrays go to ``dtype``; ``map_p`` stays int32, ``bmask`` bool.
    """
    missing = [f for f in ARRAY_FIELDS if f not in arrays]
    missing += [f for f in META_FIELDS if f not in meta]
    if missing:
        raise KeyError(f"discretization_from_arrays: missing {missing}")

    def conv(name, a):
        a = np.asarray(a)
        if name == "map_p":
            return torch.tensor(a.astype(np.int32), device=device)
        if name == "bmask":
            return torch.tensor(a.astype(bool), device=device)
        return torch.tensor(a, dtype=dtype, device=device)

    fields = {}
    for name in ARRAY_FIELDS:
        a = arrays[name]
        if name in TUPLE_FIELDS:
            fields[name] = tuple(conv(name, ai) for ai in a)
        else:
            fields[name] = conv(name, a)
    for name in META_FIELDS:
        fields[name] = meta[name]
    fields["line_ops"] = _line_ops(meta["line_ops"])
    fields["periodic_axes"] = tuple(meta["periodic_axes"])
    if meta["grid_shape"] is not None:
        fields["grid_shape"] = tuple(meta["grid_shape"])
    return Discretization(**fields)


def wall_bc_from_arrays(regions, nhat, bmask, dim: int, *, device,
                        dtype: torch.dtype) -> WallBC:
    """Build the port's WallBC from a WallBC's leaves as numpy.

    regions: one mapping per region, in order, with 'kind', 'mask' (bool
      [Nfq, K]), 'u_wall' (per direction a Python float or an [Nfq, K]
      array), 'theta' (float, array or None) and, for 'dirichlet'
      regions, 'state' and optionally 'entropy_state': the ghost traces
      [Nf, Nfq, K] evaluated at the time of interest (they become
      constant in t).
    nhat: dim unit-normal arrays [Nfq, K]; bmask: bool [Nfq, K].
    """
    def arr(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def value(v):
        return v if v is None or isinstance(v, (int, float)) else arr(v)

    def const(a):
        if a is None:
            return None
        a = arr(a)
        return lambda t: a

    out = []
    for r in regions:
        out.append(Region(
            mask=torch.tensor(np.asarray(r["mask"]).astype(bool),
                              device=device),
            kind=r["kind"], u_wall=tuple(value(c) for c in r["u_wall"]),
            theta=value(r.get("theta")), state=const(r.get("state")),
            entropy_state=const(r.get("entropy_state"))))
    return WallBC(regions=tuple(out), nhat=tuple(arr(n) for n in nhat),
                  bmask=torch.tensor(np.asarray(bmask).astype(bool),
                                     device=device), dim=dim)


def state_from_numpy(a, *, device, dtype: torch.dtype) -> torch.Tensor:
    """numpy state [Nf, Np, K] -> tensor (a copy) on ``device`` in ``dtype``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state_to_numpy(q: torch.Tensor) -> np.ndarray:
    """tensor state -> numpy array on the host."""
    return q.detach().cpu().numpy()
