"""Carry state and operators across from the JAX package as numpy.

The port never imports JAX; a caller that holds a JAX ``Discretization``
hands its leaves over as numpy arrays (``np.asarray``) and its static
fields as plain Python values, and gets the port's ``Discretization``
with the same bits (in f64) on the requested device.  The tests use this
to feed both packages the same operators.
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


def state_from_numpy(a, *, device, dtype: torch.dtype) -> torch.Tensor:
    """numpy state [Nf, Np, K] -> tensor (a copy) on ``device`` in ``dtype``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state_to_numpy(q: torch.Tensor) -> np.ndarray:
    """tensor state -> numpy array on the host."""
    return q.detach().cpu().numpy()
