"""Entropy-balance reduction ``rhstest = sum(wJq * v * rhs)``.

Port of ``esdg_cns_tpu/utils/compensated.weighted_entropy_residual`` in
its ``native`` and ``f64`` modes.  The double-float ``compensated`` mode
exists for f32-only hardware; on a card with native f64 the ``f64`` mode
gives the same isolation of the diagnostic's own accumulation error.
"""

from __future__ import annotations

import torch


def weighted_entropy_residual(wjq, v, rhs, mode: str = "native"):
    """sum(wJq * v * rhs) at selectable accuracy.

    mode:
      'native' — plain sum in the state dtype.
      'f64'    — upcast the factors and sum in float64.
    """
    w = wjq[None] if wjq.ndim == v.ndim - 1 else wjq
    if mode == "native":
        return torch.sum(w * v * rhs)
    if mode == "f64":
        f64 = torch.float64
        return torch.sum(w.to(f64) * v.to(f64) * rhs.to(f64))
    raise ValueError(f"unknown rhstest mode: {mode!r}")
