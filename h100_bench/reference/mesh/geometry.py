"""Geometric factors (metric terms) for mapped elements.

Capability parity with reference ``src/geometric_factors.jl`` (2D :16,
3D curl-form :34).  The 3D construction follows Kopriva's curl form so
that discrete metric identities hold (free-stream preservation on curved
hexes); the 2D cross form satisfies them automatically for any mapping
representable in the nodal basis.

Inputs are nodal coordinates [Np, K] and differentiation matrices.
"""

from __future__ import annotations

import numpy as np


def geometric_factors_2d(x, y, dr, ds):
    """Returns (rxJ, sxJ, ryJ, syJ, J), each [Np, K]."""
    xr, xs = dr @ x, ds @ x
    yr, ys = dr @ y, ds @ y
    j = -xs * yr + xr * ys
    return ys, -yr, -xs, xr, j


def geometric_factors_3d(x, y, z, dr, ds, dt, filters=None):
    """Curl-form metric terms (Kopriva 2006) ensuring discrete
    free-stream preservation.  Returns
    (rxJ, sxJ, txJ, ryJ, syJ, tyJ, rzJ, szJ, tzJ, J), each [Np, K].

    ``filters``: optional (Fr, Fs, Ft) matrices applied to the curl
    arguments (Da)*b before differentiating, for over-integrated /
    aliasing-filtered geometry (reference src/geometric_factors.jl:34,43
    ``Filters=(I,I,I)``).  Because the outer curl acts on the FILTERED
    fields, the discrete metric identities (free-stream preservation)
    hold for any choice of filters representable in the nodal basis.
    """
    d = (dr, ds, dt)
    fr_m, fs_m, ft_m = (None, None, None) if filters is None else filters

    def curl_terms(a, b):
        """Metric triple from the curl of (Da) * b along each direction."""
        fr, fs, ft = (dr @ a) * b, (ds @ a) * b, (dt @ a) * b
        if filters is not None:
            fr, fs, ft = fr_m @ fr, fs_m @ fs, ft_m @ ft
        c_r = dt @ fs - ds @ ft
        c_s = dr @ ft - dt @ fr
        c_t = ds @ fr - dr @ fs
        return c_r, c_s, c_t

    rxj, sxj, txj = curl_terms(y, z)
    ryj, syj, tyj = (-m for m in curl_terms(x, z))
    rzj, szj, tzj = (-m for m in curl_terms(y, x))

    xr, xs, xt = (di @ x for di in d)
    yr, ys, yt = (di @ y for di in d)
    zr, zs, zt = (di @ z for di in d)
    j = (
        xr * (ys * zt - zs * yt)
        - yr * (xs * zt - zs * xt)
        + zr * (xs * yt - ys * xt)
    )
    return rxj, sxj, txj, ryj, syj, tyj, rzj, szj, tzj, j
