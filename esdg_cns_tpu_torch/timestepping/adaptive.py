"""Adaptive embedded DOPRI45 with PI step-size control, as a Python loop.

Port of ``esdg_cns_tpu/timestepping/adaptive.py``, with its whole
contract: the Dormand-Prince 5(4) pair with FSAL, the Hairer seminorm
error estimate, accept-if-err<1, the PI controller
dt_new = 0.8 dt (0.9/err)^(0.4/(p+1)) (prev/err)^(0.3/(p+1)) clamped to
[dt_min, dt_max_factor * base] (base = ``dt_clamp_base`` or dt0), a
non-finite error estimate counted as a rejection, the ``max_stuck``
bail-out with ``stats['stalled']``, and the ``max_records`` /
``record_every`` history (reference dg2D_CNS_cavity_optimized.jl:919-1053).

The TPU package runs the whole trajectory as one ``lax.while_loop``.  Here
the stages run on the state's device and the step-size controller on the
host: each step synchronises once, to read the error estimate that
decides acceptance.  The controller's scalars are NumPy scalars of the
state's dtype, so its arithmetic rounds as the TPU package's does.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

# Dormand-Prince 5(4) tableau
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = (3 / 40, 9 / 40)
_A[3, :3] = (44 / 45, -56 / 15, 32 / 9)
_A[4, :4] = (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729)
_A[5, :5] = (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656)
_A[6, :6] = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
_C = np.array([0.0, 0.2, 0.3, 0.8, 8 / 9, 1.0, 1.0])
# b - bhat: evolves the embedded error estimate
_E = np.array([
    71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40,
])
_ORDER = 5


def _combine(coef, ks):
    """sum_j coef[j] ks[j], in the order of the TPU package's Python sum."""
    acc = float(coef[0]) * ks[0]
    for c, k in zip(coef[1:], ks[1:]):
        acc = acc + float(c) * k
    return acc


def dopri45(
    rhs: Callable,
    q0,
    t_end: float,
    dt0: float,
    *,
    t0: float = 0.0,
    err_tol: float = 1e-5,
    dt_min: float = 1e-9,
    dt_max_factor: float = 10.0,
    max_stuck: int = 100,
    max_records: int = 0,
    record_every: int = 1,
    dt_clamp_base=None,
):
    """Integrate dq/dt = rhs(q, t) adaptively to t_end.

    ``rhs(q, t) -> (dq, aux)`` with aux a dict of scalar tensors.  Returns
    (q_final, stats) with stats {'t', 'dt', 'n_accepted', 'n_rejected',
    'stalled', *aux of the last accepted step} ('t', 'dt' floats, counts
    ints, 'stalled' a bool), and with ``max_records > 0`` also
    'n_records' and 'history': every ``record_every``-th ACCEPTED step
    writes (t, dt, err, *aux scalars) into [max_records] tensors of the
    state's dtype on its device, NaN-padded; recording stops silently when
    the buffer is full.

    ``dt_clamp_base``: base step for the [dt_min, dt_max_factor * base]
    clamp when it differs from ``dt0`` (chunked or resumed runs pass the
    run-global initial step here and seed ``dt0`` with the carried step).

    A non-finite error estimate (a NaN state) counts as a rejection with
    the error 1e6, so the controller shrinks dt instead of inheriting NaN;
    ``max_stuck`` consecutive rejections at the dt floor end the loop
    (``stats['stalled']``), and the returned state is the last accepted one.

    One host synchronisation per step (the error estimate); the TPU
    package's loop is one ``lax.while_loop`` on the device.
    """
    dtype = q0.dtype
    S = np.float32 if dtype == torch.float32 else np.float64
    # the tableau rounded to the state dtype, as the TPU package casts it
    a = _A.astype(S)
    c = _C.astype(S)
    e = _E.astype(S)
    t_end = S(t_end)
    base = S(dt0 if dt_clamp_base is None else dt_clamp_base)
    dt_lo, dt_hi = S(dt_min), S(dt_max_factor) * base
    floor = S(dt_min * (1 + 1e-6))

    t = S(t0)
    dt_s = S(dt0)
    prev_err = S(1.0)
    q = q0
    k1, last_aux = rhs(q0, float(t))
    n_acc = n_rej = n_stuck = 0
    rec_keys = ([k for k, v in last_aux.items() if v.ndim == 0]
                + ["t", "dt", "err"])
    records = []

    while t < t_end and n_stuck < max_stuck:
        dt = min(dt_s, t_end - t)
        ks = [k1]
        aux = last_aux
        for i in range(1, 7):
            qi = q + float(dt) * _combine(a[i, :i], ks)
            ki, aux = rhs(qi, float(t + c[i] * dt))
            ks.append(ki)
        q_new = qi                      # the stage-7 argument
        err_vec = _combine(e, ks)
        scale = err_tol * (1.0 + torch.abs(q))
        err = S(torch.sqrt(torch.mean((float(dt) * err_vec / scale) ** 2))
                .item())
        if not math.isfinite(err):
            err = S(1e6)
        err = min(max(err, S(1e-14)), S(1e6))

        accept = bool(err < 1.0)
        if accept:
            q, t, k1 = q_new, t + dt, ks[6]   # FSAL
            last_aux = aux

        dtnew = S(0.8) * dt * (S(0.9) / err) ** S(0.4 / (_ORDER + 1))
        dtnew = dtnew * (prev_err / err) ** S(0.3 / (_ORDER + 1))
        dtnew = min(max(dtnew, dt_lo), dt_hi)
        # an accepted stub step to t_end must not collapse the carried dt
        if accept and dt < dt_s:
            dtnew = max(dtnew, dt_s)
        if accept:
            n_stuck = 0
        elif dtnew <= floor:
            n_stuck += 1

        if (max_records and accept and n_acc % record_every == 0
                and len(records) < max_records):
            records.append({**{k: last_aux[k] for k in rec_keys[:-3]},
                            "t": t, "dt": dt, "err": err})
        n_acc += int(accept)
        n_rej += int(not accept)
        dt_s, prev_err = dtnew, err

    stats = {"t": float(t), "dt": float(dt_s), "n_accepted": n_acc,
             "n_rejected": n_rej, "stalled": n_stuck >= max_stuck,
             **last_aux}
    if max_records:
        hist = {}
        for key in rec_keys:
            col = torch.full((max_records,), float("nan"), dtype=dtype,
                             device=q0.device)
            for i, r in enumerate(records):
                col[i] = float(r[key]) if key in ("t", "dt", "err") \
                    else r[key]
            hist[key] = col
        stats["n_records"] = len(records)
        stats["history"] = hist
    return q, stats
