"""Explicit fixed-step time integrators as Python loops.

Port of ``esdg_cns_tpu/timestepping/explicit.py``:
  * LSRK45 — Carpenter-Kennedy low-storage 5-stage 4th order
    (coefficients src/CommonUtils.jl:29-49).
  * SSPRK33 — Shu-Osher 3-stage 3rd order.

The coefficients are host-side f64 and enter as Python floats, so an f32
state stays f32 and an f64 state gets full-f64 coefficient values.  The
step size is rounded to the state dtype first, as the JAX stepper does.
Per-step diagnostics (the ``aux`` of each step's last stage) come back
stacked.  LSRK45's update of a stage is one call of
``ops.lsrk45_update`` (a kernel on the card), which makes a new state at
every stage and leaves each stage's input as it was.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.lsrk45_update import lsrk45_update
from ..tracing import span

# Carpenter & Kennedy (1994) RK45(5,4) low-storage coefficients.
LSRK45_A = np.array([
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
])
LSRK45_B = np.array([
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
])
LSRK45_C = np.array([
    0.0,
    1432997174477.0 / 9575080441755.0,
    2526269341429.0 / 6820363962896.0,
    2006345519317.0 / 3224310063776.0,
    2802321613138.0 / 2924317926251.0,
])


def _stack_aux(per_step):
    """list of per-step aux dicts of scalar tensors -> dict of stacks."""
    if not per_step or not per_step[0]:
        return {}
    return {k: torch.stack([a[k] for a in per_step]) for k in per_step[0]}


def _state_dt(dt, q0):
    """dt rounded to the state dtype, as a Python float."""
    return torch.tensor(dt, dtype=q0.dtype).item()


def lsrk45(rhs: Callable, q0, dt, num_steps: int, t0=0.0):
    """Integrate dq/dt = rhs(q, t) with LSRK45.

    ``rhs(q, t) -> (dq, aux)``; aux is a dict of scalar tensors.
    Returns (q_final, stacked per-step aux from the last stage).
    """
    dt = _state_dt(dt, q0)
    # the update kernel takes contiguous states: q0 and an RHS's dq in
    # another layout are copied (a contiguous one is passed as it is)
    q = q0.contiguous()
    res = torch.empty_like(q)   # written at each first stage
    per_step = []
    for i in range(num_steps):
        t = t0 + i * dt
        aux_last = None
        with span("timestepping.explicit.lsrk45.step"):
            for s in range(5):
                dq, aux_last = rhs(q, t + float(LSRK45_C[s]) * dt)
                with span("timestepping.explicit.lsrk45.update"):
                    q, res = lsrk45_update(q, res, dq.contiguous(),
                                           float(LSRK45_A[s]),
                                           float(LSRK45_B[s]), dt, s == 0)
        per_step.append(aux_last)
    return q, _stack_aux(per_step)


def ssprk33(rhs: Callable, q0, dt, num_steps: int, t0=0.0):
    """Shu-Osher SSP RK(3,3); rhs(q, t) -> (dq, aux)."""
    dt = _state_dt(dt, q0)
    q = q0
    per_step = []
    for i in range(num_steps):
        t = t0 + i * dt
        d1, _ = rhs(q, t)
        q1 = q + dt * d1
        d2, _ = rhs(q1, t + dt)
        q2 = 0.75 * q + 0.25 * (q1 + dt * d2)
        d3, aux = rhs(q2, t + 0.5 * dt)
        q = q / 3.0 + 2.0 / 3.0 * (q2 + dt * d3)
        per_step.append(aux)
    return q, _stack_aux(per_step)
