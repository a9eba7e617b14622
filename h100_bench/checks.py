"""The comparison that decides ``correct``: the program's outputs on the
sampled steps of the window against the plain float64 reference.

A sampled step keeps what the window's own call produced, by reference
and without a copy (the stepper makes a new state at every stage): each
stage's input q_s, the RHS the program returned at each, dq_s, and the
state after the step.  Two numbers come of them:

  rhs_gap   the RHS at the program's own stage inputs: for each field f,
            max |dq_f - R(q_s)_f| / max |R(q_s)_f|, the largest over the
            fields and the sampled stages (R the reference RHS in
            float64).  It covers the volume stage, the exchange, the
            surface stage and the wall states.
  step_gap  the step: the state the step returned against the
            reference's step of the configuration's stepper from the
            step's own input q0 in float64, for each field f,
            max |q_f - S(q0)_f| /
            max |S(q0)_f - q0_f|, the largest over the fields and the
            sampled steps.  It covers the stepper's updates with the RHS.

The reference follows the program step by step from the program's own
state (a step's input): it cannot follow thousands of steps within a
run's time.  The start is checked by itself: the first sampled step is
the first step from the start state the benchmark made.

Each is held to the cell's limit in ``workloads/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch


def field_gap(value, ref, scale=None):
    """max over the fields (axis 0) of max |value_f - ref_f| / max
    |scale_f| (scale defaults to ref), computed in float64.  A field whose
    scale is all zero is measured against the largest scale of the
    others."""
    f64 = torch.float64
    value, ref = value.to(f64), ref.to(f64)
    scale = ref if scale is None else scale.to(f64)
    nf = ref.shape[0]
    diff = (value - ref).abs().reshape(nf, -1).amax(1)
    size = scale.abs().reshape(nf, -1).amax(1)
    size = torch.where(size > 0, size, size.max())
    return float((diff / size).max())


class Sampler:
    """Chooses which window steps the check keeps: the first step from
    the start state, then ``keep`` steps drawn uniformly (reservoir
    sampling, from the seed) over all the steps of the window."""

    def __init__(self, seed, keep):
        self.rng = np.random.default_rng(seed)
        self.keep = keep
        self.seen = 0

    def offer(self):
        """Called once a window step: the slot (0..keep-1) the step takes
        or None."""
        self.seen += 1
        if self.seen <= self.keep:
            return self.seen - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.keep else None


class Recorder:
    """Wraps the program's RHS; while ``stages`` is a list, keeps each
    stage's (q_s, t_s, dq_s) there, and while ``annotate`` is set puts
    each call in the trace's RHS range.  The wrapper adds one Python call
    a stage and copies nothing."""

    def __init__(self, rhs):
        self.rhs = rhs
        self.stages = None
        self.annotate = False

    def __call__(self, q, t=0.0):
        if self.annotate:
            from torch.profiler import record_function

            from .devtrace import RHS_RANGE

            with record_function(RHS_RANGE):
                dq, aux = self.rhs(q, t)
        else:
            dq, aux = self.rhs(q, t)
        if self.stages is not None:
            self.stages.append((q, t, dq))
        return dq, aux


def compare(samples, ref_rhs, dt, reference_step, dtype=torch.float64):
    """(rhs_gap, step_gap) over the sampled steps.

    samples: [(stages, q_next)], a step's (q_s, t_s, dq_s) for each of its
    stages and the state the step returned.  ref_rhs(q, t) -> dq is the
    reference, evaluated in ``dtype``; reference_step(rhs, q, dt, t) the
    reference's step of the configuration's stepper.
    """
    rhs_gap = step_gap = 0.0
    f64 = torch.float64
    for stages, q_next in samples:
        for q_s, t_s, dq_s in stages:
            rhs_gap = max(rhs_gap, field_gap(dq_s, ref_rhs(q_s.to(dtype), t_s)))
        q0, t0 = stages[0][0], stages[0][1]
        q = reference_step(ref_rhs, q0.to(dtype), dt, t0).to(f64)
        step_gap = max(step_gap, field_gap(q_next, q, q - q0.to(f64)))
    return rhs_gap, step_gap
