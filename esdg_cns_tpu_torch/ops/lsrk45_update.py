"""LSRK45's two updates of a stage, as one kernel.

``lsrk45_update`` (CUDA ``csrc/lsrk45_update.cu``) computes

    res_new = A res + dt dq,   q_new = q + B res_new

in one pass: q, dq and res read (res not at the first stage), res
written in place and q_new into a new tensor, so a stage's input q is
never overwritten.  It replaces no TPU kernel: the TPU package's jnp
update is fused by XLA, while the same two lines in PyTorch are five
kernels and twelve passes over the state.  ``lsrk45_update_plain`` is
those lines, the CPU path; on CUDA tensors the wrapper launches the
kernel or raises (float32 or float64, contiguous, one shape; a pointer
off 16-byte alignment takes the kernel's one-value-a-thread form).  The
kernel repeats the plain arithmetic operation by operation (no FMA
contraction), so the two agree bitwise.
``lsrk45_update.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from .fused_volume import _DTYPE_CODE, _check_cuda, _check_shape, _raise_on


def lsrk45_update_plain(q, res, dq, a, b, dt, first):
    """(q_new, res_new) by PyTorch expressions.  At the first stage res is
    not read: dt dq + 0.0 is a res + dt dq at res = 0 (the + 0.0 turns
    -0 into +0, as adding a zero res does)."""
    res = dt * dq + 0.0 if first else a * res + dt * dq
    return q + b * res, res


def lsrk45_update(q, res, dq, a, b, dt, first):
    """One stage's update: (q_new, res_new), res_new being res updated in
    place where the kernel runs.  a, b, dt: Python floats, rounded to the
    state's dtype; first: True at a step's first stage, where res is
    written and not read."""
    if q.device.type != "cuda":
        return lsrk45_update_plain(q, res, dq, a, b, dt, first)
    name = "lsrk45_update"
    _check_cuda(name, {"q": q, "res": res, "dq": dq}, q.dtype, q.device)
    for key, t in (("res", res), ("dq", dq)):
        _check_shape(name, key, t, q.shape)
    from ..kernels import library

    q_new = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = library().esdg_lsrk45_update(
            _DTYPE_CODE[q.dtype], int(first), q.data_ptr(), res.data_ptr(),
            dq.data_ptr(), q_new.data_ptr(), q.numel(), float(a), float(b),
            float(dt), stream)
    _raise_on(name, rc)
    lsrk45_update.launches += 1
    return q_new, res


lsrk45_update.launches = 0
