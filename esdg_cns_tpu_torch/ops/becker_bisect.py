"""Becker's viscous-shock velocity by bisection, as one kernel.

``becker_bisect`` (CUDA ``csrc/becker_bisect.cu``) solves the implicit
wave profile

    f(v) = -xi + c2 (a log(v0 - v) - b log(v - v1)) = 0

for v in the bracket [lo, hi] by ``iters`` halvings, one thread per
point.  It replaces no TPU kernel: the TPU package runs the same
``fori_loop`` fused under jit, while the eager loop here is some 1,400
small launches per call, which the Becker shock tubes make once per RHS
for their Dirichlet ghosts.  ``becker_bisect_plain`` is that eager loop,
which the wrapper takes for CPU tensors; for CUDA tensors it launches the
kernel or raises.  The kernel repeats the eager arithmetic operation by
operation (no FMA contraction), so the two agree bitwise.
``becker_bisect.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from .fused_volume import _DTYPE_CODE, _check_cuda, _raise_on


def becker_bisect_plain(xi, *, a, b, c2, v0, v1, lo, hi, iters=100):
    """The eager bisection: Python-float constants against tensors of
    xi's dtype, in the order of ``becker_bisect``'s kernel."""
    def f(v):
        return -xi + c2 * (a * torch.log(v0 - v) - b * torch.log(v - v1))

    lo = torch.full_like(xi, lo)
    hi = torch.full_like(xi, hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = f(mid) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    return 0.5 * (lo + hi)


def becker_bisect(xi, *, a, b, c2, v0, v1, lo, hi, iters=100):
    """v with f(v) = 0 at every point of xi (any shape), bisected from the
    bracket [lo, hi] (Python floats, rounded to xi's dtype) in ``iters``
    halvings; f decreases in v."""
    kw = dict(a=a, b=b, c2=c2, v0=v0, v1=v1, lo=lo, hi=hi, iters=iters)
    if xi.device.type == "cpu":
        return becker_bisect_plain(xi, **kw)
    if xi.device.type != "cuda":
        raise ValueError(f"becker_bisect: no kernel for device {xi.device}")
    name = "becker_bisect"
    xi = xi.contiguous()
    _check_cuda(name, {"xi": xi}, xi.dtype, xi.device)
    u = torch.empty_like(xi)
    if xi.numel() == 0:
        return u
    from ..kernels import library

    lib = library()
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream(xi.device).cuda_stream
        rc = lib.esdg_becker_bisect(
            _DTYPE_CODE[xi.dtype], xi.data_ptr(), u.data_ptr(), xi.numel(),
            float(a), float(b), float(c2), float(v0), float(v1), float(lo),
            float(hi), int(iters), stream)
    _raise_on(name, rc)
    becker_bisect.launches += 1
    return u


becker_bisect.launches = 0
