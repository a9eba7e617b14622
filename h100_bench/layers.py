"""Readers shared by the per-layer metrics (``metrics/*.py``): each takes
a ``devtrace.Trace`` and returns the metric's value or None when the
trace holds nothing to read."""

from __future__ import annotations

from . import roofline


def host_enqueue_ms(trace):
    """Host ms to enqueue one stage while the stream sleeps."""
    return trace.enqueue_ms


def rhs_ms(trace):
    """Device ms a stage of the operations the RHS launched."""
    return trace.device_ms_per_stage(True)


def update_ms(trace):
    """Device ms a stage of the operations launched outside the RHS: the
    stepper's updates."""
    return trace.device_ms_per_stage(False)


def idle_share(trace):
    """The device's idle share over the steady steps, in %."""
    share = trace.idle_share()
    return None if share is None else 100.0 * share


def roofline_share(trace, prefix, bound_fn):
    """100 x the bound of one launch (``bound_fn(n, K)``, ms) over the
    kernel's mean device time a launch, in %; None when the kernel did
    not run."""
    found = trace.kernel(prefix)
    if found is None:
        return None
    seconds, launches = found
    ctx = trace.context
    b = bound_fn(ctx["n"], ctx["num_elements"])
    return 100.0 * b.ms / (seconds * 1e3 / launches)


__all__ = ["host_enqueue_ms", "idle_share", "rhs_ms", "roofline",
           "roofline_share", "update_ms"]
