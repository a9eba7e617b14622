"""Readers of the program's own spans (``esdg_cns_tpu_torch.tracing``)
for the per-layer metrics that time a layer where the work happens.

A recording torch profiler turns the program's spans on: each is a
``user_annotation`` range on the profiler's host timeline, in the trace's
``host_ops``.  A device operation belongs to the spans around its launch,
and a span's device time is the device time of the operations launched
inside it: kernel time alone, so the card's waits on the host inside a
span are not counted.  The operations are the traced window's steady
steps (``devtrace.Trace``: the first and last step left out), and a
reading is over the window's stages or over the span's calls that
launched something.  A tree without the span gives None.
"""

from __future__ import annotations

import bisect

# the benchmark's own ranges, not the program's
HARNESS = "h100_bench."


def launched(trace):
    """[(launch us, device us)] of the window's device operations.

    ``Trace`` keeps the launch times apart from its operations.  The
    program runs on one stream, where the k-th operation launched is the
    k-th to start, so the launch times in order pair with the operations
    in start order (the profiler's device clock may read a few us behind
    its host clock, so a start is not held against its launch); None
    where the counts differ."""
    launches = sorted(trace.launch_of.values())
    if len(launches) != len(trace.ops):
        return None
    return [(t, op[3]) for t, op in zip(launches, trace.ops)]


def program_spans(trace):
    """[(start us, end us, name)] of the program's spans, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in trace.host_ops
                  if e.get("cat") == "user_annotation"
                  and not e["name"].startswith(HARNESS))


def span_ms(trace, name, *, self_time=False, per="stage"):
    """Device ms of the operations launched inside the spans ``name``, a
    stage (``per="stage"``) or a call of the span (``per="call"``: the
    calls that launched something); with self_time, only those whose
    innermost span it is.  None where no operation was launched in such
    a span."""
    ops = launched(trace)
    if ops is None:
        return None
    spans = program_spans(trace)
    starts = [a for a, _, _ in spans]
    total, calls = 0.0, set()
    for t, dur in ops:
        # the spans around t, innermost first: of those starting by t,
        # the latest that ends after it
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            _, end, nm = spans[i]
            if end > t:
                if nm == name:
                    total += dur
                    calls.add(i)
                    break
                if self_time:
                    break
            i -= 1
    if not calls:
        return None
    return total / 1e3 / (trace.stages if per == "stage" else len(calls))


def roofline_share(bound_ms, ms):
    """100 x the bound over the measured ms, in %; None without a
    measurement."""
    return None if ms is None else 100.0 * bound_ms / ms
