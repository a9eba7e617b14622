"""The cavity's two face-trace exchanges a RHS (the program's
``core.discretization.gather_traces`` spans: the traces before the
surface stage, the contracted traction in the tail): device ms a
stage."""
from h100_bench.spans import span_ms

SPAN = "core.discretization.gather_traces"


def read(trace):
    return span_ms(trace, SPAN)
