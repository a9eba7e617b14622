"""The cavity's v(U) after the volume kernel (the program's
``solvers.cns_fused.entropy_vars`` span): device ms a stage."""
from h100_bench.spans import span_ms

SPAN = "solvers.cns_fused.entropy_vars"


def read(trace):
    return span_ms(trace, SPAN)
