"""K4 at dim 2 on the 2D cavity, with the projection and the tail folded
(``ops.surface_viscous.cns_surface_viscous``; the program's span around
its launch): the data-sheet bound of one launch
(``roofline_tri.k4_bound``) over the span's device ms a launch, %.  A
tree without the span gives None."""
from h100_bench.roofline_tri import k4_bound
from h100_bench.spans import roofline_share, span_ms

SPAN = "ops.surface_viscous.cns_surface_viscous"


def read(trace):
    ctx = trace.context
    return roofline_share(k4_bound(ctx["n"], ctx["num_elements"]).ms,
                          span_ms(trace, SPAN, per="call"))
