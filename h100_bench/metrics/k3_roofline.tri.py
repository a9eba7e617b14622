"""K3 at dim 2 on the 2D cavity (``ops.modal_volume.euler_modal_volume``;
the program's span around its launch): the data-sheet bound of one
launch (``roofline_tri.k3_bound``) over the span's device ms a launch, %.
A tree without the span gives None."""
from h100_bench.roofline_tri import k3_bound
from h100_bench.spans import roofline_share, span_ms

SPAN = "ops.modal_volume.euler_modal_volume"


def read(trace):
    ctx = trace.context
    return roofline_share(k3_bound(ctx["n"], ctx["num_elements"]).ms,
                          span_ms(trace, SPAN, per="call"))
