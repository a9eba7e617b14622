"""The split path's projection, row 3 (``ops.fused_volume.hex_project``,
``hex_project_kernel``; the program's span around its launch): the
data-sheet bound of one launch over the span's device ms a launch, %."""
from h100_bench import roofline
from h100_bench.spans import roofline_share, span_ms

SPAN = "ops.fused_volume.hex_project"


def bound(n, k):
    """Row 3 (diag) on one stage: q [5, Nq, K] and Ef in; the flux
    variables qh [5, Nh, K], their logs qlog [2, Nh, K] and the traces
    [7, Nfq, K] out; ``roofline.ops_project`` a element."""
    op = roofline.hex_operators(n)
    nq, nfq = op["nq"], op["nfq"]
    nh = nq + nfq
    rows = 5 * nq + 5 * nh + 2 * nh + 7 * nfq
    n_bytes = (rows * k + op["ef"].size) * roofline.ITEM
    ops = roofline.ops_project(n + 1, roofline.entries(op["ef"])) * k
    return roofline.bound(n_bytes, ops)


def read(trace):
    ctx = trace.context
    return roofline_share(bound(ctx["n"], ctx["num_elements"]).ms,
                          span_ms(trace, SPAN, per="call"))
