"""K1's curved form (``ops.fused_volume.euler_volume`` on geo [9, Nh, K];
the program's span around its launch): the data-sheet bound of one
launch over the span's device ms a launch, %.  A tree without the span
gives None."""
from h100_bench import roofline
from h100_bench.spans import roofline_share, span_ms

SPAN = "ops.fused_volume.euler_volume"


def bound(n, k):
    """K1 (curved) on one stage: q [5, Nq, K], the metric rows it reads
    of geo [9, Nh, K] (all nine at the volume nodes, the three of the
    face's direction at each face point: ``csrc/line_fd.cuh``), Ef and
    LIFT in; ph_qf [5, Nq, K] and the traces [7, Nfq, K] out; the pairs
    at the curved cost (``roofline.ops_k1``, form 'curved')."""
    op = roofline.hex_operators(n)
    nq, nfq = op["nq"], op["nfq"]
    rows = 5 * nq + 9 * nq + 3 * nfq + 5 * nq + 7 * nfq
    n_bytes = (rows * k + op["ef"].size + op["lift"].size) * roofline.ITEM
    ops = roofline.ops_k1(n + 1, roofline.entries(op["ef"]),
                          roofline.entries(op["lift"]), form="curved") * k
    return roofline.bound(n_bytes, ops)


def read(trace):
    ctx = trace.context
    return roofline_share(bound(ctx["n"], ctx["num_elements"]).ms,
                          span_ms(trace, SPAN, per="call"))
