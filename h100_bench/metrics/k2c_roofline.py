"""K2's general grid form (``ops.fused_volume.euler_surface`` with the
normal [3, Nfq, K], the neighbours read on the periodic grid; the
program's span around its launch): the data-sheet bound of one launch
over the span's device ms a launch, %.  A tree without the span gives
None."""
from h100_bench import roofline
from h100_bench.spans import roofline_share, span_ms

SPAN = "ops.fused_volume.euler_surface"


def bound(n, k):
    """K2 (general, grid) on one stage: the traces [7, Nfq, K] (the
    neighbours' are the same array), nxj [3, Nfq, K], sj and 1/sj
    [Nfq, K], 1/J [Nq, K], ph_qf [5, Nq, K] and LIFT in; dq [5, Nq, K]
    out; ``roofline.ops_k2`` in its general form."""
    op = roofline.hex_operators(n)
    nq, nfq = op["nq"], op["nfq"]
    rows = 7 * nfq + 3 * nfq + 2 * nfq + nq + 5 * nq + 5 * nq
    n_bytes = (rows * k + op["lift"].size) * roofline.ITEM
    ops = roofline.ops_k2(n + 1, roofline.entries(op["lift"]),
                          diag=False) * k
    return roofline.bound(n_bytes, ops)


def read(trace):
    ctx = trace.context
    return roofline_share(bound(ctx["n"], ctx["num_elements"]).ms,
                          span_ms(trace, SPAN, per="call"))
