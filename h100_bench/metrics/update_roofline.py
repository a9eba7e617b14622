"""LSRK45's update on the Euler cells (the program's
``timestepping.explicit.lsrk45.update`` span: res = A res + dt dq,
q = q + B res): the data-sheet bound of one stage's update over the
device ms a stage of the operations launched in the span, %.  The bound
is the least traffic the update needs over the HBM peak: five passes
over a state of 5 Np K values (q, res and dq read, q and res written),
four at the first stage (A = 0 there, so res is not read): 24 passes
every 5 stages."""
from h100_bench import roofline
from h100_bench.spans import roofline_share, span_ms

SPAN = "timestepping.explicit.lsrk45.update"
PASSES_PER_STEP, STAGES = 24, 5


def bound(n, k):
    """The update's floor a stage, over a step, at degree n and K
    elements."""
    values = 5 * (n + 1) ** 3 * k
    return roofline.bound(PASSES_PER_STEP * values * roofline.ITEM // STAGES,
                          roofline.Ops())


def read(trace):
    ctx = trace.context
    return roofline_share(bound(ctx["n"], ctx["num_elements"]).ms,
                          span_ms(trace, SPAN))
