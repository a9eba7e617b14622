"""The cavity RHS's tail after K4 (the program's
``solvers.cns_fused.tail`` span: the production's sum, the traction BC,
the jump, its LIFT, the 1/J scaling and the add): self device ms a
stage, the exchange of the traction inside it left out."""
from h100_bench.spans import span_ms

SPAN = "solvers.cns_fused.tail"


def read(trace):
    return span_ms(trace, SPAN, self_time=True)
