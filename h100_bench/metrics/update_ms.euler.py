"""The stepper's update on the Euler cells: device ms a stage of the
operations LSRK45 launches outside the RHS."""
from h100_bench.layers import update_ms as read  # noqa: F401
