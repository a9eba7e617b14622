"""The RHS of the device-bound cavity cells (``solvers.cns_fused``): device ms a stage
of the operations launched inside the RHS call."""
from h100_bench.layers import rhs_ms as read  # noqa: F401
