"""Host dispatch of the device-bound cavity cells: host ms to enqueue one RK stage
(``lsrk45``, ``solvers.cns_fused`` and ``ops.cns_surface_bc``'s Python)
while the stream sleeps."""
from h100_bench.layers import host_enqueue_ms as read  # noqa: F401
