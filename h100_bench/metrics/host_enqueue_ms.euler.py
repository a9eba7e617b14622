"""Host dispatch of the Euler cells: host ms to enqueue one RK stage
(``timestepping.explicit.lsrk45`` and ``solvers.euler_fused``'s Python)
while the stream sleeps."""
from h100_bench.layers import host_enqueue_ms as read  # noqa: F401
