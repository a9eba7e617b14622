"""The device on the Euler cells: 1 - (union of the device operations'
intervals) / (first start to last end) over the traced steady steps, %."""
from h100_bench.layers import idle_share as read  # noqa: F401
