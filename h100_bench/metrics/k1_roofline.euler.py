"""K1 on the Euler cells (``ops.fused_volume.euler_volume``,
``hex_volume_kernel``): the data-sheet bound of one launch over its
device time, %."""
from h100_bench.layers import roofline, roofline_share

PREFIX = "hex_volume_kernel"


def read(trace):
    return roofline_share(trace, PREFIX, roofline.k1_bound)
