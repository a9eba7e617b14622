"""The split path's flux differencing (``ops.fused_volume.
euler_volume_split_parts`` -> ``hex_fd_dir_kernel``, one launch a
direction): the data-sheet bound of one direction over the launches'
mean device time, %."""
from h100_bench.layers import roofline, roofline_share

PREFIX = "hex_fd_dir_kernel"


def read(trace):
    return roofline_share(trace, PREFIX, roofline.fd_dir_bound)
