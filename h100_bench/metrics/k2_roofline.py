"""K2 (``ops.fused_volume.euler_surface``, ``hex_surface_kernel``): the
data-sheet bound of one launch over its device time, %.  Where the split
front ran (``hex_fd_dir_kernel`` in the trace) K2 sums the three
direction parts, and its bound is the split form's."""
import functools

from h100_bench.layers import roofline, roofline_share

PREFIX = "hex_surface_kernel"
SPLIT_PREFIX = "hex_fd_dir_kernel"


def read(trace):
    split = trace.kernel(SPLIT_PREFIX) is not None
    return roofline_share(trace, PREFIX, functools.partial(
        roofline.k2_bound, split_form=split))
