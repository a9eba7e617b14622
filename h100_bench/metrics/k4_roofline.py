"""K4 at dim 3 on the device-bound cavity (``ops.surface_viscous.cns_surface_viscous``,
``cns_surface_viscous_kernel``, tail folded): the data-sheet bound of one
launch over its device time, %."""
from h100_bench.layers import roofline, roofline_share

PREFIX = "cns_surface_viscous_kernel"


def read(trace):
    return roofline_share(trace, PREFIX, roofline.k4_bound)
