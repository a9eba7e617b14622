// K4 (cns_surface_viscous.cuh) at DIM 3, for the entry
// esdg_cns_surface_viscous in cns_surface_viscous.cu.
#include "cns_surface_viscous.cuh"

template int esdg::surface_viscous_dim<float, 3>(ESDG_SURFACE_VISCOUS_ARGS);
template int esdg::surface_viscous_dim<double, 3>(ESDG_SURFACE_VISCOUS_ARGS);
