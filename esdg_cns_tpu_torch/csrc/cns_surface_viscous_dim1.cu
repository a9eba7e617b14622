// K4 (cns_surface_viscous.cuh) at DIM 1, for the entry
// esdg_cns_surface_viscous in cns_surface_viscous.cu.
#include "cns_surface_viscous.cuh"

template int esdg::surface_viscous_dim<float, 1>(ESDG_SURFACE_VISCOUS_ARGS);
template int esdg::surface_viscous_dim<double, 1>(ESDG_SURFACE_VISCOUS_ARGS);
