// K7 (cns_viscous.cuh) at DIM 3, for the entry esdg_cns_viscous in
// cns_viscous.cu.
#include "cns_viscous.cuh"

template int esdg::viscous_dim<float, 3>(ESDG_VISCOUS_ARGS);
template int esdg::viscous_dim<double, 3>(ESDG_VISCOUS_ARGS);
