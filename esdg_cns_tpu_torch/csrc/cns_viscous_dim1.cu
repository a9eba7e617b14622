// K7 (cns_viscous.cuh) at DIM 1, for the entry esdg_cns_viscous in
// cns_viscous.cu.
#include "cns_viscous.cuh"

template int esdg::viscous_dim<float, 1>(ESDG_VISCOUS_ARGS);
template int esdg::viscous_dim<double, 1>(ESDG_VISCOUS_ARGS);
