// K3 (modal_volume.cuh) at DIM 3, for the entry esdg_modal_volume in
// tri_modal_volume.cu.
#include "modal_volume.cuh"

template int esdg::modal_volume_dim<float, 3>(ESDG_MODAL_ARGS);
template int esdg::modal_volume_dim<double, 3>(ESDG_MODAL_ARGS);
