// K3 (modal_volume.cuh) at DIM 1, for the entry esdg_modal_volume in
// tri_modal_volume.cu.
#include "modal_volume.cuh"

template int esdg::modal_volume_dim<float, 1>(ESDG_MODAL_ARGS);
template int esdg::modal_volume_dim<double, 1>(ESDG_MODAL_ARGS);
