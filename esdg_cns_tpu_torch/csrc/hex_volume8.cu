// K1 (hex_volume.cuh) at the line length N+1 = 8, with and without
// v(U), for the entry esdg_hex_volume in hex_volume.cu.
#include "hex_volume.cuh"

template int esdg::volume_order<8, false>(ESDG_VOLUME_ORDER_ARGS);
template int esdg::volume_order<8, true>(ESDG_VOLUME_ORDER_ARGS);
