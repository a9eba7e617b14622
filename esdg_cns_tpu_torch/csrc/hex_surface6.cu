// K2 (hex_surface.cuh) at the line length N+1 = 6, for the entry
// esdg_hex_surface in hex_surface.cu.
#include "hex_surface.cuh"

template int esdg::surface_order<6>(ESDG_SURFACE_ORDER_ARGS);
