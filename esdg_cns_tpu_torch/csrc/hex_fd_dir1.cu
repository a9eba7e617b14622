// Direction 1 of the split volume path's flux-differencing kernel
// (hex_split.cuh, entry esdg_hex_fd_dir in hex_split.cu).
#include "hex_split.cuh"

template int esdg::fd_dir_direction<1>(ESDG_FD_DIRECTION_ARGS);
