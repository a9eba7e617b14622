// The flux-differencing section (fd_section.cuh) at the line length
// N+1 = 6, for the entry esdg_fd_section in fd_section5.cu.
#include "fd_section.cuh"

template int esdg::fd_section_order<6>(ESDG_FD_SECTION_ORDER_ARGS);
