// The flux-differencing section (fd_section.cuh) at the line length
// N+1 = 7, for the entry esdg_fd_section in fd_section5.cu.
#include "fd_section.cuh"

template int esdg::fd_section_order<7>(ESDG_FD_SECTION_ORDER_ARGS);
