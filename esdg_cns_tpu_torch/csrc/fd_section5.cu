// The flux-differencing section's entry point, with the line length
// N+1 = 5 (the TPU study's default) instantiated here; the kernel is
// fd_section.cuh, N+1 = 6, 7 are fd_section6.cu and fd_section7.cu.
#include "fd_section.cuh"

namespace esdg {
extern template int fd_section_order<6>(ESDG_FD_SECTION_ORDER_ARGS);
extern template int fd_section_order<7>(ESDG_FD_SECTION_ORDER_ARGS);
}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  geo [9, 1, K] affine; diag takes one
// metric term per direction.  Returns cudaGetLastError() after the
// launch, -1 for a line length n1 that is not built (5, 6, 7 are), -2 for
// an unknown dtype.
extern "C" int esdg_fd_section(int dtype, int n1, int diag, const void* qh,
                               const void* qlog, const void* geo,
                               const void* cvol, const void* cface,
                               void* out, long long K, double gamma,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -2;
#define ESDG_FD_SECTION_CASE(N)                                             \
  case N:                                                                   \
    return esdg::fd_section_order<N>(dtype, diag, qh, qlog, geo, cvol,      \
                                     cface, out, K, gamma, st);
  switch (n1) {
    ESDG_FD_SECTION_CASE(5)
    ESDG_FD_SECTION_CASE(6)
    ESDG_FD_SECTION_CASE(7)
    default:
      return -1;
  }
#undef ESDG_FD_SECTION_CASE
}
