// K2's entry point, with the line lengths N+1 = 2..5 instantiated here;
// the kernel is hex_surface.cuh, N+1 = 6, 7, 8 are hex_surface6/7/8.cu.
#include "hex_surface.cuh"

namespace esdg {
extern template int surface_order<6>(ESDG_SURFACE_ORDER_ARGS);
extern template int surface_order<7>(ESDG_SURFACE_ORDER_ARGS);
extern template int surface_order<8>(ESDG_SURFACE_ORDER_ARGS);
}  // namespace esdg

static int hex_surface(int dtype, int n1, int diag, int grid, int split,
                       int dissipation, const void* const* ptrs,
                       const int* dims, long long K, double gamma,
                       void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -2;
#define ESDG_SURFACE_CASE(N)                                               \
  case N:                                                                  \
    return esdg::surface_order<N>(dtype, diag, grid, split, ptrs, dims, K, \
                                  gamma, dissipation, st, occ);
  switch (n1) {
    ESDG_SURFACE_CASE(2)
    ESDG_SURFACE_CASE(3)
    ESDG_SURFACE_CASE(4)
    ESDG_SURFACE_CASE(5)
    ESDG_SURFACE_CASE(6)
    ESDG_SURFACE_CASE(7)
    ESDG_SURFACE_CASE(8)
    default:
      return -1;
  }
#undef ESDG_SURFACE_CASE
}

// dtype: 0 = float32, 1 = float64.  ptrs: void*[14] = tr, nbr, nxj, sj,
// isj, inv_jac, lift, phqf, part0, part1, part2, iw, iwf, out
// (hex_surface.cuh's SurfaceArgs; the ones a form does not read may be
// null); dims: the grid (kx, ky, kz), read by the grid form only.  Returns cudaGetLastError()
// after the launch, -1 for an unsupported line length n1, -2 for an
// unknown dtype.
extern "C" int esdg_hex_surface(int dtype, int n1, int diag, int grid,
                                int split, int dissipation,
                                const void* const* ptrs, const int* dims,
                                long long K, double gamma, void* stream) {
  return hex_surface(dtype, n1, diag, grid, split, dissipation, ptrs, dims,
                     K, gamma, stream, nullptr);
}

// The launch shape of one form (common.cuh's launch_shape: occ[7]);
// returns as esdg_hex_surface.
extern "C" int esdg_hex_surface_shape(int dtype, int n1, int diag, int grid,
                                      int split, int* occ) {
  return hex_surface(dtype, n1, diag, grid, split, 1, nullptr, nullptr, 0,
                     1.4, nullptr, occ);
}
