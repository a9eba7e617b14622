// K3's entry point (the kernel is modal_volume.cuh), with DIM 2 (tris,
// affine and curved) instantiated here; DIM 1 and 3 are
// modal_volume_dim1.cu and _dim3.cu.
#include "modal_volume.cuh"

namespace esdg {
extern template int modal_volume_dim<float, 1>(ESDG_MODAL_ARGS);
extern template int modal_volume_dim<double, 1>(ESDG_MODAL_ARGS);
extern template int modal_volume_dim<float, 3>(ESDG_MODAL_ARGS);
extern template int modal_volume_dim<double, 3>(ESDG_MODAL_ARGS);

template <typename T>
int dispatch_modal_volume(int dim, ESDG_MODAL_ARGS) {
#define ESDG_MODAL_DIM(D)                                                   \
  if (dim == D)                                                             \
    return modal_volume_dim<T, D>(curved, q, geo, qs, vq, vhp, ph, out,     \
                                  traces, vuq, K, np, nq, nh, gamma,        \
                                  stream);
  ESDG_MODAL_DIM(1)
  ESDG_MODAL_DIM(2)
  ESDG_MODAL_DIM(3)
#undef ESDG_MODAL_DIM
  return -3;
}
}  // namespace esdg

// dtype: 0 = float32, 1 = float64; dim 1, 2 or 3 (NF = dim + 2 fields).
// q [NF, np, K], geo [dim^2, 1, K] or (curved = 1, dim 2 only)
// [4, nh, K], qs [dim, nh, nh], vq [nq, np], vhp [nh, nq], ph [np, nh];
// out [NF, np, K], traces [NF + 2, nh - nq, K], vuq [NF, nq, K].  Returns
// cudaGetLastError() after the launch, -1 when the tile does not fit in
// shared memory, -2 for an unknown dtype, -3 for a form not built (an
// unknown dim, or curved below or above dim 2).
extern "C" int esdg_modal_volume(int dtype, int dim, int curved,
                                 const void* q, const void* geo,
                                 const void* qs, const void* vq,
                                 const void* vhp, const void* ph, void* out,
                                 void* traces, void* vuq, long long K,
                                 int np, int nq, int nh, double gamma,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::dispatch_modal_volume<float>(dim, curved, q, geo, qs, vq,
                                              vhp, ph, out, traces, vuq, K,
                                              np, nq, nh, gamma, st);
  if (dtype == 1)
    return esdg::dispatch_modal_volume<double>(dim, curved, q, geo, qs, vq,
                                               vhp, ph, out, traces, vuq, K,
                                               np, nq, nh, gamma, st);
  return -2;
}
