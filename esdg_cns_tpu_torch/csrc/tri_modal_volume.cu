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
    return modal_volume_dim<T, D>(curved, q, geo, idx, vals, out, traces,   \
                                  vuq, K, np, nq, nh, n_idx, n_vals, gamma, \
                                  stream, occ);
  ESDG_MODAL_DIM(1)
  ESDG_MODAL_DIM(2)
  ESDG_MODAL_DIM(3)
#undef ESDG_MODAL_DIM
  return -3;
}
}  // namespace esdg

// dtype: 0 = float32, 1 = float64; dim 1, 2 or 3 (NF = dim + 2 fields).
// q [NF, np, K], geo [dim^2, 1, K] or (curved = 1, dim 2 only)
// [4, nh, K]; idx [n_idx] int32 and vals [n_vals] the operator lists
// (modal_volume.cuh's ModalLists: Q, Vq, Vh Pq and Ph by rows, from
// ops/modal_volume.modal_lists); out [NF, np, K], traces [NF + 2, nh - nq,
// K], vuq [NF, nq, K].  Returns cudaGetLastError() after the launch, -1
// when the tile does not fit in shared memory, -2 for an unknown dtype, -3
// for a form not built (an unknown dim, or curved below or above dim 2).
static int modal_volume(int dtype, int dim, int curved, const void* q,
                        const void* geo, const void* idx, const void* vals,
                        void* out, void* traces, void* vuq, long long K,
                        int np, int nq, int nh, int n_idx, int n_vals,
                        double gamma, void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::dispatch_modal_volume<float>(dim, curved, q, geo, idx, vals,
                                              out, traces, vuq, K, np, nq, nh,
                                              n_idx, n_vals, gamma, st, occ);
  if (dtype == 1)
    return esdg::dispatch_modal_volume<double>(dim, curved, q, geo, idx,
                                               vals, out, traces, vuq, K, np,
                                               nq, nh, n_idx, n_vals, gamma,
                                               st, occ);
  return -2;
}

extern "C" int esdg_modal_volume(int dtype, int dim, int curved,
                                 const void* q, const void* geo,
                                 const void* idx, const void* vals,
                                 void* out, void* traces, void* vuq,
                                 long long K, int np, int nq, int nh,
                                 int n_idx, int n_vals, double gamma,
                                 void* stream) {
  return modal_volume(dtype, dim, curved, q, geo, idx, vals, out, traces,
                      vuq, K, np, nq, nh, n_idx, n_vals, gamma, stream,
                      nullptr);
}

// The launch shape of one form at these sizes (common.cuh's
// launch_shape: occ[7], occ[6] = 1 when the lists are read from global
// memory); returns as esdg_modal_volume.
extern "C" int esdg_modal_volume_shape(int dtype, int dim, int curved,
                                       int np, int nq, int nh, int n_idx,
                                       int n_vals, int* occ) {
  return modal_volume(dtype, dim, curved, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, nullptr, 0, np, nq, nh,
                      n_idx, n_vals, 1.4, nullptr, occ);
}
