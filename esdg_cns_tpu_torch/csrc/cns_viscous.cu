// K7's entry point (the kernel is cns_viscous.cuh), with DIM 2
// instantiated here; DIM 1 and 3 are cns_viscous_dim1.cu and _dim3.cu.
#include "cns_viscous.cuh"

namespace esdg {
extern template int viscous_dim<float, 1>(ESDG_VISCOUS_ARGS);
extern template int viscous_dim<double, 1>(ESDG_VISCOUS_ARGS);
extern template int viscous_dim<float, 3>(ESDG_VISCOUS_ARGS);
extern template int viscous_dim<double, 3>(ESDG_VISCOUS_ARGS);

template <typename T>
int dispatch_viscous(int dim, ESDG_VISCOUS_ARGS) {
#define ESDG_V_DIM(D)                                                       \
  if (dim == D)                                                             \
    return viscous_dim<T, D>(proj, contract, in, out, lval, lcol, widths,   \
                             K, sz, gamma, mu, lam, pr, stream, occ);
  ESDG_V_DIM(1)
  ESDG_V_DIM(2)
  ESDG_V_DIM(3)
#undef ESDG_V_DIM
  return -3;
}
}  // namespace esdg

static int viscous(int dtype, int dim, int proj, int contract,
                   const void* const* in, void* const* out, const void* lval,
                   const void* lcol, const int* widths, long long K, int np,
                   int nq, int nfq, double gamma, double mu, double lam,
                   double pr, void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const esdg::ViscSizes sz{np, nq, nfq};
  if (dtype == 0)
    return esdg::dispatch_viscous<float>(dim, proj, contract, in, out, lval,
                                         lcol, widths, K, sz, gamma, mu, lam,
                                         pr, st, occ);
  if (dtype == 1)
    return esdg::dispatch_viscous<double>(dim, proj, contract, in, out, lval,
                                          lcol, widths, K, sz, gamma, mu,
                                          lam, pr, st, occ);
  return -2;
}

// dtype: 0 = float32, 1 = float64; dim 1, 2 or 3; proj 1 (the front
// [Vq Pq; Vq D_r Pq], any dim) or 0 (the gradient rows alone, dim 3);
// contract 1 (t_f [Nf, Nfq, K]) or 0 (the components [dim Nf, Nfq, K]).
// in[10] = (vu_q, dv, geo, nxj, inv_j, wjq, front, vqlift, ef, drpq), the
// four operators not read at dim 3, which reads the lists instead: lval,
// lcol and widths[6] as esdg_cns_surface_viscous takes them (LIFT's list
// not read); they are not read at dim 1 and 2.  out[4] = (t_f or the
// components, div, prod, vuq), vuq not written without proj.  Returns
// cudaGetLastError() after the launch, -1 when the tile does not fit in
// shared memory, -2 for an unknown dtype, -3 for a form not built (an
// unknown dim, or proj = 0 below dim 3).
extern "C" int esdg_cns_viscous(int dtype, int dim, int proj, int contract,
                                const void* const* in, void* const* out,
                                const void* lval, const void* lcol,
                                const int* widths, long long K, int np,
                                int nq, int nfq, double gamma, double mu,
                                double lam, double pr, void* stream) {
  return viscous(dtype, dim, proj, contract, in, out, lval, lcol, widths, K,
                 np, nq, nfq, gamma, mu, lam, pr, stream, nullptr);
}

// The launch shape of one form at these sizes (common.cuh's
// launch_shape: occ[7], occ[6] = 1 when the operators or lists are read
// from global memory); returns as esdg_cns_viscous.
extern "C" int esdg_cns_viscous_shape(int dtype, int dim, int proj, int np,
                                      int nq, int nfq, const int* widths,
                                      int* occ) {
  return viscous(dtype, dim, proj, 1, nullptr, nullptr, nullptr, nullptr,
                 widths, 0, np, nq, nfq, 1.4, 1.0, -2.0 / 3.0, 0.71, nullptr,
                 occ);
}
