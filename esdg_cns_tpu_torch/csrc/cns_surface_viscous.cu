// K4's entry point (the kernel is cns_surface_viscous.cuh), with DIM 2
// instantiated here; DIM 1 and 3 are cns_surface_viscous_dim1.cu and
// _dim3.cu.
#include "cns_surface_viscous.cuh"

namespace esdg {
extern template int surface_viscous_dim<float, 1>(ESDG_SURFACE_VISCOUS_ARGS);
extern template int surface_viscous_dim<double, 1>(ESDG_SURFACE_VISCOUS_ARGS);
extern template int surface_viscous_dim<float, 3>(ESDG_SURFACE_VISCOUS_ARGS);
extern template int surface_viscous_dim<double, 3>(ESDG_SURFACE_VISCOUS_ARGS);

template <typename T>
int dispatch_surface_viscous(int dim, ESDG_SURFACE_VISCOUS_ARGS) {
#define ESDG_SV_DIM(D)                                                      \
  if (dim == D)                                                             \
    return surface_viscous_dim<T, D>(proj, in, out, itab, ftab, K, sz,      \
                                     gamma, mu, lam, pr, re, dissipation,   \
                                     with_penalty, fold_tail, has_bc,       \
                                     stream);
  ESDG_SV_DIM(1)
  ESDG_SV_DIM(2)
  ESDG_SV_DIM(3)
#undef ESDG_SV_DIM
  return -3;
}
}  // namespace esdg

// dtype: 0 = float32, 1 = float64; dim 1, 2 or 3; proj 1 (the front
// [Vq Pq; Vq D_r Pq], any dim) or 0 (the gradient rows alone, dim 3: the
// collocated hex).  in[17] = (vu_q, qm, qm_log, nbr, nxj, sj, inv_sj,
// pool, geo, inv_j, wjq, front, vqlift, ef, drpq, ph_qf, lift); pool may
// be any pointer when has_bc = 0, ph_qf and lift when fold_tail = 0.
// out[6] = (flux, pen, t_f, div or dq_part, prod, vuq); flux and pen are
// not written with fold_tail, pen not without with_penalty, vuq not
// without proj.  itab / ftab: the region table (device memory), read only
// when has_bc.  Returns cudaGetLastError() after the launch, -1 when the
// tile does not fit in shared memory, -2 for an unknown dtype, -3 for a
// form not built (an unknown dim, or proj = 0 below dim 3).
extern "C" int esdg_cns_surface_viscous(
    int dtype, int dim, int proj, const void* const* in, void* const* out,
    const void* itab, const void* ftab, long long K, int np, int nq, int nfq,
    double gamma, double mu, double lam, double pr, double re,
    int dissipation, int with_penalty, int fold_tail, int has_bc,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const esdg::ViscSizes sz{np, nq, nfq};
  const int* it = static_cast<const int*>(itab);
  const double* ft = static_cast<const double*>(ftab);
  if (dtype == 0)
    return esdg::dispatch_surface_viscous<float>(
        dim, proj, in, out, it, ft, K, sz, gamma, mu, lam, pr, re,
        dissipation, with_penalty, fold_tail, has_bc, st);
  if (dtype == 1)
    return esdg::dispatch_surface_viscous<double>(
        dim, proj, in, out, it, ft, K, sz, gamma, mu, lam, pr, re,
        dissipation, with_penalty, fold_tail, has_bc, st);
  return -2;
}
