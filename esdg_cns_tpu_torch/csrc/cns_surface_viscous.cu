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
    return surface_viscous_dim<T, D>(proj, in, out, lval, lcol, widths,     \
                                     itab, ftab, K, sz, gamma, mu, lam, pr, \
                                     re, dissipation, with_penalty,         \
                                     fold_tail, has_bc, stream, occ);
  ESDG_SV_DIM(1)
  ESDG_SV_DIM(2)
  ESDG_SV_DIM(3)
#undef ESDG_SV_DIM
  return -3;
}
}  // namespace esdg

static int surface_viscous(int dtype, int dim, int proj,
                           const void* const* in, void* const* out,
                           const void* lval, const void* lcol,
                           const int* widths, const void* itab,
                           const void* ftab, long long K, int np, int nq,
                           int nfq, double gamma, double mu, double lam,
                           double pr, double re, int dissipation,
                           int with_penalty, int fold_tail, int has_bc,
                           void* stream, int* occ) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const esdg::ViscSizes sz{np, nq, nfq};
  const int* it = static_cast<const int*>(itab);
  const double* ft = static_cast<const double*>(ftab);
  if (dtype == 0)
    return esdg::dispatch_surface_viscous<float>(
        dim, proj, in, out, lval, lcol, widths, it, ft, K, sz, gamma, mu, lam,
        pr, re, dissipation, with_penalty, fold_tail, has_bc, st, occ);
  if (dtype == 1)
    return esdg::dispatch_surface_viscous<double>(
        dim, proj, in, out, lval, lcol, widths, it, ft, K, sz, gamma, mu, lam,
        pr, re, dissipation, with_penalty, fold_tail, has_bc, st, occ);
  return -2;
}

// dtype: 0 = float32, 1 = float64; dim 1, 2 or 3; proj 1 (the front
// [Vq Pq; Vq D_r Pq], any dim) or 0 (the gradient rows alone, dim 3: the
// collocated hex).  in[17] = (vu_q, qm, qm_log, nbr, nxj, sj, inv_sj,
// pool, geo, inv_j, wjq, front, vqlift, ef, drpq, ph_qf, lift); pool may
// be any pointer when has_bc = 0, ph_qf and lift when fold_tail = 0, and
// the five operators at dim 3, which reads the lists instead: lval (the
// values) and lcol (uint16 columns) of ops/surface_viscous.visc_lists,
// widths[6] its slots a row (host memory; cns_stages.cuh
// ViscListLayout); they are not read at dim 1 and 2.  out[6] = (flux,
// pen, t_f, div or dq_part, prod, vuq); flux and pen are not written with
// fold_tail, pen not without with_penalty, vuq not without proj.  itab /
// ftab: the region table (device memory), read only when has_bc.  Returns
// cudaGetLastError() after the launch, -1 when the tile does not fit in
// shared memory, -2 for an unknown dtype, -3 for a form not built (an
// unknown dim, or proj = 0 below dim 3).
extern "C" int esdg_cns_surface_viscous(
    int dtype, int dim, int proj, const void* const* in, void* const* out,
    const void* lval, const void* lcol, const int* widths, const void* itab,
    const void* ftab, long long K, int np, int nq, int nfq, double gamma,
    double mu, double lam, double pr, double re, int dissipation,
    int with_penalty, int fold_tail, int has_bc, void* stream) {
  return surface_viscous(dtype, dim, proj, in, out, lval, lcol, widths, itab,
                         ftab, K, np, nq, nfq, gamma, mu, lam, pr, re,
                         dissipation, with_penalty, fold_tail, has_bc, stream,
                         nullptr);
}

// The launch shape of one form at these sizes (common.cuh's
// launch_shape: occ[7], occ[6] = 1 when the operators or lists are read
// from global memory); returns as esdg_cns_surface_viscous.
extern "C" int esdg_cns_surface_viscous_shape(int dtype, int dim, int proj,
                                              int fold_tail, int np, int nq,
                                              int nfq, const int* widths,
                                              int* occ) {
  return surface_viscous(dtype, dim, proj, nullptr, nullptr, nullptr,
                         nullptr, widths, nullptr, nullptr, 0, np, nq, nfq,
                         1.4, 1.0, -2.0 / 3.0, 0.71, 1.0, 1, 1, fold_tail, 1,
                         nullptr, occ);
}
