// K8: the post-exchange CNS surface stage of the affine CNS RHS alone, in
// 1D, 2D and 3D.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_cns_surface.py::
// _surface_kernel (wrapper cns_surface_pallas).  One thread per (face
// node, element): the neighbour's conservative and entropy traces rebuilt
// from the exchanged flux variables (the local ones, uf and vuf, are
// inputs, rebuilt by the caller with the same formulas), then
// surface_node (cns_stages.cuh, the same device code as K4's face stage):
// the wall-BC ghosts walked over the region table in region order, the EC
// face flux + LF, the entropy BC, the BR1 jump dv and the penalty rows
// (zeros without with_penalty).
//
// What bounds it on an H100: about 200 operations per face node (two
// logarithmic means, two logs with a BC, two square roots) against about
// 40 values read and 15 written, in f32 about 1 operation per byte: HBM.
// The design is a pointwise pass over the [Nfq, K] face nodes with
// element-fastest indexing, so every load and store is coalesced; it keeps
// nothing in shared memory.
#include "cns_stages.cuh"

namespace esdg {

template <typename T, int DIM>
__global__ void __launch_bounds__(256)
    cns_surface_kernel(const T* __restrict__ qmv, const T* __restrict__ ufv,
                       const T* __restrict__ qml, const T* __restrict__ vufv,
                       const T* __restrict__ nbr, const T* __restrict__ nxj,
                       const T* __restrict__ sj, const T* __restrict__ isj,
                       const T* __restrict__ pool,
                       const int* __restrict__ itab,
                       const double* __restrict__ ftab,
                       T* __restrict__ flux_out, T* __restrict__ dv_out,
                       T* __restrict__ pen_out, long long n_nodes,
                       long long rs, double gamma, double re,
                       int dissipation, int with_penalty, int has_bc) {
  constexpr int NF = DIM + 2;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_nodes) return;
  const Consts<T> c(gamma);
  T qm[NF], qp[NF], uf[NF], vuf[NF], lm[2], lp[2], n[DIM];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    qm[f] = qmv[f * rs + o];
    qp[f] = nbr[f * rs + o];
    uf[f] = ufv[f * rs + o];
    vuf[f] = vufv[f * rs + o];
  }
  lm[0] = qml[o];
  lm[1] = qml[rs + o];
  lp[0] = nbr[NF * rs + o];
  lp[1] = nbr[(NF + 1) * rs + o];
#pragma unroll
  for (int d = 0; d < DIM; ++d) n[d] = nxj[d * rs + o];
  T flux[NF], dv[NF], pen[NF];
  surface_node<T, DIM>(qm, lm, qp, lp, uf, vuf, n, sj[o], isj[o], pool, o,
                       rs, true, itab, ftab, has_bc, dissipation,
                       with_penalty, T(re), c, flux, dv, pen);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    flux_out[f * rs + o] = flux[f];
    dv_out[f * rs + o] = dv[f];
    pen_out[f * rs + o] = pen[f];
  }
}

template <typename T, int DIM>
int launch_surface(const void* const* in, void* const* out, const int* itab,
                   const double* ftab, long long K, int nfq, double gamma,
                   double re, int dissipation, int with_penalty, int has_bc,
                   cudaStream_t stream) {
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  auto O = [&](int i) { return static_cast<T*>(out[i]); };
  const long long n_nodes = (long long)nfq * K;
  const unsigned threads = 256;
  const unsigned blocks = unsigned((n_nodes + threads - 1) / threads);
  cns_surface_kernel<T, DIM><<<blocks, threads, 0, stream>>>(
      I(0), I(1), I(2), I(3), I(4), I(5), I(6), I(7), I(8), itab, ftab, O(0),
      O(1), O(2), n_nodes, n_nodes, gamma, re, dissipation, with_penalty,
      has_bc);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_surface(int dim, const void* const* in, void* const* out,
                     const int* itab, const double* ftab, long long K,
                     int nfq, double gamma, double re, int dissipation,
                     int with_penalty, int has_bc, cudaStream_t st) {
  if (dim == 1)
    return launch_surface<T, 1>(in, out, itab, ftab, K, nfq, gamma, re,
                                dissipation, with_penalty, has_bc, st);
  if (dim == 2)
    return launch_surface<T, 2>(in, out, itab, ftab, K, nfq, gamma, re,
                                dissipation, with_penalty, has_bc, st);
  if (dim == 3)
    return launch_surface<T, 3>(in, out, itab, ftab, K, nfq, gamma, re,
                                dissipation, with_penalty, has_bc, st);
  return -3;
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64; dim 1, 2 or 3.  in[9] = (qm, uf, qm_log,
// vuf, nbr, nxj, sj, inv_sj, pool); pool may be any pointer when
// has_bc = 0.  out[3] = (flux, dv, pen), each [Nf, Nfq, K].  itab / ftab:
// the region table (device memory), read only when has_bc.  Returns
// cudaGetLastError() after the launch, -2 for an unknown dtype, -3 for an
// unknown dim.
extern "C" int esdg_cns_surface(int dtype, int dim, const void* const* in,
                                void* const* out, const void* itab,
                                const void* ftab, long long K, int nfq,
                                double gamma, double re, int dissipation,
                                int with_penalty, int has_bc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(itab);
  const double* ft = static_cast<const double*>(ftab);
  if (dtype == 0)
    return esdg::dispatch_surface<float>(dim, in, out, it, ft, K, nfq, gamma,
                                         re, dissipation, with_penalty,
                                         has_bc, st);
  if (dtype == 1)
    return esdg::dispatch_surface<double>(dim, in, out, it, ft, K, nfq,
                                          gamma, re, dissipation,
                                          with_penalty, has_bc, st);
  return -2;
}
