// Row 10: standalone line-sparse EC flux differencing of collocated hexes.
//
// Replaces the TPU kernel
// esdg_cns_tpu/ops/tensor_product_fd.py::_hex_lines_kernel (wrapper
// flux_differencing_lines_pallas), the volume term of the plain RHS with
// flux_diff_impl='lines_pallas'.  Per element it takes the flux variables
// qh [5, Nh, K] = (rho, u1, u2, u3, beta) and qlog [2, Nh, K] =
// (log rho, log beta) at all Nh = Nq + Nfq points, runs the line loop of K1
// (line_fd.cuh: triangular vol-vol line pairs and the vol-face couplings,
// the general 3-term contraction, pairwise-averaged on curved metrics) and
// writes 2 QF [5, Nh, K]: 2 acc_vol on the volume rows and 2 (the negated
// vol-face sums) on the raw face rows.  Unlike K1 it applies neither 1/wf
// nor LIFT (tensor_product_fd.py:621-626).
//
// What bounds it on this card: at N=3, K=32768 the 672 two-point fluxes
// per element (each with five divisions and two logarithmic means) against
// an HBM stream of qh, qlog, the metric and 2 QF (in f32: 147 MB of flux
// variables in, 105 MB out, plus, when curved, the 113 MB of the 189 MB
// metric that the lines use).  Counting a division or logarithm as one
// operation, the bytes give the higher floor (about three times the
// operations'); those cost far more than an FMA, so in practice the pair
// loop bounds it, as it binds K1.
//
// Design: K1's tile and line body (line_fd.cuh: TE elements, the
// element's 7 x Nh flux variables in shared memory, one thread per
// (element, direction, line), every line of the three directions at once;
// the sums come back in rows 0..4 of each point's slot).  Lanes past K
// compute on a quiescent state (rho=1, u=0, beta=1, logs 0) and store
// nothing.
#include "line_fd.cuh"

namespace esdg {

template <typename T, int N1, bool CURVED>
__global__ void __launch_bounds__(VolumeTile<T, N1>::THREADS,
                                  VolumeTile<T, N1>::MIN_BLOCKS)
    hex_lines_kernel(const T* __restrict__ qh, const T* __restrict__ qlog,
                     const T* __restrict__ geo, const T* __restrict__ cvol,
                     const T* __restrict__ cface, T* __restrict__ out,
                     long long K, double gamma) {
  using Tile = VolumeTile<T, N1>;
  constexpr int NH = Tile::NH;
  constexpr int TE = Tile::TE, THREADS = Tile::THREADS;
  const Consts<T> c(gamma);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);  // the tile: 7 x Nh per element
  const long long k0 = (long long)blockIdx.x * TE;
  auto at = [&](int e, int r, int node) -> T& {
    return sh[Tile::slot(r, node) * TE + e];
  };

  for (int t = threadIdx.x; t < TE * NH; t += THREADS) {
    const int e = t % TE, i = t / TE;
    const long long k = k0 + e;
    T v[7] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0)};  // quiescent
    if (k < K) {
#pragma unroll
      for (int r = 0; r < 5; ++r) v[r] = qh[(long long)(r * NH + i) * K + k];
      v[5] = qlog[(long long)i * K + k];
      v[6] = qlog[(long long)(NH + i) * K + k];
    }
#pragma unroll
    for (int r = 0; r < 7; ++r) at(e, r, i) = v[r];
  }
  __syncthreads();

  line_fd<T, N1, false, CURVED>(sh, geo, cvol, cface, nullptr, K, k0, c);

  // rows 0..4 of every point: its volume sum or its face row
  for (int t = threadIdx.x; t < TE * NH; t += THREADS) {
    const int e = t % TE, i = t / TE;
    const long long k = k0 + e;
    if (k >= K) continue;
#pragma unroll
    for (int f = 0; f < 5; ++f)
      out[(long long)(f * NH + i) * K + k] = T(2) * at(e, f, i);
  }
}

template <typename T, int N1, bool CURVED>
int launch_lines(const void* qh, const void* qlog, const void* geo,
                 const void* cvol, const void* cface, void* out, long long K,
                 double gamma, cudaStream_t stream) {
  using Tile = VolumeTile<T, N1>;
  auto kern = hex_lines_kernel<T, N1, CURVED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((K + Tile::TE - 1) / Tile::TE));
  kern<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(
      static_cast<const T*>(qh), static_cast<const T*>(qlog),
      static_cast<const T*>(geo), static_cast<const T*>(cvol),
      static_cast<const T*>(cface), static_cast<T*>(out), K, gamma);
  return int(cudaGetLastError());
}

template <typename T, bool CURVED>
int dispatch_lines(int n1, const void* qh, const void* qlog, const void* geo,
                   const void* cvol, const void* cface, void* out,
                   long long K, double gamma, cudaStream_t stream) {
#define ESDG_LINES_CASE(N) \
  case N:                  \
    return launch_lines<T, N, CURVED>(qh, qlog, geo, cvol, cface, out, K, \
                                      gamma, stream);
  switch (n1) {
    ESDG_LINES_CASE(2)
    ESDG_LINES_CASE(3)
    ESDG_LINES_CASE(4)
    ESDG_LINES_CASE(5)
    default:
      return -1;
  }
#undef ESDG_LINES_CASE
}

template <typename T>
int dispatch_lines_form(int n1, int curved, const void* qh, const void* qlog,
                        const void* geo, const void* cvol, const void* cface,
                        void* out, long long K, double gamma,
                        cudaStream_t stream) {
  return curved ? dispatch_lines<T, true>(n1, qh, qlog, geo, cvol, cface,
                                          out, K, gamma, stream)
                : dispatch_lines<T, false>(n1, qh, qlog, geo, cvol, cface,
                                           out, K, gamma, stream);
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  qh [5, Nh, K], qlog [2, Nh, K],
// geo [9, 1, K] or (curved = 1) [9, Nh, K], cvol [3 n1, Nq], cface [6, Nq];
// out [5, Nh, K] = 2 QF.  Returns cudaGetLastError() after the launch, -1
// for an unsupported line length n1, -2 for an unknown dtype.
extern "C" int esdg_hex_lines(int dtype, int n1, int curved, const void* qh,
                              const void* qlog, const void* geo,
                              const void* cvol, const void* cface, void* out,
                              long long K, double gamma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::dispatch_lines_form<float>(n1, curved, qh, qlog, geo, cvol,
                                            cface, out, K, gamma, st);
  if (dtype == 1)
    return esdg::dispatch_lines_form<double>(n1, curved, qh, qlog, geo, cvol,
                                             cface, out, K, gamma, st);
  return -2;
}
