// K1's flux-differencing section alone: the line-sparse EC flux
// differencing of collocated hex elements on given flux variables, with
// nothing before it (no entropy projection) and nothing after it (no 1/w
// scaling, no LIFT, no factor 2).
//
// Replaces the TPU study kernel of examples/r5_packed_fd_study.py
// (make_fd_call's `kernel`, :54): qh [5, Nh, K] = (rho, u1, u2, u3, beta)
// and qlog [2, Nh, K] = (log rho, log beta) at the Nh = Nq + 6 Nfp
// hybridized points, the affine metric geo [9, 1, K], and the coefficient
// tables cvol [3 N1, Nq, 1] and cface [6, Nq, 1] -> out [5, Nh, K]: the
// volume sums on rows 0..Nq-1, then the six face rows (the negated sums
// of each face point's vol-face couplings), face fid at
// Nq + fid Nfp.  The TPU study runs this through its two layouts of one
// body, esdg_cns_tpu/ops/pallas_volume.py _fd_pad8 (:561) and _fd_packed
// (:690); here it is K1's own line body, line_fd.cuh's line_fd on K1's
// shared-memory tile (VolumeTile), so the study times exactly the section
// K1 runs.  DIAG: one metric term per direction, else the 3-term affine
// contraction.
//
// The pair bookkeeping is _fd_pad8's, which matters here: the study's
// cvol and cface are random, not skew.  A vol-vol pair (a, ap), a < ap on
// a line of direction d, reads ONE coefficient, cvol[d N1 + ap] at the
// lower node a, adds c F to node a and -c F to node ap; on the real
// (skew) line operators any indexing that respects the skewness gives the
// same sums, on these inputs only this one does.
//
// What bounds it on this card: at N+1 = 5, K = 13824 it reads qh and
// qlog (106 MB in f32) and writes 76 MB, and evaluates 3 x 25 x (10 + 10)
// = 1500 two-point fluxes per element, each with five IEEE divisions;
// chip_smoke.py prints both the data-sheet bound and the bound priced at
// the divisions' measured cost.
//
// Design: K1's tile (line_fd.cuh's VolumeTile: TE elements, one thread per
// (element, direction, line), the element's 7 x Nh flux variables in
// shared memory) and K1's line body, line_fd, which runs every line of
// the three directions at once and leaves each volume sum and each face
// row, unscaled, in rows 0..4 of its point's slot of the tile; the kernel
// then writes them once.  Lanes past K compute on the quiescent state
// (rho = 1, u = 0, beta = 1, logs 0) and store nothing.  Summation order
// differs from the plain version: f32 agrees to ~1e-6 of max|out|, f64 to
// ~1e-14.
//
// This header holds the kernel; fd_section5.cu the entry esdg_fd_section
// and N+1 = 5, fd_section6.cu and fd_section7.cu one larger line length
// each, so that nvcc builds them in parallel, as hex_volume5..8.cu.
#pragma once

#include "line_fd.cuh"

namespace esdg {

template <typename T, int N1, bool DIAG>
__global__ void __launch_bounds__(VolumeTile<T, N1>::THREADS,
                                  VolumeTile<T, N1>::MIN_BLOCKS)
    fd_section_kernel(const T* __restrict__ qh, const T* __restrict__ qlog,
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
    const int e = t % TE, node = t / TE;
    const long long k = k0 + e;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      // quiescent past K: rho = beta = 1, u = 0, logs 0
      T v = (r == 0 || r == 4) ? T(1) : T(0);
      if (k < K)
        v = r < 5 ? qh[((long long)r * NH + node) * K + k]
                  : qlog[((long long)(r - 5) * NH + node) * K + k];
      at(e, r, node) = v;
    }
  }
  __syncthreads();

  line_fd<T, N1, DIAG, false>(sh, geo, cvol, cface, nullptr, K, k0, c);

  // rows 0..4 of every point: its volume sum or its (unscaled) face row
  for (int t = threadIdx.x; t < TE * NH; t += THREADS) {
    const int e = t % TE, node = t / TE;
    const long long k = k0 + e;
    if (k >= K) continue;
#pragma unroll
    for (int f = 0; f < 5; ++f)
      out[((long long)f * NH + node) * K + k] = at(e, f, node);
  }
}

template <typename T, int N1, bool DIAG>
int launch_fd_section(const void* qh, const void* qlog, const void* geo,
                      const void* cvol, const void* cface, void* out,
                      long long K, double gamma, cudaStream_t stream) {
  using Tile = VolumeTile<T, N1>;
  auto kern = fd_section_kernel<T, N1, DIAG>;
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

// One line length N1 of the section for both types and both metric
// forms; returns as esdg_fd_section.  fd_section5.cu instantiates
// N1 = 5, fd_section<N1>.cu the larger ones.
template <int N1>
int fd_section_order(int dtype, int diag, const void* qh, const void* qlog,
                     const void* geo, const void* cvol, const void* cface,
                     void* out, long long K, double gamma,
                     cudaStream_t stream) {
#define ESDG_FD_SECTION_FORMS(T)                                           \
  if (diag)                                                                \
    return launch_fd_section<T, N1, true>(qh, qlog, geo, cvol, cface, out, \
                                          K, gamma, stream);               \
  return launch_fd_section<T, N1, false>(qh, qlog, geo, cvol, cface, out,  \
                                         K, gamma, stream);
  if (dtype == 0) {
    ESDG_FD_SECTION_FORMS(float)
  }
  if (dtype == 1) {
    ESDG_FD_SECTION_FORMS(double)
  }
  return -2;
#undef ESDG_FD_SECTION_FORMS
}

#define ESDG_FD_SECTION_ORDER_ARGS                                        \
  int, int, const void*, const void*, const void*, const void*,          \
      const void*, void*, long long, double, cudaStream_t

}  // namespace esdg
