// K1: fused volume stage of the collocated-hex ES-DG Euler RHS.
//
// Replaces the TPU kernel esdg_cns_tpu/ops/pallas_volume.py::_volume_kernel
// (wrapper euler_volume_pallas; bodies _entropy_project_hex and the
// triangular line fd, _fd_packed on the default path).  Per element it
// computes:
//   1. entropy variables v(U) at the Nq collocated volume nodes;
//   2. the face extrapolation Ef v ([Nfq x Nq] per field), in this kernel,
//      over the N+1 nodes of each face point's line;
//   3. U(v_f) at the Nfq face points (pow/exp of the inverse map);
//   4. flux variables (rho, u, beta) and (log rho, log beta) at all
//      Nh = Nq + Nfq points, staged in shared memory (the pointwise
//      steps of 1-4 are hex_project.cuh's, shared with the split path's
//      projection kernel);
//   5. skew line-sparse EC flux differencing along the three directions,
//      all lines at once (line_fd.cuh), with the cvol/cface tables of
//      ops/tensor_product_fd._hex_line_coeffs: one metric term per
//      direction on axis-aligned meshes (DIAG), the 3-term affine
//      contraction otherwise, and on curved meshes (CURVED, geo [9, Nh, K])
//      the 3-term contraction with pairwise-averaged metrics;
//   6. the face-row reduction (skew negatives of the vol-face couplings);
//   7. out = 2 (1/wq) acc_vol + 2 LIFT ((1/wf) face_rows), LIFT in-kernel
//      over the six face points of each node's three lines (common.cuh's
//      lift_lines; Ef and LIFT are zero elsewhere up to roundoff).
// Outputs: ph_qf [5, Nq, K] and traces [7, Nfq, K] =
// (rho, u1, u2, u3, beta, log rho, log beta) at the face points, faces
// r-, r+, s-, s+, t-, t+ in the face-node order of ref_hex (Ef's rows);
// with VOUT also step 1's v(U) into vout [5, Nq, K] (Vq = I on the
// collocated hexes, so the CNS front hands it to the viscous kernels),
// stored from the registers that hold it.  VOUT is a template flag, so
// that the Euler fronts' instantiations (vout null) compile as they did
// before it: as a runtime branch it moved the registers of some forms
// (f32 N+1 = 5 diag 87 -> 89, f64 N+1 = 3 general 124 -> 120).
//
// Design (line_fd.cuh's VolumeTile and line_fd).  A block owns TE
// elements and one thread per (element, direction, line): 3 (N+1)^2
// threads an element, all three directions' lines at once, so every
// thread has a line in the pair phase at every N.  The element's 7 x Nh
// flux variables are its only shared memory (v(U) is staged in the face
// slots before the face points are projected; the volume sums go into the
// spent volume slots after the pairs): in f32 5,600 B an element at N+1 =
// 4 and 14,112 B at N+1 = 6, where a tile with a [5, Nq] accumulator took
// 5,760 and 16,416.  A thread maps t -> (element t % TE, point t / TE) in
// the projection and the LIFT, so a warp's K-last loads and stores cover
// TE consecutive elements.  Per type and N+1 the tile (TE, and MIN_BLOCKS
// under __launch_bounds__, which caps the registers) was timed on the
// card against its neighbours: in f32, TE = 16, 8, 8, 8, 4, 4, 2 at N+1 =
// 2..8, and 36, 35, 36, 19, 28, 19, 12 warps resident an SM (the one-
// direction-at-a-time design before it held 16 at N+1 = 4, 8 at 5..8).
// Narrower tiles cost more than their finer tail saves (K's loads and
// stores cover fewer bytes a sector); at N+1 = 8 the line stays in
// registers (HOLD) at 12 warps.  Barriers: three in the projection, four
// after the pairs (the volume sums one direction at a time), each shared
// by one to six blocks resident an SM.
//
// What bounds it on this card: the pairs' arithmetic.  The kernel issues
// five IEEE divisions a pair (two were the series term's 1/448) and forms
// the general contraction from the contracted velocity (common.cuh), so
// the general form costs about what the diag one does.  On an NVIDIA H100
// 80GB HBM3 at 700.00 W (chip_smoke.py; PERF.md §6 has every form): N=3,
// K=32768, 0.2727 ms against 0.1709 ms priced at the probes' operation
// costs (672 two-point fluxes an element) and 0.0517 ms for its HBM
// stream; N+1 = 6, K=8000, 0.2693 against 0.1611; curved N=3 0.3109
// against 0.1906.  At N+1 = 4 the register cap of 56 that 36 warps leave
// spills a few values (chip_smoke.py prints the shapes and ptxas'
// report), and K=4096 there (the 3D cavity) runs 1.29 waves of the 24
// elements an SM holds.  Lanes past K compute on the quiescent state
// (rho=1, m=0, E=1) and store nothing.  Summation order differs from the
// reference (FMA contraction, sums in another order): f32 agrees with
// the plain version to ~1e-6 of max|out|, f64 to ~1e-14.
//
// This header holds the kernel; hex_volume.cu the entry esdg_hex_volume
// with N+1 = 2..4, and hex_volume5/6/7/8.cu one larger line length each,
// both VOUT forms, so that nvcc builds them in parallel.
#pragma once

#include "hex_project.cuh"
#include "line_fd.cuh"

namespace esdg {

template <typename T, int N1, bool DIAG, bool CURVED, bool VOUT>
__global__ void __launch_bounds__(VolumeTile<T, N1>::THREADS,
                                  VolumeTile<T, N1>::MIN_BLOCKS)
    hex_volume_kernel(const T* __restrict__ q, const T* __restrict__ geo,
                      const T* __restrict__ cvol, const T* __restrict__ cface,
                      const T* __restrict__ iw, const T* __restrict__ iwf,
                      const T* __restrict__ ef, const T* __restrict__ lift,
                      T* __restrict__ out, T* __restrict__ traces,
                      T* __restrict__ vout, long long K, double gamma) {
  using Tile = VolumeTile<T, N1>;
  constexpr int NQ = Tile::NQ, NFQ = Tile::NFQ;
  constexpr int TE = Tile::TE, THREADS = Tile::THREADS;
  // face points per thread (NFQ = 2 NT: two at every N)
  constexpr int NFT = (TE * NFQ + THREADS - 1) / THREADS;
  const Consts<T> c(gamma);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);  // the tile: 7 x Nh per element
  const long long k0 = (long long)blockIdx.x * TE;
  // value (r, node) of element e; t -> (e, point) = (t % TE, t / TE), so
  // a warp's K-last loads and stores cover TE consecutive elements
  auto at = [&](int e, int r, int node) -> T& {
    return sh[Tile::slot(r, node) * TE + e];
  };
  // v(U) at volume node i, staged in the face slots (5 Nq <= 7 Nfq)
  auto vslot = [&](int e, int f, int i) -> T& {
    const int j = f * NQ + i;
    return at(e, j / NFQ, NQ + j % NFQ);
  };

  // ---- 1. v(U) and the flux variables at the volume nodes ----
  for (int t = threadIdx.x; t < TE * NQ; t += THREADS) {
    const int e = t % TE, i = t / TE;
    const long long k = k0 + e;
    T u[5] = {T(1), T(0), T(0), T(0), T(1)};  // quiescent past K
    if (k < K) {
#pragma unroll
      for (int f = 0; f < 5; ++f) u[f] = q[(long long)(f * NQ + i) * K + k];
    }
    T v[5], vals[7];
    project_volume_point(u, c, v, vals);
#pragma unroll
    for (int f = 0; f < 5; ++f) vslot(e, f, i) = v[f];
    if constexpr (VOUT) {
      if (k < K) {
#pragma unroll
        for (int f = 0; f < 5; ++f)
          vout[(long long)(f * NQ + i) * K + k] = v[f];
      }
    }
#pragma unroll
    for (int r = 0; r < 7; ++r) at(e, r, i) = vals[r];
  }
  __syncthreads();

  // ---- 2.-4. v_f = Ef v over each face point's line, U(v_f), the face
  // flux variables and the traces; held until every v is read ----
  T fvals[NFT][7];
#pragma unroll
  for (int j = 0; j < NFT; ++j) {
    const int t = threadIdx.x + j * THREADS;
    if (t < TE * NFQ) {
      const int e = t % TE, fp = t / TE;
      const long long k = k0 + e;
      T fv[5] = {T(0), T(0), T(0), T(0), T(0)};
      ef_line<T, N1>(ef, fp, [&](int f, int i) { return vslot(e, f, i); },
                     fv);
      project_face_point(fv, c, fvals[j]);
      if (k < K) {
#pragma unroll
        for (int r = 0; r < 7; ++r)
          traces[(long long)(r * NFQ + fp) * K + k] = fvals[j][r];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NFT; ++j) {
    const int t = threadIdx.x + j * THREADS;
    if (t < TE * NFQ) {
#pragma unroll
      for (int r = 0; r < 7; ++r) at(t % TE, r, NQ + t / TE) = fvals[j][r];
    }
  }
  __syncthreads();

  // ---- 5.-6. line-sparse skew EC flux differencing, all lines at once ----
  line_fd<T, N1, DIAG, CURVED>(sh, geo, cvol, cface, iwf, K, k0, c);

  // ---- 7. Ph QF = 2 (1/wq) QF_vol + 2 LIFT ((1/wf) QF_face) ----
  for (int t = threadIdx.x; t < TE * NQ; t += THREADS) {
    const int e = t % TE, i = t / TE;
    const long long k = k0 + e;
    if (k >= K) continue;
    T s[5] = {T(0), T(0), T(0), T(0), T(0)};
    lift_lines<T, N1>(lift, i,
                      [&](int f, int fp) { return at(e, f, NQ + fp); }, s);
    const T two_iw = T(2) * iw[i];
#pragma unroll
    for (int f = 0; f < 5; ++f)
      out[(long long)(f * NQ + i) * K + k] = two_iw * at(e, f, i) + T(2) * s[f];
  }
}

template <typename T, int N1, bool DIAG, bool CURVED, bool VOUT>
int launch_volume(const void* q, const void* geo, const void* cvol,
                  const void* cface, const void* iw, const void* iwf,
                  const void* ef, const void* lift, void* out, void* traces,
                  void* vout, long long K, double gamma, cudaStream_t stream,
                  int* occ) {
  using Tile = VolumeTile<T, N1>;
  auto kern = hex_volume_kernel<T, N1, DIAG, CURVED, VOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::SMEM));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr)
    return launch_shape(kern, Tile::THREADS, Tile::SMEM, Tile::TE, occ);
  const dim3 grid(unsigned((K + Tile::TE - 1) / Tile::TE));
  kern<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(geo),
      static_cast<const T*>(cvol), static_cast<const T*>(cface),
      static_cast<const T*>(iw), static_cast<const T*>(iwf),
      static_cast<const T*>(ef), static_cast<const T*>(lift),
      static_cast<T*>(out), static_cast<T*>(traces), static_cast<T*>(vout),
      K, gamma);
  return int(cudaGetLastError());
}

// One line length N1 of K1 for both types and all three metric forms,
// with (VOUT) or without v(U); returns as esdg_hex_volume.  hex_volume.cu
// instantiates N1 = 2..4, hex_volume<N1>.cu the larger ones.
template <int N1, bool VOUT>
int volume_order(int dtype, int diag, int curved, const void* q,
                 const void* geo, const void* cvol, const void* cface,
                 const void* iw, const void* iwf, const void* ef,
                 const void* lift, void* out, void* traces, void* vout,
                 long long K, double gamma, cudaStream_t stream, int* occ) {
#define ESDG_VOLUME_FORMS(T)                                                \
  if (diag)                                                                 \
    return launch_volume<T, N1, true, false, VOUT>(                         \
        q, geo, cvol, cface, iw, iwf, ef, lift, out, traces, vout, K,       \
        gamma, stream, occ);                                                \
  if (curved)                                                               \
    return launch_volume<T, N1, false, true, VOUT>(                         \
        q, geo, cvol, cface, iw, iwf, ef, lift, out, traces, vout, K,       \
        gamma, stream, occ);                                                \
  return launch_volume<T, N1, false, false, VOUT>(                          \
      q, geo, cvol, cface, iw, iwf, ef, lift, out, traces, vout, K, gamma,  \
      stream, occ);
  if (diag && curved) return -3;
  if (dtype == 0) {
    ESDG_VOLUME_FORMS(float)
  }
  if (dtype == 1) {
    ESDG_VOLUME_FORMS(double)
  }
  return -2;
#undef ESDG_VOLUME_FORMS
}

#define ESDG_VOLUME_ORDER_ARGS                                             \
  int, int, int, const void*, const void*, const void*, const void*,      \
      const void*, const void*, const void*, const void*, void*, void*,   \
      void*, long long, double, cudaStream_t, int*

}  // namespace esdg
