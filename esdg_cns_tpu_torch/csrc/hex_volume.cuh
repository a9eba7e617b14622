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
//      Nh = Nq + Nfq points, staged in shared memory (steps 1-4 are
//      hex_project.cuh, shared with the split path's projection kernel);
//   5. skew line-sparse EC flux differencing along the three directions
//      (line_fd.cuh) with the cvol/cface tables of
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
// r-, r+, s-, s+, t-, t+ in the face-node order of ref_hex (Ef's rows).
//
// What bounds it on this card: at N=3, K=32768 each element evaluates
// 672 two-point fluxes (3 directions x 16 lines x (6 vol-vol + 8
// vol-face) pairs), each with five IEEE divisions and a select-guarded
// logarithmic mean, plus 2 x 1920 multiply-adds of the line-sparse Ef and
// LIFT products.  The HBM stream is only q, the metric and the two
// outputs (in f32: 42 MB in, 42 MB + 88 MB out, about 0.17 GB per RHS;
// the curved metric is 189 MB, of which the kernel reads 113 MB).  Counted
// at the FP32 peak, with a division or logarithm as one operation, the
// pairs take less time than that stream, so chip_smoke.py's bound is the
// stream's; the kernel's time goes to the divisions, transcendentals and
// shared-memory traffic of the pairs, which that count does not weigh.
//
// Simple design: a block owns TE elements and 256 threads; threadIdx.x
// runs over the elements, so the loads and stores of the K-last [., ., K]
// arrays coalesce over TE consecutive elements.  The element's Nh-point
// flux variables (7 x Nh values) and a [5 x Nq] accumulator live in shared
// memory, and TE is the largest tile of at most 16 elements that fits
// (line_fd.cuh's VolumeTile): 16 up to N+1 = 4 and at N+1 = 5 in f32
// (184 KB per block in f64 at N+1 = 4), 8 at N+1 = 5 in f64 and at
// N+1 = 6, 7 in f32 (131 and 198 KB), 4 at N+1 = 6, 7 in f64 and at
// N+1 = 8 in f32 (141 KB), 2 at N+1 = 8 in f64.  The line loop
// (line_fd.cuh) keeps each line in registers, the curved metric too; at
// N+1 = 8 in f64 that is more than a thread's 255 registers and spills.
// From N+1 = 6 on only one block fits an SM, and a warp spans only 2 to
// 8 elements, so one row of its K-last accesses covers 16 or 32 bytes.
// Lanes past K compute on the quiescent state (rho=1, m=0, E=1) and store
// nothing.  Summation order differs from the reference (FMA
// contraction, sums in another order): f32 agrees with the plain version
// to ~1e-6 of max|out|, f64 to ~1e-14.
//
// Making it fast (register tiling of the lines, fewer divisions, wider
// occupancy) is later work.
//
// This header holds the kernel; hex_volume.cu the entry esdg_hex_volume
// with N+1 = 2..5, and hex_volume6/7/8.cu one larger line length each, so
// that nvcc builds them in parallel.
#pragma once

#include "hex_project.cuh"
#include "line_fd.cuh"

namespace esdg {

template <typename T, int N1, bool DIAG, bool CURVED>
__global__ void __launch_bounds__(kVolumeThreads)
    hex_volume_kernel(const T* __restrict__ q, const T* __restrict__ geo,
                      const T* __restrict__ cvol, const T* __restrict__ cface,
                      const T* __restrict__ iw, const T* __restrict__ iwf,
                      const T* __restrict__ ef, const T* __restrict__ lift,
                      T* __restrict__ out, T* __restrict__ traces,
                      long long K, double gamma) {
  using Tile = VolumeTile<T, N1>;
  constexpr int NQ = Tile::NQ;
  constexpr int NH = Tile::NH, TE = Tile::TE, NW = Tile::NW;
  const Consts<T> c(gamma);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);  // [7][NH][TE] flux variables
  T* acc = sh + 7 * NH * TE;               // [5][NQ][TE]
  const int e = threadIdx.x;               // element of the tile
  const int w = threadIdx.y;               // worker of the element
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;
  auto SH = [&](int r, int node) -> T& { return sh[(r * NH + node) * TE + e]; };
  auto ACC = [&](int f, int node) -> T& { return acc[(f * NQ + node) * TE + e]; };

  // ---- 1.-4. entropy projection (hex_project.cuh): flux variables at
  // all Nh points into sh, traces out; v is staged in acc ----
  entropy_project<T, N1, TE, NW>(
      q, ef, acc, traces, K, k, live, c,
      [&](int r, int node, T v) { SH(r, node) = v; });
  for (int i = w; i < NQ; i += NW) {
#pragma unroll
    for (int f = 0; f < 5; ++f) ACC(f, i) = T(0);
  }
  __syncthreads();

  // ---- 4.-6. line-sparse skew EC flux differencing ----
  line_fd<T, N1, DIAG, CURVED>(sh, acc, geo, cvol, cface, iwf, K, k, live, c);

  // ---- 7. Ph QF = 2 (1/wq) QF_vol + 2 LIFT ((1/wf) QF_face) ----
  if (!live) return;  // no barrier below
  for (int i = w; i < NQ; i += NW) {
    T s[5] = {T(0), T(0), T(0), T(0), T(0)};
    lift_lines<T, N1>(lift, i, [&](int f, int fp) { return SH(f, NQ + fp); },
                      s);
    const T two_iw = T(2) * iw[i];
#pragma unroll
    for (int f = 0; f < 5; ++f)
      out[(long long)(f * NQ + i) * K + k] = two_iw * ACC(f, i) + T(2) * s[f];
  }
}

template <typename T, int N1, bool DIAG, bool CURVED>
int launch_volume(const void* q, const void* geo, const void* cvol,
                  const void* cface, const void* iw, const void* iwf,
                  const void* ef, const void* lift, void* out, void* traces,
                  long long K, double gamma, cudaStream_t stream) {
  using Tile = VolumeTile<T, N1>;
  auto kern = hex_volume_kernel<T, N1, DIAG, CURVED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 block(Tile::TE, Tile::NW);
  const dim3 grid(unsigned((K + Tile::TE - 1) / Tile::TE));
  kern<<<grid, block, Tile::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(geo),
      static_cast<const T*>(cvol), static_cast<const T*>(cface),
      static_cast<const T*>(iw), static_cast<const T*>(iwf),
      static_cast<const T*>(ef), static_cast<const T*>(lift),
      static_cast<T*>(out), static_cast<T*>(traces), K, gamma);
  return int(cudaGetLastError());
}


// One line length N1 of K1 for both types and all three metric forms;
// returns as esdg_hex_volume.  hex_volume.cu instantiates N1 = 2..5,
// hex_volume<N1>.cu the larger ones.
template <int N1>
int volume_order(int dtype, int diag, int curved, const void* q,
                 const void* geo, const void* cvol, const void* cface,
                 const void* iw, const void* iwf, const void* ef,
                 const void* lift, void* out, void* traces, long long K,
                 double gamma, cudaStream_t stream) {
#define ESDG_VOLUME_FORMS(T)                                                \
  if (diag)                                                                 \
    return launch_volume<T, N1, true, false>(q, geo, cvol, cface, iw, iwf,  \
                                             ef, lift, out, traces, K,      \
                                             gamma, stream);                \
  if (curved)                                                               \
    return launch_volume<T, N1, false, true>(q, geo, cvol, cface, iw, iwf,  \
                                             ef, lift, out, traces, K,      \
                                             gamma, stream);                \
  return launch_volume<T, N1, false, false>(q, geo, cvol, cface, iw, iwf,   \
                                            ef, lift, out, traces, K,       \
                                            gamma, stream);
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
      long long, double, cudaStream_t

}  // namespace esdg
