// The entropy projection of collocated hex elements: its pointwise steps
// are shared by K1 (hex_volume.cuh, on K1's own tile) and the split path's
// projection kernel (hex_split.cu, entropy_project below), so the two
// cannot drift.  It replaces
// esdg_cns_tpu/ops/pallas_volume.py::_entropy_project_hex, the projection
// both TPU kernels (_volume_kernel, _proj_kernel) run:
//   1. entropy variables v(U) at the Nq collocated volume nodes;
//   2. the face extrapolation Ef v ([Nfq x Nq] per field), over the N+1
//      volume nodes of each face point's line (common.cuh's ef_line: the
//      rest of the row is zero up to roundoff);
//   3. U(v_f) at the Nfq face points (pow/exp of the inverse map);
//   4. flux variables (rho, u, beta) and (log rho, log beta) at all
//      Nh = Nq + Nfq points, handed to the caller.
// entropy_project (below) runs the four steps on a tile of elements with
// K1's thread mapping, for the split path's projection kernel.
#pragma once

#include "common.cuh"

namespace esdg {

// The pointwise steps, shared by this projection and K1's
// (hex_volume.cuh).  Volume node: u = (rho, m1, m2, m3, E) -> the entropy
// variables v[5] and the flux variables vals[7].
template <typename T>
__device__ __forceinline__ void project_volume_point(const T u[5],
                                                     const Consts<T>& c,
                                                     T v[5], T vals[7]) {
  const T rho = u[0], E = u[4];
  const T rhou2 = u[1] * u[1] + u[2] * u[2] + u[3] * u[3];
  const T p = c.gm1 * (E - (T(0.5) * rhou2) / rho);
  const T s = log(p) - c.gamma * log(rho);
  v[0] = (c.gamma_p1 - s) - (c.gm1 * E) / p;
#pragma unroll
  for (int j = 1; j < 4; ++j) v[j] = (c.gm1 * u[j]) / p;
  v[4] = (-c.gm1 * rho) / p;
  const T beta = rho / (T(2) * p);
  vals[0] = rho;
#pragma unroll
  for (int j = 1; j < 4; ++j) vals[j] = u[j] / rho;
  vals[4] = beta;
  vals[5] = log(rho);
  vals[6] = log(beta);
}

// Face point: v_f = (Ef v)[5] -> U(v_f) -> the flux variables vals[7].
template <typename T>
__device__ __forceinline__ void project_face_point(const T fv[5],
                                                   const Consts<T>& c,
                                                   T vals[7]) {
  const T vnorm = fv[1] * fv[1] + fv[2] * fv[2] + fv[3] * fv[3];
  const T sf = (c.gamma - fv[0]) + vnorm / (T(2) * fv[4]);
  const T rhoe =
      pow(c.gm1 / pow(-fv[4], c.gamma), c.inv_gm1) * exp(-sf / c.gm1);
  const T frho = rhoe * (-fv[4]);
  const T fm1 = rhoe * fv[1], fm2 = rhoe * fv[2], fm3 = rhoe * fv[3];
  const T fe = rhoe * (T(1) - vnorm / (T(2) * fv[4]));
  const T fpress =
      c.gm1 * (fe - (T(0.5) * (fm1 * fm1 + fm2 * fm2 + fm3 * fm3)) / frho);
  const T fbeta = frho / (T(2) * fpress);
  vals[0] = frho;
  vals[1] = fm1 / frho;
  vals[2] = fm2 / frho;
  vals[3] = fm3 / frho;
  vals[4] = fbeta;
  vals[5] = log(frho);
  vals[6] = log(fbeta);
}

// put(r, node, value) receives row r (0..6) of the flux variables at
// hybridized point node (volume nodes first, then face point fp at
// NQ + fp) of the thread's element; traces [7, NFQ, K] receives the face
// points' rows.  A block of THREADS threads owns TE elements from k0 and
// maps t -> (element t % TE, point t / TE), so a thread keeps one element
// (THREADS is a multiple of TE) and a warp's K-last loads and stores cover
// TE consecutive elements.  vbuf [5][NQ][TE] holds v(U) at the volume
// nodes (a face point reads its line's nodes, which other threads wrote).
// Every thread of the block calls it; lanes past K compute on the
// quiescent state (rho=1, m=0, E=1) and store nothing.
template <typename T, int N1, int TE, int THREADS, typename Put>
__device__ __forceinline__ void entropy_project(const T* __restrict__ q,
                                                const T* __restrict__ ef,
                                                T* vbuf, T* __restrict__ traces,
                                                long long K, long long k0,
                                                const Consts<T>& c, Put put) {
  static_assert(THREADS % TE == 0, "a thread keeps one element");
  constexpr int NQ = N1 * N1 * N1, NFQ = 6 * N1 * N1;
  const int e = threadIdx.x % TE;
  const long long k = k0 + e;
  const bool live = k < K;
  auto V = [&](int f, int node) -> T& { return vbuf[(f * NQ + node) * TE + e]; };

  // ---- 1. v(U) at the volume nodes + volume flux variables ----
  for (int i = threadIdx.x / TE; i < NQ; i += THREADS / TE) {
    T u[5] = {T(1), T(0), T(0), T(0), T(1)};  // quiescent past K
    if (live) {
#pragma unroll
      for (int f = 0; f < 5; ++f)
        u[f] = __ldg(q + (long long)(f * NQ + i) * K + k);
    }
    T v[5], vals[7];
    project_volume_point(u, c, v, vals);
#pragma unroll
    for (int f = 0; f < 5; ++f) V(f, i) = v[f];
    if (live) {
#pragma unroll
      for (int r = 0; r < 7; ++r) put(r, i, k, vals[r]);
    }
  }
  __syncthreads();

  // ---- 2.-4. v_f = Ef v, U(v_f), face flux variables and traces ----
  if (!live) return;  // no barrier below
  for (int fp = threadIdx.x / TE; fp < NFQ; fp += THREADS / TE) {
    T fv[5] = {T(0), T(0), T(0), T(0), T(0)};
    ef_line<T, N1>(ef, fp, V, fv);
    T vals[7];
    project_face_point(fv, c, vals);
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      put(r, NQ + fp, k, vals[r]);
      traces[(long long)(r * NFQ + fp) * K + k] = vals[r];
    }
  }
}

// The split path's projection kernel (row 3; entry in hex_split.cu): the
// flux variables at all Nh points into qh [5, Nh, K] and qlog [2, Nh, K],
// and the traces.
template <typename T, int N1, int TE, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    hex_project_kernel(const T* __restrict__ q, const T* __restrict__ ef,
                       T* __restrict__ qh, T* __restrict__ qlog,
                       T* __restrict__ traces, long long K, double gamma) {
  constexpr int NH = N1 * N1 * N1 + 6 * N1 * N1;
  const Consts<T> c(gamma);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vbuf = reinterpret_cast<T*>(smem_raw);  // [5][NQ][TE]
  entropy_project<T, N1, TE, THREADS>(
      q, ef, vbuf, traces, K, (long long)blockIdx.x * TE, c,
      [&](int r, int node, long long k, T v) {
        if (r < 5)
          qh[((long long)r * NH + node) * K + k] = v;
        else
          qlog[((long long)(r - 5) * NH + node) * K + k] = v;
      });
}

// One line length at one tile: launches, or with occ fills its launch
// shape (common.cuh's launch_shape; occ[6] = MIN_BLOCKS).  Returns a CUDA
// error code.
template <typename T, int N1, int TE, int THREADS, int MIN_BLOCKS>
int launch_project_tile(const void* q, const void* ef, void* qh, void* qlog,
                        void* traces, long long K, double gamma,
                        cudaStream_t stream, int* occ) {
  constexpr size_t SMEM = size_t(5) * N1 * N1 * N1 * TE * sizeof(T);
  static_assert(SMEM <= kMaxSmem, "projection tile exceeds shared memory");
  auto kern = hex_project_kernel<T, N1, TE, THREADS, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  if (occ != nullptr) {
    const int rc = launch_shape(kern, THREADS, SMEM, TE, occ);
    occ[6] = MIN_BLOCKS;
    return rc;
  }
  const dim3 grid(unsigned((K + TE - 1) / TE));
  kern<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ef),
      static_cast<T*>(qh), static_cast<T*>(qlog), static_cast<T*>(traces), K,
      gamma);
  return int(cudaGetLastError());
}

}  // namespace esdg
