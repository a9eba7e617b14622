// K3: fused modal volume stage of the 2D tri CNS / Euler RHS.
//
// Replaces the TPU kernel
// esdg_cns_tpu/ops/pallas_modal_volume.py::_modal_volume_kernel (wrapper
// euler_modal_volume_pallas; flux-differencing body
// esdg_cns_tpu/ops/pallas_fd.py::triangular_fd through fd_body).  Per
// element it computes:
//   1. Uq = Vq U at the Nq quadrature points and v(Uq), written out as
//      vu_q [4, Nq, K] (the viscous front end reads it);
//   2. the hybridized projection Vh Pq v and U(v_h) at the Nh = Nq + Nfq
//      points, then the flux variables (rho, u1, u2, beta) and their logs,
//      staged in shared memory; the face rows are written out as
//      traces [6, Nfq, K] = (rho, u1, u2, beta, log rho, log beta);
//   3. the dense skew EC flux differencing (dense_fd.cuh, the body K5
//      shares)
//      acc_i = sum_j sum_x (sum_r Q_r[i,j] g_rx) F_x(q_i, q_j),
//      skipping the zero face-face block and the zero diagonal, g the
//      element's affine metric (geo [4, 1, K]) or, on curved meshes
//      (CURVED, geo [4, Nh, K]), the pairwise average 0.5 (g_i + g_j);
//   4. ph_qf = 2 Ph acc  [4, Np, K].
// The operators Vq, VhP, Ph and Q_r live in shared memory with the
// tile's per-element arrays (and, when curved, the element's [4, Nh]
// metric).
//
// What bounds it on this card: at N=3 (Np=10, Nq=12, Nh=24) each element
// evaluates 420 two-point fluxes here (every ordered vol-vol pair and
// both orders of the vol-face pairs), each with three divisions and two
// logarithmic means, plus 24 pow/exp inverse maps and the three small
// dense products (about 3.3k multiply-adds).  It reads 44 and writes
// 160 values per element (0.8 KB in f32, about 27 MB per RHS at
// K=32768), so HBM is far from the limit: the kernel is bound by the
// division and transcendental throughput of the pair loop.
//
// Simple design: a block owns TE elements (threadIdx.x, so the K-last
// loads and stores coalesce) and 256/TE workers (threadIdx.y).  In the
// flux differencing one thread owns one (element, row i) and sums its
// whole row over the partners j.  That evaluates each pair twice, once
// from each side, but needs no cross-thread reduction and no atomics,
// so the result is deterministic.  Halving the pair work (the TPU's
// triangular form: row j takes the negated column sum) is later work.
// Lanes past K compute on a quiescent state (rho=1, m=0, E=1) with the
// identity metric and store nothing.  Sizes (Np, Nq, Nh) are runtime
// values, so every N whose tile fits in shared memory runs.
#include "dense_fd.cuh"

namespace esdg {

constexpr int kModalThreads = 256;

template <typename T>
struct ModalSmem {
  // operators: vq [Nq][Np], vhp [Nh][Nq], ph [Np][Nh], qs [2][Nh][Nh];
  // per element: q [4][Np], v [4][Nq], h [6][Nh], acc [4][Nh] and,
  // curved, g [4][Nh]
  static size_t fixed(int np, int nq, int nh) {
    return size_t(nq) * np + size_t(nh) * nq + size_t(np) * nh +
           size_t(2) * nh * nh;
  }
  static size_t per_elem(int np, int nq, int nh, bool curved) {
    return size_t(4) * np + size_t(4) * nq + size_t(6) * nh +
           size_t(curved ? 8 : 4) * nh;
  }
};

template <typename T, bool CURVED>
__global__ void __launch_bounds__(kModalThreads)
    tri_modal_volume_kernel(const T* __restrict__ q, const T* __restrict__ geo,
                            const T* __restrict__ qs,
                            const T* __restrict__ vq,
                            const T* __restrict__ vhp,
                            const T* __restrict__ ph, T* __restrict__ out,
                            T* __restrict__ traces, T* __restrict__ vuq,
                            long long K, int np, int nq, int nh,
                            double gamma) {
  const Consts<T> c(gamma);
  const int nfq = nh - nq;
  const int TE = blockDim.x, NW = blockDim.y;
  const int e = threadIdx.x, w = threadIdx.y;
  const int tid = w * TE + e, nthreads = TE * NW;
  const long long k = (long long)blockIdx.x * TE + e;
  const bool live = k < K;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_vq = reinterpret_cast<T*>(smem_raw);
  T* s_vhp = s_vq + nq * np;
  T* s_ph = s_vhp + nh * nq;
  T* s_qs = s_ph + np * nh;
  T* s_q = s_qs + 2 * nh * nh;   // [4 Np][TE]
  T* s_v = s_q + 4 * np * TE;    // [4 Nq][TE]
  T* s_h = s_v + 4 * nq * TE;    // [6 Nh][TE]
  T* s_acc = s_h + 6 * nh * TE;  // [4 Nh][TE]
  T* s_g = s_acc + 4 * nh * TE;  // [4 Nh][TE], curved only

  for (int i = tid; i < nq * np; i += nthreads) s_vq[i] = vq[i];
  for (int i = tid; i < nh * nq; i += nthreads) s_vhp[i] = vhp[i];
  for (int i = tid; i < np * nh; i += nthreads) s_ph[i] = ph[i];
  for (int i = tid; i < 2 * nh * nh; i += nthreads) s_qs[i] = qs[i];
  for (int row = w; row < 4 * np; row += NW) {
    const int f = row / np;
    const T quiescent = (f == 0 || f == 3) ? T(1) : T(0);
    s_q[row * TE + e] = live ? q[(long long)row * K + k] : quiescent;
  }
  if (CURVED) {
    for (int row = w; row < 4 * nh; row += NW) {
      const int rx = row / nh;
      const T ident = (rx == 0 || rx == 3) ? T(1) : T(0);
      s_g[row * TE + e] = live ? geo[(long long)row * K + k] : ident;
    }
  }
  __syncthreads();

  // ---- 1. Uq = Vq U and v(Uq) ----
  for (int i = w; i < nq; i += NW) {
    T u[4] = {T(0), T(0), T(0), T(0)};
    for (int j = 0; j < np; ++j) {
      const T a = s_vq[i * np + j];
#pragma unroll
      for (int f = 0; f < 4; ++f) u[f] += a * s_q[(f * np + j) * TE + e];
    }
    const T rho = u[0], E = u[3];
    const T p = c.gm1 * (E - (T(0.5) * (u[1] * u[1] + u[2] * u[2])) / rho);
    const T s = log(p) - c.gamma * log(rho);
    T v[4];
    v[0] = (c.gamma_p1 - s) - (c.gm1 * E) / p;
    v[1] = (c.gm1 * u[1]) / p;
    v[2] = (c.gm1 * u[2]) / p;
    v[3] = (-c.gm1 * rho) / p;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      s_v[(f * nq + i) * TE + e] = v[f];
      if (live) vuq[(long long)(f * nq + i) * K + k] = v[f];
    }
  }
  __syncthreads();

  // ---- 2. v_h = VhP v, U(v_h), flux variables + logs at Nh points ----
  for (int i = w; i < nh; i += NW) {
    T hv[4] = {T(0), T(0), T(0), T(0)};
    for (int j = 0; j < nq; ++j) {
      const T a = s_vhp[i * nq + j];
#pragma unroll
      for (int f = 0; f < 4; ++f) hv[f] += a * s_v[(f * nq + j) * TE + e];
    }
    const T vnorm = hv[1] * hv[1] + hv[2] * hv[2];
    const T sf = (c.gamma - hv[0]) + vnorm / (T(2) * hv[3]);
    const T rhoe =
        pow(c.gm1 / pow(-hv[3], c.gamma), c.inv_gm1) * exp(-sf / c.gm1);
    const T hrho = rhoe * (-hv[3]);
    const T he = rhoe * (T(1) - vnorm / (T(2) * hv[3]));
    const T hu1 = hv[1] / (-hv[3]), hu2 = hv[2] / (-hv[3]);
    const T hp = c.gm1 * (he - (T(0.5) * hrho) * (hu1 * hu1 + hu2 * hu2));
    const T hbeta = hrho / (T(2) * hp);
    const T vals[6] = {hrho, hu1, hu2, hbeta, log(hrho), log(hbeta)};
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      s_h[(r * nh + i) * TE + e] = vals[r];
      if (live && i >= nq)
        traces[(long long)(r * nfq + i - nq) * K + k] = vals[r];
    }
  }
  __syncthreads();

  // ---- 3. dense skew EC flux differencing, one row per thread ----
  T ga[4] = {T(1), T(0), T(0), T(1)};  // geo[r*2 + x], affine
  if (!CURVED && live) {
#pragma unroll
    for (int r = 0; r < 4; ++r) ga[r] = geo[(long long)r * K + k];
  }
  for (int i = w; i < nh; i += NW) {
    T acc[4];
    dense_fd_row<T, 2, CURVED, false>(i, s_h + e, s_g + e, ga, s_qs, nq, nh,
                                      TE, c, acc);
#pragma unroll
    for (int f = 0; f < 4; ++f) s_acc[(f * nh + i) * TE + e] = acc[f];
  }
  __syncthreads();

  // ---- 4. ph_qf = 2 Ph acc ----
  if (!live) return;  // no barrier below
  for (int n = w; n < np; n += NW) {
    T o[4] = {T(0), T(0), T(0), T(0)};
    for (int i = 0; i < nh; ++i) {
      const T a = s_ph[n * nh + i];
#pragma unroll
      for (int f = 0; f < 4; ++f) o[f] += a * s_acc[(f * nh + i) * TE + e];
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      out[(long long)(f * np + n) * K + k] = T(2) * o[f];
  }
}

template <typename T, bool CURVED>
int launch_modal_volume(const void* q, const void* geo, const void* qs,
                        const void* vq, const void* vhp, const void* ph,
                        void* out, void* traces, void* vuq, long long K,
                        int np, int nq, int nh, double gamma,
                        cudaStream_t stream) {
  const size_t fixed = ModalSmem<T>::fixed(np, nq, nh);
  const size_t per = ModalSmem<T>::per_elem(np, nq, nh, CURVED);
  const int te = tile_elements<T>(fixed, per);
  if (te == 0) return -1;
  const size_t smem = (fixed + per * te) * sizeof(T);
  auto kern = tri_modal_volume_kernel<T, CURVED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 block(te, kModalThreads / te);
  const dim3 grid(unsigned((K + te - 1) / te));
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(geo),
      static_cast<const T*>(qs), static_cast<const T*>(vq),
      static_cast<const T*>(vhp), static_cast<const T*>(ph),
      static_cast<T*>(out), static_cast<T*>(traces), static_cast<T*>(vuq), K,
      np, nq, nh, gamma);
  return int(cudaGetLastError());
}

template <typename T>
int launch_modal_form(int curved, const void* q, const void* geo,
                      const void* qs, const void* vq, const void* vhp,
                      const void* ph, void* out, void* traces, void* vuq,
                      long long K, int np, int nq, int nh, double gamma,
                      cudaStream_t stream) {
  return curved ? launch_modal_volume<T, true>(q, geo, qs, vq, vhp, ph, out,
                                               traces, vuq, K, np, nq, nh,
                                               gamma, stream)
                : launch_modal_volume<T, false>(q, geo, qs, vq, vhp, ph, out,
                                                traces, vuq, K, np, nq, nh,
                                                gamma, stream);
}

}  // namespace esdg

// dtype: 0 = float32, 1 = float64.  q [4, np, K], geo [4, 1, K] or
// (curved = 1) [4, nh, K], qs [2, nh, nh], vq [nq, np], vhp [nh, nq],
// ph [np, nh]; out [4, np, K], traces [6, nh - nq, K], vuq [4, nq, K].
// Returns cudaGetLastError() after the launch, -1 when the tile does not
// fit in shared memory, -2 for an unknown dtype.
extern "C" int esdg_tri_modal_volume(int dtype, int curved, const void* q,
                                     const void* geo, const void* qs,
                                     const void* vq, const void* vhp,
                                     const void* ph, void* out, void* traces,
                                     void* vuq, long long K, int np, int nq,
                                     int nh, double gamma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return esdg::launch_modal_form<float>(curved, q, geo, qs, vq, vhp, ph,
                                          out, traces, vuq, K, np, nq, nh,
                                          gamma, st);
  if (dtype == 1)
    return esdg::launch_modal_form<double>(curved, q, geo, qs, vq, vhp, ph,
                                           out, traces, vuq, K, np, nq, nh,
                                           gamma, st);
  return -2;
}
